#!/usr/bin/env python3
"""The FFTree's layers built on the device (fftree/device_build.py, K8)
against the host isogeny chain, on one GPU.

    python3 scripts/tree_build.py [--device cuda|cpu] [--sizes LO HI]
                                  [--profile K ...] [--chunks K LOG_W ...]

--sizes LO HI: for each 2^k leaves, LO <= k <= HI, both builds (median
  of REPS each, fenced), every layer held bit for bit; prints the
  smallest 2^k from which the device build is faster at every measured
  size ("crossover": the default of DVPARI_DEVICE_TREE_MIN).
--profile K: after a warm-up build, one device build of 2^K leaves
  under torch.profiler: CUDA kernels and copies launched, device busy
  seconds (their summed durations) against an unprofiled build's wall
  time.
--chunks K LOG_W: a 2^K-leaf device build in layer-0 chunks of 2^LOG_W
  lanes: wall time and peak device memory (several pairs in turn).

Ends with one JSON line of all results.  chip_smoke.py imports
`host_vs_device` and `spot_check` for its tree phase.
"""

import json
import os
import random
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

REPS = 3
SEED = 7


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t


def host_vs_device(log_n: int, device, reps: int = REPS) -> dict:
    """Both builds of a 2^log_n-leaf tree (shift_by_one False, base
    log_n), median seconds of `reps` each in turns; raises unless every
    layer is equal bit for bit."""
    import numpy as np

    from dvpari_tpu_torch.fftree.tree import FFTree

    n = 1 << log_n
    times = {"host": [], "device": []}
    for _ in range(reps):
        for path in ("host", "device"):
            tree, t = _timed(lambda: FFTree.build(n, False, log_n, device, path == "device"), device)
            times[path].append(t)
            if path == "host":
                want = tree
            elif not (tree.x0s == want.x0s and len(tree.layers) == len(want.layers)
                      and all(np.array_equal(a, b) for a, b in zip(tree.layers, want.layers))):
                raise AssertionError(f"device build of 2^{log_n} leaves != host chain")
    return {"log_n": log_n, "host_s": statistics.median(times["host"]),
            "device_s": statistics.median(times["device"]),
            "host_runs_s": times["host"], "device_runs_s": times["device"]}


def spot_check(tree, shift_by_one: bool, base_log_n: int, lanes: int = 64, seed: int = SEED) -> int:
    """`lanes` seeded lanes of layer 0 held to x(C + [i] G) in python
    ints, and as many of every higher layer to the isogeny x-map of the
    layer below; returns the number of values checked."""
    from dvpari_tpu_torch.fftree import aux_curve as ac
    from dvpari_tpu_torch.ops import fr

    meta = ac.build_chain_meta(tree.n, shift_by_one, base_log_n)
    curve = meta.layers[0][0]
    gen = meta.gen_doubles[0] if meta.gen_doubles else None
    rng = random.Random(seed)

    def pick(n):
        return sorted(set(rng.sample(range(n), min(lanes, n)) + [0, n - 1]))

    idx = pick(tree.n)
    got = fr.to_int(tree.layers[0][:, idx])
    for i, x in zip(idx, got):
        if x != ac.add(curve, meta.coset, ac.smul(curve, i, gen))[0]:
            raise AssertionError(f"layer 0 lane {i} != x(C + [{i}] G)")
    checked = len(idx)
    for l in range(1, len(tree.layers)):
        iso = meta.layers[l - 1][1]
        n = tree.layers[l].shape[-1]
        idx = pick(n)
        below = fr.to_int(tree.layers[l - 1][:, idx])
        for i, x, b in zip(idx, fr.to_int(tree.layers[l][:, idx]), below):
            if x != iso.map_x(b):
                raise AssertionError(f"layer {l} lane {i} != the isogeny x-map of layer {l - 1}")
        checked += len(idx)
    return checked


def profile_build(log_n: int, device) -> dict:
    """After a warm-up build, one unprofiled and one profiled device
    build of 2^log_n leaves: wall seconds, and the device's kernels and
    copies in the profiled one (count, summed duration)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvpari_tpu_torch.fftree.tree import FFTree

    n = 1 << log_n
    FFTree.build(n, False, log_n, device, True)
    _, wall = _timed(lambda: FFTree.build(n, False, log_n, device, True), device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        FFTree.build(n, False, log_n, device, True)
        _sync(device)
    # FFTree.build's phase range (utils/timing.py) shows on the device
    # timeline too; it is not work
    work = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("tree.")]
    busy = sum(e.time_range.end - e.time_range.start for e in work) / 1e6
    return {"log_n": log_n, "wall_s": wall, "device_ops": len(work), "device_busy_s": busy,
            "busy_share": busy / wall}


def chunked_build(log_n: int, log_w: int, device) -> dict:
    """A 2^log_n-leaf device build in layer-0 chunks of 2^log_w lanes:
    wall seconds and peak device memory."""
    import torch

    from dvpari_tpu_torch.fftree.tree import FFTree

    was = os.environ.get("DVPARI_LAYER0_CHUNK")
    os.environ["DVPARI_LAYER0_CHUNK"] = str(1 << log_w)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, t = _timed(lambda: FFTree.build(1 << log_n, False, log_n, device, True), device)
    finally:
        if was is None:
            del os.environ["DVPARI_LAYER0_CHUNK"]
        else:
            os.environ["DVPARI_LAYER0_CHUNK"] = was
    return {"log_n": log_n, "log_chunk": log_w, "wall_s": t,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def crossover(rows) -> "int | None":
    """Smallest 2^k from which the device build was faster at every
    measured size above it, or None."""
    best = None
    for r in sorted(rows, key=lambda r: -r["log_n"]):
        if r["device_s"] >= r["host_s"]:
            break
        best = 1 << r["log_n"]
    return best


def main(argv) -> int:
    import subprocess

    import torch

    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    tag = ""
    if device == "cuda":
        if not torch.cuda.is_available():
            print("tree_build: torch.cuda.is_available() is false", file=sys.stderr)
            return 1
        tag = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(tag, flush=True)
    out = {"card": tag}
    if "--sizes" in argv:
        i = argv.index("--sizes")
        lo, hi = int(argv[i + 1]), int(argv[i + 2])
        host_vs_device(lo, device, reps=1)  # warm-up: CUDA context, constant tables
        rows = []
        for k in range(lo, hi + 1):
            r = host_vs_device(k, device)
            rows.append(r)
            print(f"2^{k} leaves: host chain {r['host_s']:.4f} s, device build {r['device_s']:.4f} s "
                  f"(medians of {REPS}; layers equal) [{tag}]", flush=True)
        out["sizes"] = rows
        out["crossover"] = crossover(rows)
        print(f"device build faster from {out['crossover']} leaves on", flush=True)
    for i, a in enumerate(argv):
        if a == "--profile":
            r = profile_build(int(argv[i + 1]), device)
            out.setdefault("profile", []).append(r)
            print(f"2^{r['log_n']} device build: {r['wall_s']:.4f} s, {r['device_ops']} kernels and "
                  f"copies, device busy {r['device_busy_s']:.4f} s ({100 * r['busy_share']:.1f} %) "
                  f"[{tag}]", flush=True)
        if a == "--chunks":
            r = chunked_build(int(argv[i + 1]), int(argv[i + 2]), device)
            out.setdefault("chunks", []).append(r)
            print(f"2^{r['log_n']} device build in chunks of 2^{r['log_chunk']}: {r['wall_s']:.4f} s, "
                  f"peak {r['peak_gib']:.2f} GiB [{tag}]", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
