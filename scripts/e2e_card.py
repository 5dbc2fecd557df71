#!/usr/bin/env python3
"""The port's end-to-end path -- setup -> precompute -> prove -> verify --
on one GPU, timed by phase.

    python3 scripts/e2e_card.py [LOG_M] [--device cuda|cpu] [--ranks R ...]

toy(): the 5-constraint toy circuit with trapdoor seed b"dvpari-toy-43";
its proof must equal TOY_PROOF_HEX (read from tests/golden_n16.py),
verify must accept it and reject it with one bit of a0 flipped.

rung(): synth_multiterm(2^LOG_M - 2) -- 4 terms a row, a 512-entry
coefficient table, seed 7; with its two public-output rows m = 2^LOG_M
constraints -- in a fresh temporary cache: setup, precompute, a cold
prove and a warm prove of a second witness (chain start 5 in place of
3), each proof verified, a tampered one rejected.  It records
which path built the two trees of 2m leaves (the device build or the
host chain, fftree/tree.py:FFTree.build).  Setup and these two
proves run with their phases fenced by torch.cuda.synchronize()
(utils/timing.py's SYNC_PHASES), for the per-phase split; the warm
prove then runs FENCE_REPS times each without and with the fences,
alternating, for the end-to-end time and the fences' cost.  The ladder
and point-add launches are counted per setup and per prove.  Given a
list, rung() also keeps the operands of every fan-out and MSM that
setup and the cold prove call, for a caller to replay the kernels on;
given another (record_warm), those of the warm prove's MSMs, which the
group proves below split between their ranks.

With ranks (--ranks R), rung() then proves the second witness over a
process group of R ranks (protocol/prover.py:prove(group=)) in the same
cache, with no second setup: R = 1 is a world of one in this process
(NCCL on a card, gloo on the CPU), timed in turns against the plain
warm prove; R > 1 spawns R ranks that share the rung's device through
gloo, each proving twice (cold, then warm).  Every rank's proof must
equal the warm proof byte for byte and verify, and on a card each
rank's ladder and point-add launches must be what its column runs give
(group_launches).

chip_smoke.py runs both; run alone, the script also proves the second
witness once more under torch.profiler (on CUDA) for the device's busy
time per phase and the kernels that took the most device time, prints
them and ends with one JSON line of the numbers (default LOG_M 16,
device cuda).
"""

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOY_SEED = b"dvpari-toy-43"
RUNG_SEED = b"dvpari-e2e-rung"
FENCE_REPS = 5
GROUP_REPS = 3  # turns of plain and one-rank group proves


def _golden_toy_hex() -> str:
    """TOY_PROOF_HEX from tests/golden_n16.py (read, not copied)."""
    ns: dict = {}
    with open(os.path.join(ROOT, "tests", "golden_n16.py")) as f:
        exec(compile(f.read(), "golden_n16.py", "exec"), ns)
    return ns["TOY_PROOF_HEX"]


def flip_a0(proof):
    """The proof with bit 0 of a0 (bit 480 of the 944) flipped."""
    from dvpari_tpu_torch.protocol.proof import Proof

    bits = proof.to_bits()
    return Proof.from_bits([not b if i == 480 else b for i, b in enumerate(bits)])


def _launches() -> dict:
    from dvpari_tpu_torch.ops import msm_kernel

    return {"ladder": msm_kernel.ladder.launches, "point_add": msm_kernel.point_add.launches}


def _reset() -> None:
    from dvpari_tpu_torch.ops import msm_kernel
    from dvpari_tpu_torch.utils import timing

    msm_kernel.reset_counts()
    timing.reset()


def toy(device, log=print) -> dict:
    from dvpari_tpu_torch.__main__ import toy_e2e
    from dvpari_tpu_torch.protocol import srs
    from dvpari_tpu_torch.protocol.proof import _bits_to_bytes_le

    with tempfile.TemporaryDirectory() as cache:
        _reset()
        td, pub, proof, ok = toy_e2e(cache, TOY_SEED, device, log=lambda _: None)
        launches = _launches()
    got = _bits_to_bytes_le(proof.to_bits()).hex()
    if got != _golden_toy_hex():
        raise AssertionError(f"toy proof {got} != TOY_PROOF_HEX")
    if not ok:
        raise AssertionError("verify rejected the toy proof")
    if srs.verify(td, pub, flip_a0(proof)):
        raise AssertionError("verify accepted the toy proof with a0's bit 0 flipped")
    log(f"toy e2e on {device}: proof equals TOY_PROOF_HEX, verify accepts it and rejects "
        f"a0 with one bit flipped; launches {json.dumps(launches)}")
    return {"launches": launches}


@contextlib.contextmanager
def _recording(ops):
    """While open, append ("fan-out", scalars, None) or ("msm", scalars,
    planes) for every xsk233.mulgen_limbs / msm_limbs call to `ops` (a
    list; None records nothing).  The calls run unchanged."""
    from dvpari_tpu_torch.ops import xsk233

    if ops is None:
        yield
        return
    msm, mulgen = xsk233.msm_limbs, xsk233.mulgen_limbs

    def msm_rec(scalars, planes, device="cuda"):
        ops.append(("msm", scalars, planes))
        return msm(scalars, planes, device)

    def mulgen_rec(scalars, device="cuda"):
        ops.append(("fan-out", scalars, None))
        return mulgen(scalars, device)

    xsk233.msm_limbs, xsk233.mulgen_limbs = msm_rec, mulgen_rec
    try:
        yield
    finally:
        xsk233.msm_limbs, xsk233.mulgen_limbs = msm, mulgen


def group_launches(ns, R: int, r: int) -> dict:
    """Rank r's kernel launches in one prove over R ranks, whose MSMs
    cover ns points (parallel/sharded.py:msm_limbs_sharded): per MSM with
    a non-empty column run of C columns one ladder and 1 + ceil(log2 C)
    + 5 point adds (table, column folds, in-word folds), and for every
    MSM ceil(log2 R) point adds folding the ranks' partials."""
    from dvpari_tpu_torch.parallel import mesh

    out = {"ladder": 0, "point_add": 0}
    for n in ns:
        c0, c1 = mesh.col_run(-(-n // 32), R, r)
        if c1 > c0:
            out["ladder"] += 1
            out["point_add"] += 1 + (c1 - c0 - 1).bit_length() + 5
        out["point_add"] += (R - 1).bit_length()
    return out


def group_proves(cache, pub, priv, want_proof, td, device, ranks, ns, log=print) -> dict:
    """The prove of (pub, priv) over process groups of each size in
    `ranks` (see the module's docstring); want_proof is the plain
    prove's proof of the same witness, ns the MSMs' point counts."""
    import torch

    from dvpari_tpu_torch.parallel import dryrun, multihost
    from dvpari_tpu_torch.protocol import prover, srs
    from dvpari_tpu_torch.protocol.proof import Proof, _bytes_to_bits_le
    from dvpari_tpu_torch.utils import timing

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    want = dryrun.proof_hex(want_proof)
    out = {}
    for R in ranks:
        if R == 1:
            g = multihost.initialize(0, 1, "127.0.0.1", multihost.free_port(), dev)
            try:
                res = [dryrun.rank_prove(g, cache, pub, priv)]
                sync_was, timing.SYNC_PHASES = timing.SYNC_PHASES, False
                turns = {"plain": [], "group": []}
                try:
                    for _ in range(GROUP_REPS):
                        for kind in ("plain", "group"):
                            if cuda:
                                torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            prover.prove(cache, pub, priv, device=g.device,
                                         group=g if kind == "group" else None)
                            if cuda:
                                torch.cuda.synchronize()
                            turns[kind].append(time.perf_counter() - t0)
                finally:
                    timing.SYNC_PHASES = sync_was
            finally:
                multihost.shutdown()
            rec = {"backend": g.backend, "plain_prove_runs_s": turns["plain"],
                   "group_prove_runs_s": turns["group"]}
        else:
            res = multihost.run_ranks(R, dryrun.rank_prove, (cache, pub, priv, 2), str(dev))
            rec = {"backend": res[0]["backend"], "warm_prove_s": [r["prove_s"][-1] for r in res],
                   "cold_prove_s": [r["prove_s"][0] for r in res]}
        bad = [r["rank"] for r in res if r["proof"] != want]
        if bad:
            raise AssertionError(f"ranks {bad} of {R}: proof != the plain warm proof")
        proof = Proof.from_bits(_bytes_to_bits_le(bytes.fromhex(res[0]["proof"]))[:944])
        if not srs.verify(td, pub, proof):
            raise AssertionError(f"verify rejected the proof over {R} ranks")
        rec["launches"] = [r["launches"] for r in res]
        if cuda:
            for r in res:
                exp = group_launches(ns, R, r["rank"])
                if r["launches"] != exp:
                    raise AssertionError(f"rank {r['rank']} of {R} launched {r['launches']}, its "
                                         f"column runs give {exp}")
        out[R] = rec
        log(f"group prove over {R} rank(s) ({rec['backend']}, {dev}): every rank's proof equals "
            f"the plain warm proof and verifies; launches per rank {json.dumps(rec['launches'])}")
    return out


def rung(log_m: int, device, log=print, profile: bool = False, record=None, ranks=(),
         record_warm=None) -> dict:
    import torch

    from dvpari_tpu_torch.protocol import prover, srs
    from dvpari_tpu_torch.r1cs.toy import synth_multiterm
    from dvpari_tpu_torch.storage import artifacts as art
    from dvpari_tpu_torch.utils import timing

    cuda = torch.device(device).type == "cuda"
    m = 1 << log_m
    t0 = time.perf_counter()
    dump, pub, priv = synth_multiterm(m - 2)
    dump2, pub2, priv2 = synth_multiterm(m - 2, x=5)
    if dump2 != dump or pub2 == pub:
        raise AssertionError("second witness must keep the circuit and change the outputs")
    out = {"m": m, "n_wires": 1 + len(pub) + len(priv), "circuit_s": time.perf_counter() - t0}
    td = srs.Trapdoor.from_seed(RUNG_SEED)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        return r, time.perf_counter() - t

    sync_was = timing.SYNC_PHASES
    timing.SYNC_PHASES = True
    try:
        with tempfile.TemporaryDirectory() as cache:
            with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
                f.write(dump)
            _reset()
            with _recording(record):
                _, out["setup_s"] = timed(
                    lambda: srs.verifier_runs_setup(td, cache, 2, True, True, device=device))
            out["setup_phases"] = timing.summary()
            out["setup_launches"] = _launches()
            built = [e for e in timing.EVENTS if e["phase"] in ("tree.device_build", "tree.host_build")]
            paths = {e["phase"].split(".")[1].split("_")[0] for e in built}
            if len(built) != 2 or len(paths) != 1:
                raise AssertionError(f"setup built {len(built)} trees on paths {paths}, expected two on one")
            out["tree_path"] = paths.pop()
            _reset()
            _, out["precompute_s"] = timed(
                lambda: prover.prover_prepares_precomputes(cache, True, device=device))
            proofs = []
            for name, p, w in (("cold", pub, priv), ("warm", pub2, priv2)):
                _reset()
                with _recording(record if name == "cold" else record_warm):
                    proof, out[f"{name}_prove_s"] = timed(
                        lambda: prover.prove(cache, p, w, device=device))
                out[f"{name}_prove_phases"] = timing.summary()
                out[f"{name}_prove_launches"] = _launches()
                proofs.append((p, proof))
            if cuda:
                runs = {False: [], True: []}
                for _ in range(FENCE_REPS):
                    for fenced in (False, True):
                        timing.SYNC_PHASES = fenced
                        _, t = timed(lambda: prover.prove(cache, pub2, priv2, device=device))
                        runs[fenced].append(t)
                out["warm_prove_unfenced_runs_s"] = runs[False]
                out["warm_prove_fenced_runs_s"] = runs[True]
                timing.SYNC_PHASES = True
            if ranks:
                out["group"] = group_proves(cache, pub2, priv2, proofs[1][1], td, device, ranks,
                                            [out["n_wires"], m, 4 * m], log)
            if profile:
                out["profiled_warm_prove"] = profiled_prove(cache, pub2, priv2, device, log)
    finally:
        timing.SYNC_PHASES = sync_was
    for (p, proof), name in zip(proofs, ("cold", "warm")):
        ok, t = timed(lambda: srs.verify(td, p, proof))
        out[f"verify_{name}_ms"] = 1e3 * t
        if not ok:
            raise AssertionError(f"verify rejected the {name} proof at m = 2^{log_m}")
    if srs.verify(td, proofs[1][0], flip_a0(proofs[1][1])):
        raise AssertionError(f"verify accepted a tampered proof at m = 2^{log_m}")
    if srs.verify(td, proofs[0][0], proofs[1][1]):
        raise AssertionError("verify accepted the warm proof against the cold witness's outputs")
    if cuda:
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def profiled_prove(cache, pub, priv, device, log=print) -> dict:
    """One more warm prove under torch.profiler (CPU and CUDA activity).
    On the device timeline, every kernel and copy is charged to the phase
    range (utils/timing.py's record_function) it started in; the sum is
    the device's busy time.  The profiler slows the host several times
    over, so compare the busy time with an unprofiled prove's wall time,
    not with this one's."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvpari_tpu_torch.protocol import prover
    from dvpari_tpu_torch.utils import timing

    timing.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prover.prove(cache, pub, priv, device=device)
        torch.cuda.synchronize()
    names = set(timing.summary())
    on_dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.key) for e in on_dev if e.key in names)
    if not spans:
        raise AssertionError("the profile holds no phase range on the device timeline")
    starts = [sp[0] for sp in spans]
    busy = {n: 0.0 for n in names}
    busy["outside any phase"] = 0.0
    per_kernel: dict = {}
    work = [e for e in on_dev if e.key not in names]
    for e in work:
        dur = e.time_range.end - e.time_range.start
        t, c = per_kernel.get(e.key, (0.0, 0))
        per_kernel[e.key] = (t + dur, c + 1)
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        inside = i >= 0 and e.time_range.start <= spans[i][1]
        busy[spans[i][2] if inside else "outside any phase"] += dur
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "device_busy_s": sum(t for t, _ in per_kernel.values()) / 1e6,
        "device_ops": len(work),
        "device_busy_by_phase_s": {k: v / 1e6 for k, v in sorted(busy.items())},
        "top_kernels": [{"name": n[:80], "device_s": t / 1e6, "count": c} for n, (t, c) in top],
    }
    log(f"profiled warm prove: device busy {out['device_busy_s']:.4f} s over "
        f"{len(work)} kernels and copies; by phase "
        + json.dumps({k.split(".", 1)[-1]: round(v, 4) for k, v in out["device_busy_by_phase_s"].items()}))
    return out


def report(r: dict, tag: str, log=print) -> None:
    """Human-readable lines of a rung() result."""
    m = r["m"]
    log(f"e2e m = 2^{m.bit_length() - 1}: setup {r['setup_s']:.3f} s, precompute "
        f"{r['precompute_s']:.3f} s, cold prove {r['cold_prove_s']:.3f} s, warm prove "
        f"{r['warm_prove_s']:.3f} s, verify {r['verify_cold_ms']:.1f} / {r['verify_warm_ms']:.1f} ms "
        f"(circuit made in {r['circuit_s']:.1f} s) {tag}")
    if "warm_prove_unfenced_runs_s" in r:
        runs = [r["warm_prove_unfenced_runs_s"], r["warm_prove_fenced_runs_s"]]
        log(f"e2e warm prove without phase fences {statistics.median(runs[0]):.4f} s, with them "
            f"{statistics.median(runs[1]):.4f} s (medians of {FENCE_REPS} each, alternating; "
            f"runs {[round(t, 4) for t in runs[0]]} and {[round(t, 4) for t in runs[1]]}) {tag}")
    for key in ("setup_phases", "cold_prove_phases", "warm_prove_phases"):
        log(f"e2e {key} " + json.dumps({k.split(".", 1)[1]: round(v, 4) for k, v in r[key].items()}))
    setup, cold = r["setup_phases"], r["cold_prove_phases"]
    log(f"e2e trees built on the {r['tree_path']} path: setup.tree {setup['setup.tree']:.3f} s, "
        f"setup.vanishing {setup['setup.vanishing']:.3f} s, cold prove.load_tree "
        f"{cold['prove.load_tree']:.3f} s, verify {r['verify_cold_ms']:.1f} / "
        f"{r['verify_warm_ms']:.1f} ms {tag}")
    log("e2e launches " + json.dumps({k: r[k] for k in ("setup_launches", "cold_prove_launches",
                                                        "warm_prove_launches")})
        + (f", peak device memory {r['peak_device_gib']:.2f} GiB" if "peak_device_gib" in r else ""))
    for R, g in r.get("group", {}).items():
        if R == 1:
            runs = [g["plain_prove_runs_s"], g["group_prove_runs_s"]]
            log(f"e2e warm prove, plain {statistics.median(runs[0]):.4f} s against over a one-rank "
                f"group ({g['backend']}) {statistics.median(runs[1]):.4f} s (medians of "
                f"{GROUP_REPS} each, in turns; runs {[round(t, 4) for t in runs[0]]} and "
                f"{[round(t, 4) for t in runs[1]]}) {tag}")
        else:
            log(f"e2e prove over {R} ranks sharing one device ({g['backend']}): warm "
                f"{[round(t, 4) for t in g['warm_prove_s']]} s, cold "
                f"{[round(t, 4) for t in g['cold_prove_s']]} s per rank; ranks on one device "
                f"measure correctness, not scaling {tag}")


def main(argv) -> int:
    import subprocess

    import torch

    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
        argv = [a for a in argv if a not in ("--device", device)]
    ranks = ()
    if "--ranks" in argv:
        i = argv.index("--ranks")
        j = i + 1
        while j < len(argv) and argv[j].isdigit():
            j += 1
        ranks = tuple(int(a) for a in argv[i + 1 : j])
        argv = argv[:i] + argv[j:]
    log_m = int(argv[0]) if argv else 16
    tag = ""
    if device == "cuda":
        if not torch.cuda.is_available():
            print("e2e_card: torch.cuda.is_available() is false", file=sys.stderr)
            return 1
        tag = "[" + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0] + "]"
    toy(device)
    r = rung(log_m, device, profile=device == "cuda", ranks=ranks)
    report(r, tag)
    print(json.dumps({"card": tag, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
