"""One run of one cell of the port's benchmark.

Everything that belongs to one configuration, traffic mix or metric is
a file the harness finds by the name BENCHMARK.json gives it:
  configs: the `file` of the configuration's entry (JSON);
  traffic: benchmark/traffic/<traffic>.json, the mix's parameters, which
           name the drive that reads them;
  drives:  benchmark/drives/<drive>.py, whose run(window, traffic,
           seconds) asks for proofs and verifies in the mix's order for
           the window and returns what it timed (see drives/closed_loop.py);
  metrics: benchmark/metrics/<name>.py, whose read(run) takes the run's
           record and returns a number or None (nothing to read);
  circuits: benchmark/circuits/<circuit>.py, named by the configuration.

A run: the inputs from the seed (the circuit, a pool of its witnesses,
the trapdoor); set-up (the verifier's SRS setup and the prover's
precomputes in a fresh cache directory, one cold prove, its verify);
the window, driven by the traffic's drive; with trace=1 the phases
fenced and one more prove under torch.profiler; then the check of every
proof the program made against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from benchmark import attribution
from benchmark.reference.domain import Domain
from benchmark.reference.fr import P
from benchmark.reference.prover import expected_proof

FORBIDDEN = ("jax", "jaxlib", "flax", "dvpari_tpu")
N_PUBLIC = 2


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: str, workload: str) -> dict:
    """The cell's entries, configuration, traffic and metric readers."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    drive = _load_module(os.path.join(root, "benchmark", "drives", traffic["drive"] + ".py"),
                         "drive_" + traffic["drive"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    readers = {}
    for m in mine(bench["end_to_end"]) + mine(bench["per_layer"]):
        path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
        readers[m["name"]] = (m, _load_module(path, "metric_" + m["name"].replace(".", "_")).read)
    circuit = _load_module(os.path.join(root, "benchmark", "circuits", config["circuit"] + ".py"),
                           "circuit_" + config["circuit"])
    return {"cell": cell, "config": config, "traffic": traffic, "drive": drive, "circuit": circuit,
            "end_to_end": [m["name"] for m in mine(bench["end_to_end"])],
            "per_layer": [m["name"] for m in mine(bench["per_layer"])], "readers": readers}


def _field(rng) -> int:
    """A uniform nonzero element of Fr from 29 random bytes."""
    while True:
        v = int.from_bytes(rng.bytes(29), "little") % P
        if v:
            return v


def make_inputs(cell: dict, seed: int) -> dict:
    """The circuit, the witness pool and the trapdoor of `seed`: the same
    sizes on every seed, other values."""
    cfg, traffic = cell["config"], cell["traffic"]
    rng = np.random.default_rng(seed)
    circuit = cell["circuit"].make(cfg["m"], cfg["terms"], cfg["n_coeffs"],
                                   seed=int(rng.integers(2**63)))
    pool = [cell["circuit"].witness(circuit, _field(rng)) for _ in range(traffic["witness_pool"])]
    trapdoor = tuple(_field(rng) for _ in range(3))
    return {"circuit": circuit, "pool": pool, "trapdoor": trapdoor}


def limbs(vals: "list[int]") -> np.ndarray:
    """Canonical Fr values -> 12-bit limbs int32[20, n], the prover's
    witness layout (two limbs per three bytes)."""
    raw = np.frombuffer(b"".join(v.to_bytes(30, "little") for v in vals), np.uint8)
    b = raw.reshape(-1, 10, 3).astype(np.int32)
    lo = b[..., 0] | (b[..., 1] & 0xF) << 8
    hi = b[..., 1] >> 4 | b[..., 2] << 4
    return np.ascontiguousarray(np.stack([lo, hi], axis=-1).reshape(-1, 20).T)


def unlimbs(x: np.ndarray) -> "list[int]":
    """The inverse of `limbs`."""
    cols = x.T.astype(object)
    return [int(v) for v in sum(cols[:, i] << (12 * i) for i in range(20))]


def card_info() -> dict:
    """nvidia-smi's name, power limit and top SM clock of card 0 (empty
    where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        name, power, clock = (s.strip() for s in out.splitlines()[0].split(","))
        return {"name": name, "power_limit_w": float(power), "sm_clock_max_mhz": float(clock)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def _proof_key(p) -> tuple:
    return (bytes(p.commit_p), bytes(p.kzg_k), int(p.a0), int(p.b0))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: "float | None" = None, log=None) -> dict:
    """One run: the result line's fields."""
    import torch

    from dvpari_tpu_torch.protocol import prover, srs
    from dvpari_tpu_torch.protocol.proof import Proof
    from dvpari_tpu_torch.storage import artifacts as art
    from dvpari_tpu_torch.utils import timing

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell = load_cell(root, workload)
    card = card_info() if cuda else {}
    inp = make_inputs(cell, seed)
    circuit, pool = inp["circuit"], inp["pool"]
    pubs = [v[1:1 + N_PUBLIC] for v in pool]
    privs = [limbs(v[1 + N_PUBLIC:]) for v in pool]
    td = srs.Trapdoor(*inp["trapdoor"])
    rec = {"m": circuit.m, "n_wires": len(pool[0]), "card": card}
    outputs = []  # (pool index, proof) of every proof the program made
    phases = []  # the phases of each proof the window made
    timing.reset()
    sync_was = timing.SYNC_PHASES
    timing.SYNC_PHASES = bool(trace)
    cache = tempfile.mkdtemp(prefix="dvpari-bench-")

    def prove(j):
        timing.reset()
        proof = prover.prove(cache, pubs[j], privs[j], device=device)
        phases.append(timing.summary())
        outputs.append((j, proof))
        return proof

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
            f.write(circuit.dump)
        srs.verifier_runs_setup(td, cache, N_PUBLIC, True, True, device=device)
        prover.prover_prepares_precomputes(cache, True, device=device)
        rec["setup_phases"] = timing.summary()
        rec["cold_verified"] = bool(srs.verify(td, pubs[0], prove(0)))
        rec["cold_phases"] = phases.pop()
        sync()
        rec["cache_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(cache) for f in fs)
        rec["setup_s"] = time.perf_counter() - t_start
        log(f"set-up {rec['setup_s']:.3f} s (m = {circuit.m}, cache {rec['cache_bytes']} bytes)")

        window = SimpleNamespace(
            n=len(pool), log=log, prove=prove, sync=sync,
            verify=lambda j, proof: bool(srs.verify(td, pubs[j], proof)))
        rec.update(cell["drive"].run(window, cell["traffic"], seconds))
        verdicts = rec["verdicts"]
        log(f"window {rec['window_s']:.3f} s: {len(verdicts)} proofs of {rec['attempted']} "
            f"attempted; prove s {[round(t, 4) for t in rec['prove_s']]}; verify ms "
            f"{[round(1e3 * t, 3) for t in rec['verify_s']]}")

        if trace:
            rec["trace"] = {"prove_phases": list(phases), "setup_phases": rec["setup_phases"],
                            "cold_phases": rec["cold_phases"], "prove_s": rec["prove_s"],
                            "msm_points": [len(pool[0]), circuit.m, 4 * circuit.m],
                            "sm_clock_max_mhz": card.get("sm_clock_max_mhz")}
            _, rec["trace"]["profile"] = profiled_prove(lambda: prove(0), cuda, timing)
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
    finally:
        timing.SYNC_PHASES = sync_was
        shutil.rmtree(cache, ignore_errors=True)

    # the check, once the window has closed and the peak is read
    t_ref = time.perf_counter()
    domain = Domain(circuit.m)
    want = [expected_proof(domain, circuit, v, inp["trapdoor"]) for v in pool]
    mismatched = sum(_proof_key(p) != (w.commit_p, w.kzg_k, w.a0, w.b0)
                     for j, p in outputs for w in [want[j]])
    j, p = outputs[-1] if outputs else (0, None)
    tampered = (p is not None and srs.verify(
        td, pubs[j], Proof(p.commit_p, p.kzg_k, p.a0 ^ 1, p.b0)))
    rec["reference_s"] = time.perf_counter() - t_ref
    checks = {
        "proofs_mismatched": {"value": int(mismatched), "limit": 0},
        "verify_rejected": {"value": int(verdicts.count(False) + (not rec["cold_verified"])),
                            "limit": 0},
        "tampered_accepted": {"value": int(bool(tampered)), "limit": 0},
        "proofs_failed": {"value": int(rec["failed"]), "limit": 0},
    }
    log(f"reference check of {len(outputs)} proofs in {rec['reference_s']:.3f} s")
    correct = bool(verdicts) and all(c["value"] <= c["limit"] for c in checks.values())

    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for name in names:
        entry, read = cell["readers"][name]
        v = read(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["attempted"] - verdicts.count(True),
           "metrics": metrics, "device": dev}
    if trace:
        prof = rec["trace"]["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["top_ops"], "idle_gaps": prof["idle_gaps"]}
    out["card"] = card
    out["checks"] = checks
    return out


def profiled_prove(call, cuda: bool, timing):
    """One call under torch.profiler: (its result, attribution.summarize of
    its device timeline with the traced window's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    timing.reset()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        result = call()
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = set(timing.summary())
    summary = attribution.summarize(attribution.from_profiler(prof, names), names)
    summary["window_s"] = wall
    return result, summary


def forbidden_modules() -> "list[str]":
    """Top-level names in sys.modules that the run may not hold."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
