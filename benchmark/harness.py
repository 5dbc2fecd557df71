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

A configuration that states "ranks": R > 1 proves over R processes of
one world, one card each (benchmark/ranks.py): the set-up stays in this
process on one card, the cold prove and every later one run on the
ranks through the program's prove(group=), and every rank's proof is
checked.  Its cell has to ask for R chips.
"""

from __future__ import annotations

import gc
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
from benchmark.ranks import Ranks
from benchmark.reference.domain import Domain
from benchmark.reference.fr import P
from benchmark.reference.prover import expected_proof

FORBIDDEN = ("jax", "jaxlib", "flax", "dvpari_tpu")
N_PUBLIC = 2


class ForbiddenModules(RuntimeError):
    """A rank held a module the run may not hold (FORBIDDEN) once the
    window had closed."""


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
    if cell["chips"] != config.get("ranks", 1):
        raise ValueError(f"{workload} asks for {cell['chips']} chips, but {cell['config']} "
                         f"states {config.get('ranks', 1)} rank(s)")
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


def program_setup(trapdoor, cache: str, device) -> None:
    """The program's set-up into `cache`: the verifier's SRS setup and the
    prover's precomputes."""
    from dvpari_tpu_torch.protocol import prover, srs

    srs.verifier_runs_setup(trapdoor, cache, N_PUBLIC, True, True, device=device)
    prover.prover_prepares_precomputes(cache, True, device=device)


def rank0_points(n: int, ranks: int) -> int:
    """The points of an n-point MSM on rank 0 when `ranks` ranks split its
    32-point columns ceil(C/R) a rank (the split of the program's
    parallel/mesh.py:point_run)."""
    cols = -(-n // 32)
    return min(n, 32 * -(-cols // ranks))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: "float | None" = None, log=None,
             prove=None, setup=program_setup) -> dict:
    """One run: the result line's fields.  `prove` (prover.prove's
    signature, the program's by default) and `setup(trapdoor, cache,
    device)` are what is under test, so that the control can stand in for
    the program; `prove` pickles by its import path, since every rank of
    a cell on more than one chip imports it."""
    import torch

    from dvpari_tpu_torch.protocol import prover, srs
    from dvpari_tpu_torch.protocol.proof import Proof
    from dvpari_tpu_torch.storage import artifacts as art
    from dvpari_tpu_torch.utils import timing

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    prove_fn = prove or prover.prove
    cuda = torch.device(device).type == "cuda"
    cell = load_cell(root, workload)
    n_ranks = cell["cell"]["chips"]
    ranks = Ranks(n_ranks, None if cuda else device) if n_ranks > 1 else None
    cache = tempfile.mkdtemp(prefix="dvpari-bench-")
    sync_was = timing.SYNC_PHASES
    try:
        if ranks:  # they import while this process makes the inputs and sets up
            ranks.start()
        card = card_info() if cuda else {}
        inp = make_inputs(cell, seed)
        circuit, pool = inp["circuit"], inp["pool"]
        pubs = [v[1:1 + N_PUBLIC] for v in pool]
        privs = [limbs(v[1 + N_PUBLIC:]) for v in pool]
        td = srs.Trapdoor(*inp["trapdoor"])
        rec = {"m": circuit.m, "n_wires": len(pool[0]), "card": card}
        outputs = []  # (pool index, proof) of every proof the program made, on every rank
        phases = []  # the phases of each proof the window made (rank 0's)
        rank_peaks = []  # each rank's peak device bytes, from its latest answer
        timing.reset()
        timing.SYNC_PHASES = bool(trace)

        if ranks:
            answers = ranks.prove
        else:
            def answers(j, profile=False):
                return [answer(lambda: prove_fn(cache, pubs[j], privs[j], device=device), profile,
                               cuda)]

        def prove_one(j, profile=False):
            outs = answers(j, profile)
            outputs.extend((j, o["proof"]) for o in outs)
            phases.append(outs[0]["phases"])
            rank_peaks[:] = [o["peak"] for o in outs]
            return outs

        def sync():
            if cuda:
                torch.cuda.synchronize()

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
            f.write(circuit.dump)
        setup(td, cache, device)
        rec["setup_phases"] = timing.summary()
        held = 0  # what this process still holds on card 0 while the ranks prove
        if ranks:
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                held = int(torch.cuda.memory_allocated())
            ranks.join(cache, pubs, privs, prove_fn, trace)
            log(f"{n_ranks} ranks joined: {ranks.ready}")
        rec["cold_verified"] = bool(srs.verify(td, pubs[0], prove_one(0)[0]["proof"]))
        rec["cold_phases"] = phases.pop()
        sync()
        rec["cache_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(cache) for f in fs)
        rec["setup_s"] = time.perf_counter() - t_start
        log(f"set-up {rec['setup_s']:.3f} s (m = {circuit.m}, cache {rec['cache_bytes']} bytes)")

        window = SimpleNamespace(
            n=len(pool), log=log, prove=lambda j: prove_one(j)[0]["proof"], sync=sync,
            verify=lambda j, proof: bool(srs.verify(td, pubs[j], proof)))
        rec.update(cell["drive"].run(window, cell["traffic"], seconds))
        verdicts = rec["verdicts"]
        log(f"window {rec['window_s']:.3f} s: {len(verdicts)} proofs of {rec['attempted']} "
            f"attempted; prove s {[round(t, 4) for t in rec['prove_s']]}; verify ms "
            f"{[round(1e3 * t, 3) for t in rec['verify_s']]}")

        if trace:
            rec["trace"] = {"prove_phases": list(phases), "setup_phases": rec["setup_phases"],
                            "cold_phases": rec["cold_phases"], "prove_s": rec["prove_s"],
                            "msm_points": [rank0_points(n, n_ranks) for n in
                                           (len(pool[0]), circuit.m, 4 * circuit.m)],
                            "sm_clock_max_mhz": card.get("sm_clock_max_mhz")}
            rec["profiles"] = [o["profile"] for o in prove_one(0, profile=True)]
            rec["trace"]["profile"] = rec["profiles"][0]
        own = int(torch.cuda.max_memory_allocated()) if cuda else 0
        # card 0 holds this process and rank 0; card r > 0 holds rank r
        rec["card_peaks"] = ([max(own, rank_peaks[0] + held)] + rank_peaks[1:] if ranks
                             else [own])
        rec["memory_peak_bytes"] = max(rec["card_peaks"])
    finally:
        timing.SYNC_PHASES = sync_was
        if ranks:
            ranks.close()
        shutil.rmtree(cache, ignore_errors=True)
    if ranks and ranks.forbidden:
        raise ForbiddenModules(f"a rank held {sorted(ranks.forbidden)} after the window")

    # the check, once the window has closed, the peak is read and the ranks are gone
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
           "count": n_ranks, "memory_peak_bytes": rec["memory_peak_bytes"],
           "memory_peak_bytes_by_rank": rec["card_peaks"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["attempted"] - verdicts.count(True),
           "metrics": metrics, "device": dev}
    if trace:
        profs = rec["profiles"]
        dev["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        dev["window_s"] = sum(p["window_s"] for p in profs) / len(profs)
        dev["busy_s_by_rank"] = [p["busy_s"] for p in profs]
        prof = rec["trace"]["profile"]
        out["breakdown"] = {"device_ops": prof["top_ops"], "idle_gaps": prof["idle_gaps"]}
    out["card"] = card
    out["checks"] = checks
    return out


def answer(call, profile: bool, cuda: bool, device=None) -> dict:
    """One prove, call(), in this process: its proof, its phases, its
    profile (profiled_prove's summary, None unless `profile`) and the
    process's peak device bytes."""
    import torch

    from dvpari_tpu_torch.utils import timing

    timing.reset()
    if profile:
        proof, prof = profiled_prove(call, cuda, timing)
    else:
        proof, prof = call(), None
    return {"proof": proof, "phases": timing.summary(), "profile": prof,
            "peak": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}


def profiled_prove(call, cuda: bool, timing):
    """One call under torch.profiler: (its result, attribution.summarize of
    its device timeline with the traced window's wall time and the device
    operations themselves, (name, start us, end us))."""
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
    events = attribution.from_profiler(prof, names)
    summary = attribution.summarize(events, names)
    summary["window_s"] = wall
    summary["device_events"] = [(name, t0, t1) for kind, name, t0, t1 in events
                                if kind == "device"]
    return result, summary


def forbidden_modules() -> "list[str]":
    """Top-level names in sys.modules that the run may not hold."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
