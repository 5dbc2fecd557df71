#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvpari_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version on the card (bit-equal), then drives the port's main path at the
size a prove uses: the fixed-base fan-out of 2^18 points (g_k of an
m = 2^16 prove), a 2^18-point MSM over those points and a ragged
2^16 + 5-point MSM, each checked against the python-int host oracle
(sum k_i e_i mod R) * G.  Ladder operands crafted so that the complete
add needs its doubling (ops/msm_kernel.py:doubling_operands) and a
point-add column with one P = Q lane hold the kernels' doubling branch
to the plain versions too.  A second build with phase clocks
(BS_PHASE_CLOCKS) splits the ladder's cycles per window by phase and
counts the doublings that ran.  Prints timings beside the card's name
and power limit, one JSON line of per-kernel numbers, and as the last
line {"ok": true, "device": {...}}.  Any failure raises: no phase is
caught.  Exits non-zero, printing no result, when CUDA is unavailable.

The protocol runs end to end on the card too (scripts/e2e_card.py): the
toy circuit's setup -> prove must give the pinned proof TOY_PROOF_HEX
(tests/golden_n16.py) and verify must accept it and reject a flipped
bit; then an m = 2^16 circuit (synth_multiterm) runs setup, precompute,
a cold and a warm prove, each proof verified and a tampered one
rejected, with per-phase times and the kernel launches per setup and
per prove, which must be exactly what m and the wire count give (five
ladders per setup; per prove three ladders and, per MSM, one table
build, one add per column fold step and five in-word folds).  Every
ladder and point-add launch of that setup and cold prove is then
replayed on its own operands against its plain version, bit for bit.
The kernels line's launches sum the counted main paths: the 2^18
fan-out and MSMs, the 2^16 setup and both proves, and the sharded
proves below.

Phase 9, the sharded prove (parallel/, protocol/prover.py:prove(group=)),
in the rung's cache with no second setup: the warm witness proved over
a one-rank NCCL world on the card in this process, and over two ranks
that share the one card through gloo (NCCL takes one rank per card),
spawned as two processes.  Every rank's proof must equal the rung's
warm proof byte for byte and verify, and each rank's ladder and
point-add launches must be what its column runs give.  Each of the two
ranks' launches is then replayed on the warm prove's MSM operands,
sliced by that rank's column run, against its plain version, and the
ranks' partials must fold to the whole MSM.  The one-rank
prove is timed in turns against the plain warm prove (the group path's
cost at R = 1); the two-rank time is printed, but two ranks on one card
measure correctness, not scaling.

Before the protocol, two host-and-torch-op phases of the path: the
native host backend (dvpari_tpu_torch/native.py, built with g++ beside
the nvcc builds) -- 16 seeded scalar multiplications and decodes held to
the python oracle, and the 2^16-leaf vanishing polynomial held to the
ctypes Kronecker tree, both timed; and the device tree build (K8,
fftree/device_build.py) -- at 2^17 leaves (the rung's trees) held to
the host chain layer for layer, both timed, and at 2^22 leaves timed
with its peak memory, 64 seeded lanes of every layer held to x(C + [i]G)
and to the isogeny x-map of the layer below in python ints.  The rung's
setup must then have built its trees on the path the threshold
(DVPARI_DEVICE_TREE_MIN) picks.
"""

import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
import multiprocessing

N_FANOUT = 1 << 18  # g_k of an m = 2^16 prove
N_RAGGED = (1 << 16) + 5  # a wire-count-shaped g_m
N_SMALL = 100  # compare phase: 4 columns of points, 1 zero column added
N_SPOT = 64  # fan-out slots checked against host.smul
E2E_LOG_M = 16  # the protocol rung: m = 2^16 constraints
N_NATIVE = 16  # native scalar multiplications and decodes held to the oracle
TREE_LOG_N = E2E_LOG_M + 1  # the rung's trees: 2m leaves
TREE_BIG_LOG_N = 22  # where the JAX package switches to its device build
REPS = 3
SEED = 7
ORACLE_WORKERS = 6
GROUP_RANKS = (1, 2)  # phase 9: a one-rank NCCL world, two gloo ranks on the one card

SOURCE = "dvpari_tpu_torch/csrc/bs_ladder.cu"
LADDER_TPU = "dvpari_tpu/ops/pallas_msm.py:33"  # _ladder_kernel
ADD_TPU = "dvpari_tpu/ops/xsk233_bs.py:107"  # add (XLA) in tnaf_table / fold_sum


def log(msg: str) -> None:
    print(msg, flush=True)


def _smul_g(k: int):
    """Oracle job (runs in a worker process): [k]G on the host."""
    from dvpari_tpu_torch.utils import xsk233_host as host

    return host.smul(k, (host.GX, host.GY))


def _smul_of_multiple(k: int, e: int):
    """Oracle job (runs in a worker process): [k]([e]G) on the host."""
    from dvpari_tpu_torch.utils import xsk233_host as host

    return host.smul(k, host.smul(e, (host.GX, host.GY)))


def msm_point_adds(n: int) -> int:
    """point_add launches of one MSM over n points (ops/msm_kernel.py:
    msm_packed): the table build, one per column fold step (ceil(log2 C)
    of C = ceil(n/32) columns) and the five in-word folds."""
    C = -(-n // 32)
    return 1 + (C - 1).bit_length() + 5


def _nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    import numpy as np

    from dvpari_tpu_torch import native
    from dvpari_tpu_torch.fftree import device_build as dbuild, tree as tree_mod
    from dvpari_tpu_torch.ops import fr, msm_kernel, xsk233
    from dvpari_tpu_torch.ops import xsk233_bs as bs
    from dvpari_tpu_torch.parallel import mesh
    from dvpari_tpu_torch.utils import kronecker, roofline
    from dvpari_tpu_torch.utils import xsk233_host as host

    dev = torch.device("cuda")

    # -- phase 1: the card --------------------------------------------------
    card = _nvidia_smi("name,power.limit")
    clock_mhz = float(_nvidia_smi("clocks.max.sm", units=False))
    log(card)
    log(f"max SM clock {clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}")
    tag = f"[{card}]"

    def sync():
        torch.cuda.synchronize()

    def median_s(fn, reps=REPS):
        fn()  # warm-up
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    def event_ms(fn, reps=REPS):
        """Median device time of one call, CUDA events, after a warm-up."""
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    # -- inputs (host), and the oracle jobs started on them -----------------
    rng = random.Random(SEED)
    es = [rng.randrange(1, host.R) for _ in range(N_FANOUT)]
    ks = [rng.randrange(1, host.R) for _ in range(N_FANOUT)]
    kr = [rng.randrange(1, host.R) for _ in range(N_RAGGED)]
    spots = sorted(rng.sample(range(1, N_FANOUT - 1), N_SPOT - 2) + [0, N_FANOUT - 1])
    native_ke = [(rng.randrange(1, host.R), rng.randrange(1, host.R)) for _ in range(N_NATIVE)]
    want_msm = sum(k * e for k, e in zip(ks, es)) % host.R
    want_ragged = sum(k * e for k, e in zip(kr, es)) % host.R
    es_limbs, ks_limbs, kr_limbs = fr.from_int(es), fr.from_int(ks), fr.from_int(kr)

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(ORACLE_WORKERS, mp_context=ctx) as pool:
        oracle_msm = pool.submit(_smul_g, want_msm)
        oracle_ragged = pool.submit(_smul_g, want_ragged)
        oracle_spots = [pool.submit(_smul_g, es[j]) for j in spots]
        oracle_native = [pool.submit(_smul_of_multiple, k, e) for k, e in native_ke]

        # -- phase 2: build (the main library, the profiling one, the native
        # host backend), all at once
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as builds:
            jobs = [builds.submit(msm_kernel.build),
                    builds.submit(msm_kernel.build, msm_kernel.SOURCE, msm_kernel.PROFILE_DEFINES),
                    builds.submit(native.build)]
            libs = [j.result() for j in jobs]
        log(f"build: {time.perf_counter() - t0:.2f} s -> "
            + ", ".join(os.path.relpath(so) for so in libs))
        log(f"native host backend: {' '.join(os.path.basename(a) for a in native.command('LIB'))}; "
            f"PCLMUL {native.has_pclmul()}, OpenMP threads {native.omp_threads()}")
        for what, so in zip(("main", "profiling"), libs):
            for line in msm_kernel.build_logs.get(so, "").splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  ptxas ({what}): {line.strip()}")
        occ = msm_kernel.occupancy()
        log(f"resident blocks per SM and dynamic shared memory per block: "
            f"{json.dumps(occ)} (256 threads each)")
        if occ["ladder"]["blocks_per_sm"] < 1 or occ["point_add"]["blocks_per_sm"] < 1:
            raise AssertionError(f"a kernel cannot be resident: {occ}")

        def doubles_of(stats, want, what):
            if stats["doubles_run"] != want or stats["doubles_needed"] != want:
                raise AssertionError(f"{what}: doubling ran {stats['doubles_run']} times, "
                                     f"needed {stats['doubles_needed']}, expected {want}")

        # -- phase 3: kernels vs plain versions on the card -------------------
        srng = np.random.default_rng(SEED)
        small_e = [int(x) for x in srng.integers(1, 2**62, N_SMALL)]
        oh_s, ng_s, C_s = xsk233.recode(fr.from_int(small_e), dev)  # C_s = 4
        gtab = xsk233.gen_table_planes(dev)
        compare = {}

        def held(name, kernel_fn, plain_fn, timed=True):
            got, want = kernel_fn(), plain_fn()
            sync()
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel != plain (max |diff| {err})")
            rec = compare.setdefault(name, {"max_abs_err": 0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if timed:  # timed in phase 7, once the oracle workers are done
                rec["fns"] = (kernel_fn, plain_fn)
            return got

        # the ladder with one shared table (the fan-out's form) ...
        pts_s = held(
            "ladder",
            lambda: msm_kernel.ladder(oh_s, ng_s, gtab),
            lambda: bs.ladder(oh_s, ng_s, gtab),
            timed=False,
        )
        # ... and with a table per column (the MSM's): those 128 points plus
        # one all-zero (infinity) column, 160 non-zero scalars
        planes_s = torch.cat([pts_s, torch.zeros_like(pts_s[..., :1])], dim=-1).contiguous()
        small_k = [int(x) for x in srng.integers(1, 2**62, 32 * (C_s + 1))]
        oh_m, ng_m, _ = xsk233.recode(fr.from_int(small_k), dev)
        table_s = bs.tnaf_table(planes_s, add=msm_kernel.point_add)
        held(
            "ladder",
            lambda: msm_kernel.ladder(oh_m, ng_m, table_s),
            lambda: bs.ladder(oh_m, ng_m, table_s),
        )
        # point add: generic pairs, P + P, P + (-P), one column with a
        # single P = Q lane (bit 3: slot 99, the last finite point), infinity / zero planes
        q_s = torch.roll(planes_s, 1, dims=-1)
        q_s[..., 1] = planes_s[..., 1]
        q_s[..., 2] = bs.neg(planes_s[..., 2:3])[..., 0]
        lane = torch.tensor(1 << 3, dtype=torch.int32, device=dev)
        q_s[..., 3] = (planes_s[..., 3] & lane) | (q_s[..., 3] & ~lane)
        q_s = q_s.contiguous()
        need = msm_kernel.doubling_lanes(planes_s, q_s)
        if int(need[3]) != 1 << 3 or int(need[1]) == 0 or bool((need[[0, 2, 4]] != 0).any()):
            raise AssertionError(f"point_add operands: P = Q lanes {need.tolist()}")
        sum_s = held(
            "point_add",
            lambda: msm_kernel.point_add(planes_s, q_s),
            lambda: bs.add(planes_s, q_s),
        )
        out, stats = msm_kernel.profile_point_add(planes_s, q_s)
        if not torch.equal(out, sum_s):
            raise AssertionError("profiling build's point_add != main build's")
        doubles_of(stats, 2, "point_add with P + P and one P = Q lane")
        # the ladder on operands whose add at window 60 doubles in four
        # slots of four columns
        slots_s = [0, 37, 70, 99]  # finite points (scalars 0..99 are non-zero)
        oh_d, ng_d, tab_d = msm_kernel.doubling_operands(table_s, slots_s, SEED)
        lad_d = held(
            "ladder",
            lambda: msm_kernel.ladder(oh_d, ng_d, tab_d),
            lambda: bs.ladder(oh_d, ng_d, tab_d),
            timed=False,
        )
        out, stats = msm_kernel.profile_ladder(oh_d, ng_d, tab_d)
        if not torch.equal(out, lad_d):
            raise AssertionError("profiling build's ladder != main build's")
        doubles_of(stats, 4, "crafted ladder, 5 columns")
        # the entry points as a whole, against the plain composition
        held(
            "msm_packed",
            lambda: msm_kernel.msm_packed(oh_m, ng_m, planes_s),
            lambda: bs.fold_sum(bs.ladder(oh_m, ng_m, bs.tnaf_table(planes_s))),
            timed=False,
        )
        held(
            "mulgen_packed",
            lambda: msm_kernel.mulgen_packed(oh_s, ng_s, gtab),
            lambda: bs.ladder(oh_s, ng_s, gtab),
            timed=False,
        )
        log("kernels " + json.dumps({
            "compare_cols": {"ladder": [C_s, C_s + 1, C_s + 1], "point_add": C_s + 1},
            "kernels": [
                {"name": "ladder", "launches": msm_kernel.ladder.launches, "matches_plain": True},
                {"name": "point_add", "launches": msm_kernel.point_add.launches,
                 "matches_plain": True},
            ],
        }))

        # -- phases 4-6: the main path, counted -------------------------------
        msm_kernel.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        proj, planes = xsk233.mulgen_limbs(es_limbs, device=dev)
        sync()
        t_fan = time.perf_counter() - t0
        res = xsk233.msm_limbs(ks_limbs, planes, device=dev)
        C_r = -(-N_RAGGED // 32)
        planes_r = planes[..., :C_r].clone()
        planes_r[..., -1] &= (1 << (N_RAGGED - 32 * (C_r - 1))) - 1  # zero padding slots
        res_r = xsk233.msm_limbs(kr_limbs, planes_r, device=dev)
        sync()
        launches = {"ladder": msm_kernel.ladder.launches, "point_add": msm_kernel.point_add.launches}
        log(f"main path launches: {json.dumps(launches)} (first fan-out {t_fan:.3f} s, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} was not launched on the main path")

        # -- checks against the host oracle -----------------------------------
        if proj.shape != (3, 8, N_FANOUT) or tuple(planes.shape) != (3, 233, N_FANOUT // 32):
            raise AssertionError(f"fan-out shapes {proj.shape}, {tuple(planes.shape)}")
        got_spots = xsk233.to_affine_int(proj[..., spots])
        for j, got, fut in zip(spots, got_spots, oracle_spots):
            if got != fut.result():
                raise AssertionError(f"fan-out slot {j} != host.smul")
        log(f"fan-out 2^18: {N_SPOT} slots equal host.smul")
        if xsk233.to_affine_int(res) != oracle_msm.result():
            raise AssertionError("MSM 2^18 != host oracle")
        log("MSM 2^18: equals (sum k_i e_i mod R) * G")
        if xsk233.to_affine_int(res_r) != oracle_ragged.result():
            raise AssertionError("MSM 2^16+5 != host oracle")
        log("MSM 2^16+5: equals (sum k_i e_i mod R) * G")
        native_want = [f.result() for f in oracle_native]

    # -- the kernels against their plain versions at the main path's shapes:
    # the 2^18 fan-out's ladder (shared table), the 2^18 MSM's table build
    # (one six-sum launch), its ladder (per-column table) and first fold step
    C = N_FANOUT // 32
    oh_e, ng_e, _ = xsk233.recode(es_limbs, dev)
    held("ladder", lambda: msm_kernel.ladder(oh_e, ng_e, gtab),
         lambda: bs.ladder(oh_e, ng_e, gtab), timed=False)
    oh, ng, _ = xsk233.recode(ks_limbs, dev)

    def plain_table(p, step=1024):
        """The plain window table, built a slice of columns at a time."""
        return torch.cat([bs.tnaf_table(p[..., i:i + step])
                          for i in range(0, p.shape[-1], step)], dim=-1)

    table = held("point_add", lambda: bs.tnaf_table(planes, add=msm_kernel.point_add),
                 lambda: plain_table(planes), timed=False)
    lad = held("ladder", lambda: msm_kernel.ladder(oh, ng, table),
               lambda: bs.ladder(oh, ng, table), timed=False)
    half = C // 2
    held("point_add", lambda: msm_kernel.point_add(lad[..., :half], lad[..., half:]),
         lambda: bs.add(lad[..., :half], lad[..., half:]), timed=False)
    log(f"kernels equal their plain versions at the main path's shapes: ladder {C} "
        f"columns (shared and per-column table), point_add {6 * C} columns (table "
        f"build) and {half} (first fold step)")
    # the crafted doubling operands at full width: three slots, three columns
    slots = [0, 32 * (C // 8) + 7, 32 * C - 1]
    oh_d, ng_d, tab_d = msm_kernel.doubling_operands(table, slots, SEED)
    lad_d = held("ladder", lambda: msm_kernel.ladder(oh_d, ng_d, tab_d),
                 lambda: bs.ladder(oh_d, ng_d, tab_d), timed=False)
    out, stats = msm_kernel.profile_ladder(oh_d, ng_d, tab_d)
    if not torch.equal(out, lad_d):
        raise AssertionError("profiling build's ladder != main build's (crafted)")
    doubles_of(stats, 3, f"crafted ladder, {C} columns")
    log(f"crafted doubling operands: ladder {C} columns equals its plain version; "
        f"doubling ran in {stats['doubles_run']} column-windows")
    del oh_d, ng_d, tab_d, lad_d, out

    # -- attribution: the profiling build on the main path's ladder operands
    prof = {}
    for what, ops, want in (("MSM 2^18", (oh, ng, table), lad),
                            ("fan-out 2^18", (oh_e, ng_e, gtab), None)):
        out, stats = msm_kernel.profile_ladder(*ops)
        if want is not None and not torch.equal(out, want):
            raise AssertionError(f"profiling build's ladder != main build's ({what})")
        doubles_of(stats, 0, f"{what} ladder")
        prof[what] = stats
    st = prof["MSM 2^18"]
    per_window = {k: v / st["windows"] for k, v in st["cycles"].items()}
    log("ladder phases " + json.dumps({
        "operands": "MSM 2^18, per-column table", "build": "BS_PHASE_CLOCKS",
        "cycles_per_column_window": {k: round(v, 1) for k, v in per_window.items()},
        "total": round(sum(per_window.values()), 1),
        "column_windows": st["windows"],
        "doubles_run": {k: v["doubles_run"] for k, v in prof.items()},
    }) + f" {tag}")

    # -- phase 7: timings -----------------------------------------------------
    t_fan = median_s(lambda: xsk233.mulgen_limbs(es_limbs, device=dev))
    t_msm = median_s(lambda: xsk233.msm_limbs(ks_limbs, planes, device=dev))
    t_rag = median_s(lambda: xsk233.msm_limbs(kr_limbs, planes_r, device=dev))
    for name, n, t in (("fan-out 2^18", N_FANOUT, t_fan), ("MSM 2^18", N_FANOUT, t_msm),
                       ("MSM 2^16+5", N_RAGGED, t_rag)):
        log(f"{name}: {t:.4f} s median of {REPS}, {n / t:,.0f} pts/s {tag}")

    # the MSM's parts at 2^18
    t_recode = median_s(lambda: xsk233.recode(ks_limbs, dev))
    t_table = median_s(lambda: bs.tnaf_table(planes, add=msm_kernel.point_add))
    t_fold = median_s(lambda: bs.fold_sum(lad, add=msm_kernel.point_add))
    ms = {
        "ladder": event_ms(lambda: msm_kernel.ladder(oh, ng, table)),
        "point_add": event_ms(lambda: msm_kernel.point_add(table[5], table[6])),
    }
    ms_shared = event_ms(lambda: msm_kernel.ladder(oh_e, ng_e, gtab))
    ms_prof = event_ms(lambda: msm_kernel.profile_ladder(oh, ng, table))
    _, add_stats = msm_kernel.profile_point_add(table[5], table[6])
    log(
        f"MSM 2^18 parts: recode {t_recode:.4f} s, table build {t_table:.4f} s, "
        f"ladder kernel {ms['ladder'] / 1e3:.4f} s, folds {t_fold:.4f} s {tag}"
    )
    log(f"fan-out 2^18 ladder kernel (shared table) {ms_shared / 1e3:.4f} s {tag}")
    log(f"profiling build's ladder (MSM 2^18, with its reset and read-back) "
        f"{ms_prof / 1e3:.4f} s against {ms['ladder'] / 1e3:.4f} s {tag}")

    for rec in compare.values():
        if "fns" in rec:
            kernel_fn, plain_fn = rec.pop("fns")
            rec["small_ms"] = 1e3 * median_s(kernel_fn)
            rec["plain_ms"] = 1e3 * median_s(plain_fn)

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import e2e_card
    import tree_build

    # -- the native host backend: the verifier's scalar multiplications and
    # decodes against the python oracle, the vanishing tree against ctypes
    t0 = time.perf_counter()
    got = [host.smul_fast(k, host.smul_fast(e, (host.GX, host.GY))) for k, e in native_ke]
    t_smul = (time.perf_counter() - t0) / (2 * N_NATIVE)
    if got != native_want:
        raise AssertionError("native smul_fast != python smul")
    records = [host.encode(p) for p in got]
    t0 = time.perf_counter()
    dec = [host.decode_fast(r) for r in records]
    t_dec = (time.perf_counter() - t0) / N_NATIVE
    t0 = time.perf_counter()
    dec_py = [host.decode(r) for r in records]
    t_dec_py = (time.perf_counter() - t0) / N_NATIVE
    if dec != dec_py or dec != [(p, True) for p in got]:
        raise AssertionError("native decode_fast != python decode")
    log(f"native: {N_NATIVE} smul_fast([k]([e]G)) equal python smul, {N_NATIVE} decode_fast equal "
        f"decode; {1e3 * t_smul:.3f} ms per scalar multiplication, {1e3 * t_dec:.3f} ms per "
        f"decode (python {1e3 * t_dec_py:.1f} ms) {tag}")

    # -- the device tree build (K8): 2^17 leaves against the host chain, then
    # 2^22 leaves, timed with its peak memory and spot-checked in python ints
    r = tree_build.host_vs_device(TREE_LOG_N, dev, reps=1)
    log(f"tree 2^{TREE_LOG_N} leaves: device build {r['device_s']:.4f} s, host chain "
        f"{r['host_s']:.4f} s, every layer equal {tag}")
    small = tree_mod.FFTree.build(1 << TREE_LOG_N, False, TREE_LOG_N, dev, device_build=True)
    dom = small.layers[0][:, 0::2]  # 2^16 leaves, as setup's z_coeffs(1) takes them
    t0 = time.perf_counter()
    zc = kronecker.vanishing_coeffs_limbs(dom)
    t_zn = time.perf_counter() - t0
    t0 = time.perf_counter()
    zc_ct = kronecker.vanishing_coeffs(fr.to_int(dom), fr.P)
    t_zc = time.perf_counter() - t0
    if fr.to_int(zc) != zc_ct:
        raise AssertionError("native vanishing tree != ctypes Kronecker tree")
    log(f"vanishing polynomial of 2^{TREE_LOG_N - 1} leaves: native {t_zn:.4f} s, ctypes Kronecker "
        f"tree {t_zc:.4f} s (its python-int conversions included), equal {tag}")
    del small, dom, zc, zc_ct
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    big = tree_mod.FFTree.build(1 << TREE_BIG_LOG_N, False, TREE_BIG_LOG_N, dev, device_build=True)
    sync()
    t_big = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    checked = tree_build.spot_check(big, False, TREE_BIG_LOG_N)
    log(f"tree 2^{TREE_BIG_LOG_N} leaves: device build {t_big:.4f} s, peak device memory {peak:.2f} "
        f"GiB (layer-0 chunks of {dbuild.layer0_chunk()} lanes); {checked} values of its "
        f"{len(big.layers)} layers equal x(C + [i]G) and the isogeny x-maps {tag}")
    del big

    # -- phase 8: the protocol end to end (scripts/e2e_card.py) ------------------

    e2e_card.toy(dev, log)
    rung_ops = []  # operands of the fan-outs and MSMs of the rung's setup and cold prove
    warm_ops = []  # and of the warm prove's MSMs, which phase 9's ranks split
    e2e = e2e_card.rung(E2E_LOG_M, dev, log, record=rung_ops, ranks=GROUP_RANKS,
                        record_warm=warm_ops)
    e2e_card.report(e2e, tag, log)
    want_path = "device" if 2 * e2e["m"] >= tree_mod.device_tree_min() else "host"
    if e2e["tree_path"] != want_path:
        raise AssertionError(f"the rung's setup built its trees on the {e2e['tree_path']} path, "
                             f"the threshold picks {want_path}")
    m, n_wires = e2e["m"], e2e["n_wires"]
    want = {"setup": {"ladder": 5, "point_add": 0},
            "prove": {"ladder": 3,
                      "point_add": sum(msm_point_adds(n) for n in (n_wires, m, 4 * m))}}
    for path in ("setup", "cold_prove", "warm_prove"):
        got = e2e[f"{path}_launches"]
        if got != want[path.split("_")[-1]]:
            raise AssertionError(f"{path} at m = 2^{E2E_LOG_M} launched {got}, expected "
                                 f"{want[path.split('_')[-1]]}")
        for name in launches:
            launches[name] += got[name]
    log(f"e2e launches equal the counts m = {m} and {n_wires} wires give: setup "
        f"{json.dumps(want['setup'])}, prove {json.dumps(want['prove'])}")

    # -- phase 9: the sharded prove (run inside the rung, in its cache) -----
    group = e2e["group"]
    if (sorted(group) != sorted(GROUP_RANKS) or group[1]["backend"] != "nccl"
            or group[2]["backend"] != "gloo"):
        raise AssertionError(f"sharded phase ran {sorted(group)} on "
                             f"{[g['backend'] for g in group.values()]}")
    for R, g in sorted(group.items()):
        for got in g["launches"]:  # each rank's, checked against its column runs in the rung
            for name in launches:
                launches[name] += got[name]
        log(f"sharded prove over {R} rank(s) at m = 2^{E2E_LOG_M} ({g['backend']}): proof equals "
            f"the warm proof on every rank and verifies; launches per rank "
            f"{json.dumps(g['launches'])}")

    # replay every kernel launch of that setup and cold prove on its own
    # operands: each fan-out's ladder (shared table) and each MSM's table
    # build, ladder (per-column table) and fold steps
    sizes = [(kind, int(sc.shape[-1])) for kind, sc, _ in rung_ops]
    want_sizes = ([("fan-out", n) for n in (n_wires, m, m, m, 2 * m)]
                  + [("msm", n) for n in (n_wires, m, 4 * m)])
    if sizes != want_sizes:
        raise AssertionError(f"rung called fan-outs and MSMs of {sizes}, expected {want_sizes}")
    replayed = {"ladder": 0, "point_add": 0}
    t0 = time.perf_counter()

    def counted_add(counts):
        """The point add held to its plain version, counted in `counts`."""
        def add(p, q):
            counts["point_add"] += 1
            return held("point_add", lambda: msm_kernel.point_add(p, q), lambda: bs.add(p, q),
                        timed=False)
        return add

    checked_add = counted_add(replayed)

    for kind, scalars, pl in rung_ops:
        oh_r, ng_r, _ = xsk233.recode(scalars, dev)
        if kind == "fan-out":
            tab_r = gtab
        else:
            pl = pl.contiguous()
            replayed["point_add"] += 1
            tab_r = held("point_add", lambda: bs.tnaf_table(pl, add=msm_kernel.point_add),
                         lambda: plain_table(pl), timed=False)
        replayed["ladder"] += 1
        lad_r = held("ladder", lambda: msm_kernel.ladder(oh_r, ng_r, tab_r),
                     lambda: bs.ladder(oh_r, ng_r, tab_r), timed=False)
        if kind == "msm":
            bs.fold_sum(lad_r, add=checked_add)
    want_replay = {k: want["setup"][k] + want["prove"][k] for k in replayed}
    if replayed != want_replay:
        raise AssertionError(f"replayed {replayed} launches, the rung made {want_replay}")
    del rung_ops, oh_r, ng_r, tab_r, lad_r
    log(f"every kernel launch of the m = 2^{E2E_LOG_M} setup and cold prove equals its plain "
        f"version on the same operands: {json.dumps(replayed)} (fan-out ladders at "
        f"{[-(-n // 32) for k, n in sizes if k == 'fan-out']} columns, MSMs at "
        f"{[-(-n // 32) for k, n in sizes if k == 'msm']}; {time.perf_counter() - t0:.1f} s)")

    # replay each rank's launches of phase 9's worlds of more than one rank
    # on the warm prove's MSM operands, sliced by the rank's column run
    # (parallel/sharded.py:msm_limbs_sharded): its table build, ladder and
    # folds, then the fold of the ranks' partials that every rank makes.
    # A world of one runs the whole MSMs, at the shapes replayed above.
    if [(k, int(sc.shape[-1])) for k, sc, _ in warm_ops] != want_sizes[-3:]:
        raise AssertionError(f"warm prove called MSMs of {len(warm_ops)} sizes, expected "
                             f"{want_sizes[-3:]}")
    t0 = time.perf_counter()
    for R in (R for R in GROUP_RANKS if R > 1):
        runs = []
        per_rank = [{"ladder": 0, "point_add": 0} for _ in range(R)]
        for _, scalars, pl in warm_ops:
            n = int(scalars.shape[-1])
            parts = []
            for r in range(R):
                c0, c1 = mesh.col_run(-(-n // 32), R, r)
                lo, hi = mesh.point_run(n, R, r)
                runs.append(c1 - c0)
                if c1 == c0:
                    parts.append(torch.zeros((3, bs.M), dtype=torch.int32, device=dev))
                    continue
                oh_r, ng_r, _ = xsk233.recode(scalars[:, lo:hi], dev)
                pl_r = pl[..., c0:c1].contiguous()
                per_rank[r]["point_add"] += 1
                tab_r = held("point_add", lambda: bs.tnaf_table(pl_r, add=msm_kernel.point_add),
                             lambda: plain_table(pl_r), timed=False)
                per_rank[r]["ladder"] += 1
                lad_r = held("ladder", lambda: msm_kernel.ladder(oh_r, ng_r, tab_r),
                             lambda: bs.ladder(oh_r, ng_r, tab_r), timed=False)
                parts.append(bs.fold_sum(lad_r, add=counted_add(per_rank[r])))
            for r in range(R):
                folded = bs.fold_cols(torch.stack(parts, dim=-1), add=counted_add(per_rank[r]))
            whole = xsk233.to_affine_int(xsk233.msm_limbs(scalars, pl, dev))
            if xsk233.to_affine_int(bs.extract_point(folded, 0)) != whole:
                raise AssertionError(f"{R} ranks' partials of the {n}-point MSM fold to another "
                                     f"point than the whole MSM")
        if per_rank != group[R]["launches"]:
            raise AssertionError(f"replayed {per_rank} launches per rank, the {R} ranks made "
                                 f"{group[R]['launches']}")
        log(f"every kernel launch of the {R} ranks' prove equals its plain version on the same "
            f"operands: {json.dumps(per_rank)} per rank (column runs {runs}, each rank also "
            f"folding the {R} partials of each MSM); the folded partials equal the whole MSMs "
            f"({time.perf_counter() - t0:.1f} s)")
    del warm_ops

    # bounds count the doublings these operands ran (profiling build)
    costs = {"ladder": roofline.ladder_cost(C, C, prof["MSM 2^18"]["doubles_run"]),
             "point_add": roofline.point_add_cost(C, add_stats["doubles_run"])}
    kernels = []
    for name, replaces in (("ladder", LADDER_TPU), ("point_add", ADD_TPU)):
        b_s, b_by = roofline.bound(costs[name], clock_mhz)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": compare[name]["max_abs_err"],
            "ms": ms[name], "plain_ms": compare[name]["plain_ms"],
            "bound_ms": 1e3 * b_s, "bound_by": b_by, "library_ms": None,
            "cols": C, "small_ms": compare[name]["small_ms"], "small_cols": C_s + 1,
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
