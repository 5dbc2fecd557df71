#!/usr/bin/env python3
"""Time versions of the ladder kernel against each other on one GPU, in turns.

    python3 scripts/ladder_turns.py NAME=path/to/bs_ladder.cu [NAME=...]

Each source is a version of dvpari_tpu_torch/csrc/bs_ladder.cu with the
same C interface (for example an earlier commit's copy, written into the
gitignored build directory).  All are built at once, each also with
phase clocks (-DBS_PHASE_CLOCKS) where its source has them.  The
operands are made from a seed at the 2^18-point cells' width (8192
columns): the MSM's (per-column window table), the fan-out's (G's shared
table) and the crafted doubling operands (msm_kernel.doubling_operands).
Every version's output must equal the plain ladder's on each, bit for
bit, and its point add the plain add's on the table build's operands.
Then each version's ladder and point-add launches are timed with CUDA
events in turns, v1 .. vn vn .. v1, for REPS rounds.  The last line is
one JSON object: the median per version and operand set, the card's
name and power limit, the phase cycles per column-window and doublings
run of the clocked builds, the ptxas report and the resident blocks per
SM.
"""

import json
import os
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 1 << 18
REPS = 3
SEED = 7


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    from dvpari_tpu_torch.ops import fr, msm_kernel, xsk233
    from dvpari_tpu_torch.ops import xsk233_bs as bs
    from dvpari_tpu_torch.utils import roofline
    from dvpari_tpu_torch.utils import xsk233_host as host

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    versions = dict(a.split("=", 1) for a in argv)
    clocked = {k for k, src in versions.items() if "BS_PHASE_CLOCKS" in open(src).read()}

    jobs = [(k, ()) for k in versions] + [(k, msm_kernel.PROFILE_DEFINES) for k in clocked]
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {job: ex.submit(msm_kernel.library, versions[job[0]], job[1]) for job in jobs}
        libs = {job: f.result() for job, f in futs.items()}
    report = {"card": card, "versions": {}}
    for k in versions:
        so = msm_kernel.build(versions[k])
        rec = report["versions"][k] = {
            "source": os.path.relpath(versions[k], ROOT),
            "ptxas": [ln.strip() for ln in msm_kernel.build_logs.get(so, "").splitlines()
                      if "registers" in ln or "spill" in ln or "smem" in ln],
        }
        if hasattr(libs[(k, ())], "bs_occupancy"):
            rec["blocks_per_sm"] = msm_kernel.occupancy(libs[(k, ())])

    dev = torch.device("cuda")
    rng = random.Random(SEED)
    es = fr.from_int([rng.randrange(1, host.R) for _ in range(N)])
    ks = fr.from_int([rng.randrange(1, host.R) for _ in range(N)])
    gtab = xsk233.gen_table_planes(dev)
    oh_e, ng_e, C = xsk233.recode(es, dev)
    planes = msm_kernel.mulgen_packed(oh_e, ng_e, gtab)
    oh, ng, _ = xsk233.recode(ks, dev)
    table = bs.tnaf_table(planes, add=msm_kernel.point_add)
    crafted = msm_kernel.doubling_operands(table, [0, 32 * (C // 8) + 7, 32 * C - 1], SEED)
    operands = {"msm": (oh, ng, table), "fanout": (oh_e, ng_e, gtab), "crafted": crafted}
    doubles_in = {"msm": 0, "fanout": 0, "crafted": 3}

    for name, ops in operands.items():
        want = bs.ladder(*ops)
        for k in versions:
            got = msm_kernel.launch_ladder(libs[(k, ())], *ops)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"version {k} != plain ladder on the {name} operands")
            if k in clocked:
                _, st = msm_kernel.profile_ladder(*ops, source=versions[k])
                report["versions"][k].setdefault("phases", {})[name] = {
                    "cycles_per_column_window": {
                        p: c / st["windows"] for p, c in st["cycles"].items()},
                    "doubles_run": st["doubles_run"], "doubles_needed": st["doubles_needed"],
                }
        del want
    p_add, q_add = table[5], table[6]  # one 8192-column add of the table build
    want = bs.add(p_add, q_add)
    for k in versions:
        if not torch.equal(msm_kernel.launch_point_add(libs[(k, ())], p_add, q_add), want):
            raise AssertionError(f"version {k}'s point add != plain add")
    del want
    print("every version equals the plain ladder and add on every operand set", flush=True)

    order = list(versions) + list(reversed(versions))
    launches = {name: (lambda lib, ops=ops: msm_kernel.launch_ladder(lib, *ops))
                for name, ops in operands.items()}
    launches["point_add"] = lambda lib: msm_kernel.launch_point_add(lib, p_add, q_add)
    samples = {(k, n): [] for k in versions for n in launches}
    for _ in range(REPS):
        for name, launch in launches.items():
            for k in order:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch(libs[(k, ())])
                b.record()
                b.synchronize()
                samples[(k, name)].append(a.elapsed_time(b))
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    for name, ops in operands.items():
        tcols = ops[2].shape[-1]
        bound_s = roofline.bound(roofline.ladder_cost(C, tcols, doubles_in[name]), clock_mhz)[0]
        report.setdefault("bound_ms", {})[name] = 1e3 * bound_s
    report["bound_ms"]["point_add"] = 1e3 * roofline.bound(roofline.point_add_cost(C), clock_mhz)[0]
    for name in launches:
        for k in versions:
            report["versions"][k].setdefault("ms", {})[name] = float(np.median(samples[(k, name)]))
            report["versions"][k].setdefault("samples_ms", {})[name] = samples[(k, name)]
    report["max_sm_clock_mhz"] = clock_mhz
    report["order"] = order
    line = json.dumps(report)
    for k in versions:
        rec = report["versions"][k]
        print(f"{k}: " + ", ".join(f"{n} {rec['ms'][n]:.3f} ms" for n in launches)
              + f" (bound {report['bound_ms']['msm']:.3f} ms) [{card}]", flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
