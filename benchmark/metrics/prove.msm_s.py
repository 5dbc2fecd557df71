"""Seconds per proof in the three MSMs (ops/xsk233.py: recode, window
table, ladder, folds), fenced, over the traced window's proofs."""

PHASES = ("prove.msm_gm", "prove.msm_gq", "prove.msm_gk")


def read(run):
    runs = run.get("trace", {}).get("prove_phases")
    if not runs or not any(p in r for r in runs for p in PHASES):
        return None
    return sum(r.get(p, 0.0) for r in runs for p in PHASES) / len(runs)
