"""Seconds per proof in the prove's Fr stages (ops/fr.py torch ops): the
quotient, the barycentric evaluations at alpha, the k-scalars and the
challenge, fenced, over the traced window's proofs."""

PHASES = ("prove.quotient", "prove.evaluate_at_alpha", "prove.k_scalars", "prove.challenge")


def read(run):
    runs = run.get("trace", {}).get("prove_phases")
    if not runs or not any(p in r for r in runs for p in PHASES):
        return None
    return sum(r.get(p, 0.0) for r in runs for p in PHASES) / len(runs)
