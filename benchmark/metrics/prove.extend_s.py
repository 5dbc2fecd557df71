"""Seconds per proof in the ECFFT extend of a, b, c, i from D to D'
(fftree/tree.py), fenced, over the traced window's proofs."""

PHASES = ("prove.extend",)


def read(run):
    runs = run.get("trace", {}).get("prove_phases")
    if not runs or not any(p in r for r in runs for p in PHASES):
        return None
    return sum(r.get(p, 0.0) for r in runs for p in PHASES) / len(runs)
