"""Seconds per proof in the R1CS stages (r1cs/gnark.py): the witness
upload, the sparse mat-vec and the satisfaction check, fenced, over the
traced window's proofs."""

PHASES = ("prove.witness", "prove.matvec", "prove.sat_check")


def read(run):
    runs = run.get("trace", {}).get("prove_phases")
    if not runs or not any(p in r for r in runs for p in PHASES):
        return None
    return sum(r.get(p, 0.0) for r in runs for p in PHASES) / len(runs)
