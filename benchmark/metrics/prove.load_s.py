"""Seconds per proof in the prove's load (storage/artifacts.py, r1cs/
gnark.py): z_poly and the 2m-leaf tree read, the R1CS parsed and its
Vandermonde splice, fenced, over the traced window's proofs.  A drive
that drops the program's caches before each proof pays it on every one
(drives/cold_cache.py)."""

PHASES = ("prove.load_tree",)


def read(run):
    runs = run.get("trace", {}).get("prove_phases")
    if not runs or not any(p in r for r in runs for p in PHASES):
        return None
    return sum(r.get(p, 0.0) for r in runs for p in PHASES) / len(runs)
