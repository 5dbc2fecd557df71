"""Seconds of the cold prove's load (storage/artifacts.py): the tree, the
parsed R1CS and its Vandermonde splice, fenced."""

PHASES = ("prove.load_tree",)


def read(run):
    phases = run.get("trace", {}).get("cold_phases")
    if not phases or not any(p in phases for p in PHASES):
        return None
    return sum(phases.get(p, 0.0) for p in PHASES)
