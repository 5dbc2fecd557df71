"""Seconds of the set-up's ECFFT enters and tables (fftree/tree.py): the
vanishing check, the barycentric weights, the Lagrange bases at tau and
the vanishing inverses, fenced."""

PHASES = ("setup.validate_z", "setup.barycentric", "setup.lagrange", "setup.z_inv")


def read(run):
    phases = run.get("trace", {}).get("setup_phases")
    if not phases or not any(p in phases for p in PHASES):
        return None
    return sum(phases.get(p, 0.0) for p in PHASES)
