"""Seconds of the set-up's two vanishing polynomials (native.py, the GMP
product tree), fenced."""

PHASES = ("setup.vanishing",)


def read(run):
    phases = run.get("trace", {}).get("setup_phases")
    if not phases or not any(p in phases for p in PHASES):
        return None
    return sum(phases.get(p, 0.0) for p in PHASES)
