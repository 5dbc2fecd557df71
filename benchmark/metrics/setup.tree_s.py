"""Seconds of the set-up's two FFTree builds of 2m leaves
(fftree/device_build.py, K8), fenced."""

PHASES = ("setup.tree",)


def read(run):
    phases = run.get("trace", {}).get("setup_phases")
    if not phases or not any(p in phases for p in PHASES):
        return None
    return sum(phases.get(p, 0.0) for p in PHASES)
