"""Seconds of the set-up's five SRS fan-outs (ops/xsk233.py:mulgen_limbs,
with the m-value accumulation and the record writes), fenced."""

PHASES = ("setup.g_m", "setup.g_q", "setup.g_k")


def read(run):
    phases = run.get("trace", {}).get("setup_phases")
    if not phases or not any(p in phases for p in PHASES):
        return None
    return sum(phases.get(p, 0.0) for p in PHASES)
