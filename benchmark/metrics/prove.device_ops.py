"""Kernels, copies and sets on the device timeline of one profiled
proof: the dispatch count, most of it the Fr torch ops (ops/fr.py)."""


def read(run):
    prof = run.get("trace", {}).get("profile")
    return prof["device_ops"] if prof and prof["device_ops"] else None
