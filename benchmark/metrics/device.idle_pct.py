"""Share of a proof in which the device is idle: 1 - (device busy time
of one profiled proof) / (mean wall time of the traced window's
unprofiled proofs), in %."""


def read(run):
    t = run.get("trace", {})
    prof, walls = t.get("profile"), t.get("prove_s")
    if not prof or not walls or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / (sum(walls) / len(walls)))
