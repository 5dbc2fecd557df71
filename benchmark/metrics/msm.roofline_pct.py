"""The three MSMs' share of their roofline, in %: the least time an H100
could take for MSMs of n + m + 4m points (benchmark/msm_cost.py, no
doubling, at the card's top SM clock) over the device time of every
kernel and copy that started inside the prove.msm_* ranges of one
profiled proof."""

from benchmark import msm_cost

PHASES = ("prove.msm_gm", "prove.msm_gq", "prove.msm_gk")


def read(run):
    t = run.get("trace", {})
    prof, clock = t.get("profile"), t.get("sm_clock_max_mhz")
    if not prof or not clock:
        return None
    device_s = sum(prof["busy_by_phase_s"].get(p, 0.0) for p in PHASES)
    if device_s <= 0:
        return None
    least = sum(msm_cost.bound(msm_cost.msm_work(n), clock)[0] for n in t["msm_points"])
    return 100.0 * least / device_s
