"""Device time of one profiled call, by the program's phase ranges.

The arithmetic of the port's scripts/e2e_card.py:profiled_prove, frozen
here: every kernel and copy on the device timeline is charged to the
phase range (a torch.profiler range named as the program's phase) that
it started in.  Added: the busy time as the union of the device
operations' intervals, and the gaps between them, each named by the
phase the host was in when the gap opened.

`summarize(events, phases)` takes plain tuples, so the arithmetic is
tested without a profiler:
  events: (kind, name, start_us, end_us), kind "device" for a kernel,
  copy or set on the device, "device_range" for a phase range on the
  device timeline, "host_range" for the same range on the host's.
"""

from __future__ import annotations

import bisect

TOP = 10


def from_profiler(prof, phases) -> list:
    """The profiler's events as summarize() takes them.  The profiler's
    own "nccl:<collective>" ranges on the device timeline are left out:
    they wrap NCCL's kernels, which are counted."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cuda and e.key.startswith("nccl:"):
            continue
        if e.device_type == cuda:
            out.append(("device_range" if e.key in phases else "device", e.key, t0, t1))
        elif e.key in phases:
            out.append(("host_range", e.key, t0, t1))
    return out


def _charge(spans, t):
    """The name of the latest-starting span (start, end, name) that holds
    time t, or None; spans sorted by start."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    for t0, t1, name in reversed(spans[: i + 1]):
        if t0 <= t <= t1:
            return name
    return None


def summarize(events, phases) -> dict:
    """busy_s (union of device intervals), device_ops (kernels, copies and
    sets), busy_by_phase_s, top_ops [[name, seconds]] and idle_gaps
    [[host phase, seconds]]."""
    work = sorted((t0, t1, name) for kind, name, t0, t1 in events if kind == "device")
    dranges = sorted((t0, t1, name) for kind, name, t0, t1 in events if kind == "device_range")
    hranges = sorted((t0, t1, name) for kind, name, t0, t1 in events if kind == "host_range")
    by_phase = {p: 0.0 for p in phases}
    by_phase["outside any phase"] = 0.0
    per_op: dict = {}
    for t0, t1, name in work:
        per_op[name] = per_op.get(name, 0.0) + (t1 - t0)
        by_phase[_charge(dranges, t0) or "outside any phase"] += t1 - t0
    busy = 0.0
    gaps = []
    end = None
    for t0, t1, _ in work:
        if end is None:
            busy, end = t1 - t0, t1
        elif t0 > end:
            gaps.append((t0 - end, end))
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    gaps.sort(reverse=True)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "device_ops": len(work),
        "busy_by_phase_s": {k: v / 1e6 for k, v in by_phase.items()},
        "top_ops": [[name, t / 1e6] for name, t in top],
        "idle_gaps": [[_charge(hranges, at) or "outside any phase", g / 1e6]
                      for g, at in gaps[:TOP]],
    }
