"""Seconds of NCCL's kernels (ncclDevKernel_*, ncclKernel_*; not the
profiler's "nccl:<collective>" ranges around them) in one profiled proof
on rank 0's card: the union of their intervals on its device timeline (the
all-gathers of the MSMs' partials and of the barycentric sums, the
extend's and the redistribution's all-to-alls, the satisfaction check's
all-reduce).  A collective's kernel runs from the moment rank 0 enters
it until every rank has sent its part, so this includes each
collective's wait for the slowest rank."""


KERNELS = ("ncclDevKernel", "ncclKernel")


def read(run):
    prof = run.get("trace", {}).get("profile")
    spans = sorted((t0, t1) for name, t0, t1 in (prof or {}).get("device_events", [])
                   if name.startswith(KERNELS))
    if not spans:
        return None
    total, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            total, end = total + (t1 - t0), t1
        elif t1 > end:
            total, end = total + (t1 - end), t1
    return total / 1e6
