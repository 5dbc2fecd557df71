"""Per-phase wall-clock timing of setup and prove.

Counterpart of dvpari_tpu/utils/timing.py.  CUDA work is asynchronous,
so by default a phase's time is the host's: device work it queued is
charged to whichever later phase waits for it first.  With
SYNC_PHASES on (DVPARI_SYNC_PHASES=1, or set by a measuring harness) a
phase on a CUDA device is fenced with torch.cuda.synchronize() at both
ends, so the device work a phase queued is charged to that phase, at
the cost of the overlap between host dispatch and device work across
phase boundaries.  Each phase is also a torch.profiler range of its
name, so a profiled run attributes device time to phases.  Set
DVPARI_TRACE=1 for live stderr lines.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

EVENTS: list = []
SYNC_PHASES = bool(os.environ.get("DVPARI_SYNC_PHASES"))


def _sync(device) -> None:
    if SYNC_PHASES and device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, device=None, **attrs):
    _sync(device)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        EVENTS.append({"phase": name, "seconds": dt, **attrs})
        if os.environ.get("DVPARI_TRACE"):
            print(f"[dvpari] {name}: {dt:.3f}s {attrs}", file=sys.stderr)


def reset() -> None:
    EVENTS.clear()


def summary() -> dict:
    """phase name -> total seconds over the recorded events."""
    out: dict = {}
    for e in EVENTS:
        out[e["phase"]] = out.get(e["phase"], 0.0) + e["seconds"]
    return out
