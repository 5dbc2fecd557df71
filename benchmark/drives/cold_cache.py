"""The closed loop of drives/closed_loop.py with every proof cold, as
upstream's Proof::prove is: before each proof it asks for, the drive
drops what the program keeps in this process between proofs, and drops
it once more when the window closes, so that the traced run's profiled
proof, the next, is cold too.  So each prove reads z_poly and the
2m-leaf tree from the set-up's cache directory again, parses the R1CS
and splices in its public inputs, and reads the SRS planes and puts them
on the card.  The cache's files sit in the page cache, since set-up has
just written them.

It drops the caches of this process only, so it refuses a run whose
proofs are made in processes of their own (a cell over ranks).

The traffic's parameter: `witness_pool`, as in closed_loop.
"""

from __future__ import annotations

import multiprocessing
from types import SimpleNamespace

from benchmark.drives import closed_loop


def drop_caches() -> None:
    """Drop the program's per-circuit context (protocol/prover.py:
    _ctx_cache: z_poly, the tree, the parsed and spliced R1CS) and its
    SRS planes on the device (storage/artifacts.py:_PLANES_DEVICE_CACHE).
    A cache that is renamed raises here, so the run fails rather than
    reading warm."""
    from dvpari_tpu_torch.protocol import prover
    from dvpari_tpu_torch.storage import artifacts

    prover._ctx_cache.clear()
    artifacts._PLANES_DEVICE_CACHE.clear()


def run(window, traffic: dict, seconds: float) -> dict:
    """closed_loop.run over `window`, each prove preceded by drop_caches()."""
    if multiprocessing.active_children():
        raise RuntimeError("cold_cache drops the caches of this process: its proofs have to be "
                           "made here, not in the run's rank processes")
    drop_caches()  # before the loop, which counts a failing prove and goes on: a rename raises

    def prove(j):
        drop_caches()
        return window.prove(j)

    rec = closed_loop.run(SimpleNamespace(**{**vars(window), "prove": prove}), traffic, seconds)
    drop_caches()
    return rec
