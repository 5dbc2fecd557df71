"""One prover in a closed loop: it asks for the next proof as soon as
the last one is made and verified, for `seconds`.

The traffic's parameter: `witness_pool`, the number of witnesses of the
loaded circuit (made by the harness from the seed), proved round robin.

`run` returns the window's record: its wall time, each proof's and each
verify's seconds on the host's clock, each verdict, and the proves
attempted and failed (a prove that raises is counted, and the loop goes
on).
"""

from __future__ import annotations

import time


def requests(n: int):
    """The pool indices in the order the prover asks for them, endless."""
    while True:
        yield from range(n)


def run(window, traffic: dict, seconds: float) -> dict:
    """Drive `window` (n, log, prove(j), verify(j, proof), sync())
    for `seconds`."""
    order = requests(window.n)
    prove_s, verify_s, verdicts = [], [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        j = next(order)
        attempted += 1
        ta = time.perf_counter()
        try:
            proof = window.prove(j)
        except Exception as e:  # counted as failed; the check reads it
            window.log(f"prove {attempted} failed: {type(e).__name__}: {e}")
            failed += 1
            continue
        tb = time.perf_counter()
        ok = window.verify(j, proof)
        prove_s.append(tb - ta)
        verify_s.append(time.perf_counter() - tb)
        verdicts.append(ok)
    window.sync()
    return {"window_s": time.perf_counter() - t0, "prove_s": prove_s, "verify_s": verify_s,
            "verdicts": verdicts, "attempted": attempted, "failed": failed}
