"""The verifier's milliseconds per proof: each srs.verify of the
window's accepted proofs, timed once on the host's clock, over their
count."""


def read(run):
    ok = [t for t, v in zip(run.get("verify_s", []), run.get("verdicts", [])) if v]
    return 1e3 * sum(ok) / len(ok) if ok else None
