"""The prover's seconds per proof: the window's wall time, less the
verifier's time in it, over the proofs completed and verified in it."""


def read(run):
    n = sum(run.get("verdicts", []))
    return (run["window_s"] - sum(run["verify_s"])) / n if n else None
