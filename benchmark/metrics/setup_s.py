"""Set-up: from the process's start to the window's (the verifier's SRS
setup for the circuit, the prover's precomputes, the circuit and its
witnesses, CUDA's start, one cold prove and its verify)."""


def read(run):
    return run.get("setup_s")
