"""A sharded prove on one host, held to the one-device prove.

Counterpart of __graft_entry__.py:dryrun_multichip: a synth_multiterm
circuit of m constraints (3 terms a row, a 64-entry coefficient table,
as the JAX dryrun), one setup into a cache, the one-device proof, then
R spawned ranks proving over one process group.  Every rank's proof
must equal the one-device proof byte for byte, and verify must accept
it.

    python -m dvpari_tpu_torch dryrun --ranks R [R ...] [--m 64] [--device cuda]

`rank_prove` is the body each rank runs; scripts/e2e_card.py spawns it
too.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

DRYRUN_SEED = b"dvpari-dryrun-43"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def proof_hex(proof) -> str:
    from dvpari_tpu_torch.protocol.proof import _bits_to_bytes_le

    return _bits_to_bytes_le(proof.to_bits()).hex()


def rank_prove(group, cache_dir: str, pub, priv, reps: int = 1) -> dict:
    """One rank's part: `reps` proves over the group (the first is the
    process's cold prove).  Returns the rank, the group's backend, the
    proof's hex, each prove's seconds and the kernel launches of the
    last prove."""
    from dvpari_tpu_torch.ops import msm_kernel
    from dvpari_tpu_torch.protocol import prover

    times, hexes = [], set()
    for _ in range(reps):
        msm_kernel.reset_counts()
        _sync(group.device)
        t0 = time.perf_counter()
        proof = prover.prove(cache_dir, pub, priv, group=group)
        _sync(group.device)
        times.append(time.perf_counter() - t0)
        hexes.add(proof_hex(proof))
    if len(hexes) != 1:
        raise AssertionError(f"rank {group.rank}: repeated proves gave {len(hexes)} proofs")
    return {"rank": group.rank, "backend": group.backend, "proof": hexes.pop(),
            "prove_s": times, "launches": {"ladder": msm_kernel.ladder.launches,
                         "point_add": msm_kernel.point_add.launches}}


def dryrun(ranks, m: int = 64, device="cuda", log=print) -> "list[dict]":
    """Setup, the one-device proof, and for each R in `ranks` (one
    setup for all) the R-rank proof of an m-constraint circuit; raises
    unless every rank's proof equals the one-device proof and verifies.
    device "cuda" puts rank r on cuda:r (NCCL); a named device ("cpu",
    "cuda:0") holds every rank (gloo)."""
    from dvpari_tpu_torch.parallel import multihost
    from dvpari_tpu_torch.protocol import prover, srs
    from dvpari_tpu_torch.protocol.proof import Proof, _bytes_to_bits_le
    from dvpari_tpu_torch.r1cs.toy import synth_multiterm
    from dvpari_tpu_torch.storage import artifacts as art

    one_dev = multihost.rank_device(None if device == "cuda" else device)
    rank_dev = None if device == "cuda" else device
    dump, pub, wit = synth_multiterm(m - 2, terms=3, n_coeffs=64)
    td = srs.Trapdoor.from_seed(DRYRUN_SEED)
    outs = []
    with tempfile.TemporaryDirectory(prefix="dvpari_dryrun_") as cache:
        with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
            f.write(dump)
        t0 = time.perf_counter()
        srs.verifier_runs_setup(td, cache, len(pub), True, True, device=one_dev)
        prover.prover_prepares_precomputes(cache, True, device=one_dev)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = proof_hex(prover.prove(cache, pub, wit, device=one_dev))
        t_one = time.perf_counter() - t0
        proof = Proof.from_bits(_bytes_to_bits_le(bytes.fromhex(want))[:944])
        if not srs.verify(td, pub, proof):
            raise AssertionError("verify rejected the one-device proof")
        for R in ranks:
            t0 = time.perf_counter()
            got = multihost.run_ranks(R, rank_prove, (cache, pub, wit), rank_dev)
            t_ranks = time.perf_counter() - t0
            for r in got:
                if r["proof"] != want:
                    raise AssertionError(f"rank {r['rank']} of {R}: proof {r['proof']} != "
                                         f"one-device {want}")
            outs.append({"m": m, "ranks": R, "device": str(one_dev), "setup_s": t_setup,
                         "one_device_prove_s": t_one, "ranks_s": t_ranks,
                         "rank_prove_s": [r["prove_s"][0] for r in got],
                         "launches": [r["launches"] for r in got], "proof": want})
            log(f"dryrun m = {m}, {R} ranks on {outs[-1]['device']}: every rank's proof equals "
                f"the one-device proof, which verifies (setup {t_setup:.1f} s, one-device prove "
                f"{t_one:.1f} s, ranks spawned and proved in {t_ranks:.1f} s)")
    return outs
