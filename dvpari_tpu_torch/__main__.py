"""Command-line entry points of the PyTorch/CUDA port:

    python -m dvpari_tpu_torch e2e --cache-dir DIR [--device cpu]
    python -m dvpari_tpu_torch setup --cache-dir DIR --seed S
    python -m dvpari_tpu_torch prove --cache-dir DIR --witness-file W
    python -m dvpari_tpu_torch verify --seed S --proof P --public-input X ...
    python -m dvpari_tpu_torch dryrun --ranks R [R ...] [--m 64]

Counterpart of dvpari_tpu/__main__.py: e2e drives the toy circuit
through setup -> precompute -> prove -> verify.  --device defaults to
cuda and fails without it; pass --device cpu for the plain path.

Under torchrun (`torchrun --nproc-per-node N -m dvpari_tpu_torch prove
...`) every command first joins the process group that torchrun's
environment describes (parallel/multihost.py:maybe_initialize; rank r
on cuda:LOCAL_RANK, or on the CPU with --device cpu); `prove` then
proves over the group and rank 0 alone writes the proof file.  dryrun
spawns its own ranks (parallel/dryrun.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def toy_e2e(cache_dir: str, seed: bytes, device="cuda", log=print):
    """The toy circuit through setup -> precompute -> prove -> verify in
    `cache_dir`, each step's time logged.  Returns (trapdoor, public
    inputs, proof, verify's verdict)."""
    from dvpari_tpu_torch.protocol import prover as prover_mod
    from dvpari_tpu_torch.protocol import srs as srs_mod
    from dvpari_tpu_torch.r1cs.toy import toy_r1cs_dump, toy_witness
    from dvpari_tpu_torch.storage import artifacts as art

    os.makedirs(cache_dir, exist_ok=True)
    r1cs_path = os.path.join(cache_dir, art.R1CS_CONSTRAINTS_FILE)
    if not os.path.exists(r1cs_path):
        with open(r1cs_path, "wb") as f:
            f.write(toy_r1cs_dump())
    pub, wit = toy_witness()
    td = srs_mod.Trapdoor.from_seed(seed)
    t0 = time.time()
    srs_mod.verifier_runs_setup(td, cache_dir, len(pub), True, True, device=device)
    log(f"setup: {time.time()-t0:.1f}s")
    t0 = time.time()
    prover_mod.prover_prepares_precomputes(cache_dir, True, device=device)
    log(f"precompute: {time.time()-t0:.1f}s")
    t0 = time.time()
    proof = prover_mod.prove(cache_dir, pub, wit, device=device)
    log(f"prove: {time.time()-t0:.1f}s")
    t0 = time.time()
    ok = srs_mod.verify(td, pub, proof)
    log(f"verify: {time.time()-t0:.1f}s -> {ok}")
    return td, pub, proof, ok


def _cmd_e2e(args):
    _, _, proof, ok = toy_e2e(args.cache_dir, args.seed.encode(), args.device)
    if args.proof_out:
        _write_proof(args.proof_out, proof)
    sys.exit(0 if ok else 1)


def _write_proof(path, proof):
    from dvpari_tpu_torch.protocol.proof import _bits_to_bytes_le

    bits = proof.to_bits()
    with open(path, "wb") as f:
        f.write(_bits_to_bytes_le(bits))
    print(f"proof ({len(bits)} bits) -> {path}")


def _read_proof(path):
    from dvpari_tpu_torch.protocol.proof import Proof, _bytes_to_bits_le

    with open(path, "rb") as f:
        return Proof.from_bits(_bytes_to_bits_le(f.read())[:944])


def _cmd_setup(args):
    from dvpari_tpu_torch.protocol import srs as srs_mod

    td = srs_mod.Trapdoor.from_seed(args.seed.encode())
    t0 = time.time()
    srs_mod.verifier_runs_setup(
        td, args.cache_dir, args.public_inputs,
        not args.use_precomputes, not args.no_validate, device=args.device,
    )
    print(f"setup complete in {time.time()-t0:.1f}s (cache: {args.cache_dir})")


def _rank_device(args):
    """The device of a torchrun rank: cuda:LOCAL_RANK (None) for --device
    cuda, else the device named (verify, which has none: the CPU)."""
    device = getattr(args, "device", "cpu")
    return None if device == "cuda" else device


def _cmd_prove(args):
    import torch

    from dvpari_tpu_torch.ops import fr
    from dvpari_tpu_torch.parallel import multihost
    from dvpari_tpu_torch.protocol import prover as prover_mod
    from dvpari_tpu_torch.r1cs import gnark

    with open(args.witness_file, "rb") as f:
        wit = gnark.load_witness_limbs(f.read())
    head = fr.to_int(wit[:, : 1 + args.public_inputs])
    assert head[0] == 1, "witness must start with the constant-1 wire"
    pub = head[1:]
    priv = wit[:, 1 + args.public_inputs :]  # stays as limbs
    group = multihost.group() if multihost.maybe_initialize() else None
    dev = args.device if group is None else group.device
    if group is None or group.rank == 0:
        prover_mod.prover_prepares_precomputes(args.cache_dir, not args.no_validate, device=dev)
    if group is not None:
        torch.distributed.barrier(group=group.pg)
    t0 = time.time()
    proof = prover_mod.prove(args.cache_dir, pub, priv, device=dev, group=group)
    where = "" if group is None else f" (rank {group.rank} of {group.size})"
    print(f"prove: {time.time()-t0:.1f}s{where}")
    if group is None or group.rank == 0:
        _write_proof(args.proof_out, proof)


def _cmd_verify(args):
    from dvpari_tpu_torch.protocol import srs as srs_mod

    td = srs_mod.Trapdoor.from_seed(args.seed.encode())
    proof = _read_proof(args.proof)
    pub = [int(x) for x in args.public_input]
    ok = srs_mod.verify(td, pub, proof)
    print(json.dumps({"valid": bool(ok)}))
    sys.exit(0 if ok else 1)


def _cmd_dryrun(args):
    from dvpari_tpu_torch.parallel import dryrun

    for out in dryrun.dryrun(args.ranks, args.m, args.device):
        print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="dvpari_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def with_device(sp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; fails without it) or cpu")
        return sp

    e2e = with_device(sub.add_parser("e2e", help="toy-circuit end-to-end round trip"))
    e2e.add_argument("--cache-dir", required=True)
    e2e.add_argument("--seed", default="dvpari-toy-43")
    e2e.add_argument("--proof-out", default=None)
    e2e.set_defaults(fn=_cmd_e2e)

    st = with_device(sub.add_parser("setup", help="verifier-side SRS setup"))
    st.add_argument("--cache-dir", required=True)
    st.add_argument("--seed", required=True, help="trapdoor seed (keep secret)")
    st.add_argument("--public-inputs", type=int, default=2)
    st.add_argument("--use-precomputes", action="store_true",
                    help="expect downloaded domain precomputes (is_fresh_setup=False)")
    st.add_argument("--no-validate", action="store_true")
    st.set_defaults(fn=_cmd_setup)

    pr = with_device(sub.add_parser("prove", help="generate a proof from a witness file"))
    pr.add_argument("--cache-dir", required=True)
    pr.add_argument("--witness-file", required=True)
    pr.add_argument("--public-inputs", type=int, default=2)
    pr.add_argument("--proof-out", default="proof.bits")
    pr.add_argument("--no-validate", action="store_true")
    pr.set_defaults(fn=_cmd_prove)

    vf = sub.add_parser("verify", help="designated-verifier check")
    vf.add_argument("--seed", required=True)
    vf.add_argument("--proof", required=True)
    vf.add_argument("--public-input", nargs="+", required=True)
    vf.set_defaults(fn=_cmd_verify)

    dr = sub.add_parser("dryrun", help="R spawned ranks prove an m-constraint circuit; "
                        "the proof must equal the one-device proof and verify")
    dr.add_argument("--ranks", type=int, nargs="+", required=True,
                    help="world sizes to run, one setup for all")
    dr.add_argument("--m", type=int, default=64, help="constraints, a power of two")
    dr.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r over NCCL, the default), or one device "
                         "for every rank over gloo: cpu, or a card such as cuda:0")
    dr.set_defaults(fn=_cmd_dryrun)

    args = p.parse_args(argv)
    if args.cmd == "dryrun":  # dryrun spawns a world of its own
        args.fn(args)
        return
    # torchrun's environment joins the command to its group; with none of
    # it set this does nothing
    from dvpari_tpu_torch.parallel import multihost

    if not multihost.maybe_initialize(_rank_device(args)):
        args.fn(args)
        return
    try:
        if args.cmd != "prove" and multihost.group().size > 1:
            raise SystemExit(f"{args.cmd} runs in one process; only prove runs over ranks")
        args.fn(args)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
