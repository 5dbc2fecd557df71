"""The port's protocol slice on the CPU: setup -> precompute -> prove on
the toy circuit gives the pinned 944-bit proof TOY_PROOF_HEX of
tests/golden_n16.py (no JAX run), verify accepts it and rejects a
one-bit change, prove refuses a witness that does not satisfy the
circuit, the CLI runs the same path, and artifacts written by the JAX
package read in the port (and back) to equal values.

Tolerance: zero -- bytes, bits and canonical values must be equal.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.protocol import prover, srs
from dvpari_tpu_torch.protocol.proof import Proof, _bits_to_bytes_le
from dvpari_tpu_torch.protocol.transcript import Transcript
from dvpari_tpu_torch.r1cs.toy import toy_r1cs_dump, toy_witness
from dvpari_tpu_torch.storage import artifacts as art
from dvpari_tpu_torch.utils import xsk233_host as host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import golden_n16 as G  # noqa: E402
from e2e_card import flip_a0  # noqa: E402
TOY_SEED = b"dvpari-toy-43"


@pytest.fixture(scope="module")
def toy_cache(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("toy"))
    with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
        f.write(toy_r1cs_dump())
    pub, _ = toy_witness()
    td = srs.Trapdoor.from_seed(TOY_SEED)
    srs.verifier_runs_setup(td, cache, len(pub), True, True, device="cpu")
    prover.prover_prepares_precomputes(cache, True, device="cpu")
    return cache, td


def test_toy_e2e_gives_the_pinned_proof(toy_cache):
    cache, td = toy_cache
    pub, wit = toy_witness()
    proof = prover.prove(cache, pub, wit, device="cpu")
    bits = proof.to_bits()
    assert _bits_to_bytes_le(bits).hex() == G.TOY_PROOF_HEX
    assert Proof.from_bits(bits) == proof
    assert srs.verify(td, pub, proof)
    bad = flip_a0(proof)
    assert bad.a0 != proof.a0 and not srs.verify(td, pub, bad)


def test_setup_over_given_precomputes_without_validation(toy_cache, tmp_path):
    """The CLI's setup --use-precomputes --no-validate (is_fresh_setup=False,
    validate_precompute=False) over the toy cache's domain precomputes,
    then prove without validation: the same pinned proof.  Without the
    precomputes such a setup refuses to run."""
    from dvpari_tpu_torch.__main__ import main

    cache, _ = toy_cache
    given = [art.R1CS_CONSTRAINTS_FILE, art.Z_POLY, art.Z_POLYD, art.BAR_WTS, art.BAR_WTSD]
    given += [t + ".npz" for t in (art.TREE_2N, art.TREE_2ND)]
    for name in given:
        shutil.copy(os.path.join(cache, name), tmp_path / name)
    argv = ["setup", "--cache-dir", str(tmp_path), "--seed", TOY_SEED.decode(),
            "--use-precomputes", "--no-validate", "--device", "cpu"]
    main(argv)
    prover.prover_prepares_precomputes(str(tmp_path), False, device="cpu")
    pub, wit = toy_witness()
    proof = prover.prove(str(tmp_path), pub, wit, device="cpu")
    assert _bits_to_bytes_le(proof.to_bits()).hex() == G.TOY_PROOF_HEX

    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), empty)
    with pytest.raises(AssertionError, match="precomputes missing"):
        main(argv[:2] + [str(empty)] + argv[3:])


def test_transcript_alpha_pinned():
    t = Transcript()
    t.srs_hash()
    t.circuit_info_hash()
    t.witness_commitment_hash([bytes(range(30)), bytes(range(1, 31))])
    t.public_input_hash([1, 2, 3])
    assert t.output() == int(G.ALPHA, 16)


def test_prove_rejects_unsatisfying_witness(toy_cache):
    cache, _ = toy_cache
    pub, wit = toy_witness()
    with pytest.raises(AssertionError, match="does not satisfy"):
        prover.prove(cache, pub, [wit[0] + 1] + wit[1:], device="cpu")
    with pytest.raises(AssertionError, match="does not satisfy"):
        prover.prove(cache, [pub[0] + 1, pub[1]], wit, device="cpu")


def test_cli_e2e_runs_on_cpu_and_defaults_to_cuda(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "dvpari_tpu_torch", "e2e", "--cache-dir", str(tmp_path / "c")]
    out = subprocess.run(cmd + ["--device", "cpu", "--proof-out", str(tmp_path / "p.bits")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "-> True" in out.stdout
    with open(tmp_path / "p.bits", "rb") as f:
        assert f.read().hex() == G.TOY_PROOF_HEX
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
        assert out.returncode != 0 and "torch.cuda.is_available() is false" in out.stderr


def test_artifacts_interchange_with_jax(tmp_path):
    """A toy tree, an Fr vector and a point vector written by the JAX
    package read in the port to equal values; a point vector written by
    the port reads in the JAX package to the same points."""
    import jax.numpy as jnp

    from dvpari_tpu.fftree.tree import FFTree as JFFTree
    from dvpari_tpu.storage import artifacts as jart

    jt = JFFTree.build(32, True, 5)
    jart.write_fftree(str(tmp_path / "tree"), jt)
    tree = art.read_fftree(str(tmp_path / "tree"), device="cpu")
    assert (tree.n, tree.shift_by_one, tree.base_log_n, tree.x0s) == (32, True, 5, jt.x0s)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(tree.layers, jt.layers))
    assert fr.to_int(tree.both_domains()[1]) == fr.to_int(np.asarray(jt.both_domains()[1]))

    rng = np.random.default_rng(4019)
    vals = [int.from_bytes(rng.bytes(29), "little") % fr.P for _ in range(40)]
    jart.write_fr_vec(str(tmp_path / "v"), jnp.asarray(fr.from_int(vals)))
    assert fr.to_int(art.read_fr_vec(str(tmp_path / "v"), device="cpu")) == vals
    art.write_fr_vec(str(tmp_path / "v2"), torch.from_numpy(fr.from_int(vals)))
    assert open(tmp_path / "v2", "rb").read() == open(tmp_path / "v", "rb").read()

    es = [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(40)]
    es[3] = 0  # infinity
    proj, planes = xsk233.mulgen_limbs(fr.from_int(es), device="cpu")
    jart.write_point_vec(str(tmp_path / "pj"), jnp.asarray(proj[..., :40]))
    got = art.read_point_vec_planes(str(tmp_path / "pj"))  # via JAX's .fast.npz
    np.testing.assert_array_equal(got, bs.pack_points(np.asarray(jart.read_point_vec(str(tmp_path / "pj")))))
    points = xsk233.to_affine_int(proj[..., :40])
    assert points[3] is None and points[5] == host.smul(es[5], (host.GX, host.GY))
    assert xsk233.to_affine_int(bs.unpack_points(got)[..., :40]) == points

    art.write_point_vec(str(tmp_path / "pt"), planes, 40)
    recs = open(tmp_path / "pt", "rb").read()
    assert recs == open(tmp_path / "pj", "rb").read()
    assert recs[8:] == b"".join(host.encode(p) for p in points)
    np.testing.assert_array_equal(jart.read_point_vec_planes(str(tmp_path / "pt")), planes.numpy().view(np.uint32))
    os.remove(str(tmp_path / "pt") + ".planes.npz")  # from the records alone
    np.testing.assert_array_equal(
        xsk233.encode_planes(torch.from_numpy(art.read_point_vec_planes(str(tmp_path / "pt")).view(np.int32)), 40),
        np.frombuffer(recs[8:], np.uint8).reshape(40, 30),
    )
