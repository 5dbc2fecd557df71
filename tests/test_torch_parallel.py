"""The port's parallel/ on torch.distributed, on the CPU with gloo: ranks
are spawned processes of one world (parallel/multihost.py:run_ranks) on
free local ports; their bodies are in tests/torch_parallel_ranks.py.

* torchrun's environment: a partly set or malformed one raises, an
  empty one leaves the process alone, a full one on the CPU joins a
  gloo world, and without CUDA the default device raises (no fall back
  to the CPU);
* the column and domain runs, and the redistribution between them;
* the sharded MSM at R = 2, 3 and 4 on a ragged n (at R = 3 and 4 the
  last rank's run is empty) equals the one-device msm_limbs and the
  host oracle (sum k_i e_i mod R) * G;
* the sharded extend at R = 1, 2 and 4 on 2^8 leaves equals
  FFTree.extend bit for bit (canonical limbs);
* the column-slice reader of the planes sidecar equals the slice of the
  whole read, also across unaligned segments and for a sidecar rebuilt
  from the records, by one process or by four ranks at once;
* the toy prove over two and three ranks, and over a world of one in
  this process, emits TOY_PROOF_HEX; the m = 64 dryrun (python -m
  dvpari_tpu_torch dryrun) at R = 1, 2 and 4 gives every rank the
  one-device proof, which verifies.

No JAX mesh program is compiled: the sharded path is held to the JAX
package through the JAX-pinned toy proof and the port's one-device
proof (tests/test_torch_e2e_jax.py holds that to a JAX prove).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tests import golden_n16 as G
from tests import torch_parallel_ranks as ranks
from dvpari_tpu_torch import __main__ as cli
from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.parallel import dryrun, mesh, multihost, sharded
from dvpari_tpu_torch.protocol import prover, srs
from dvpari_tpu_torch.r1cs.toy import toy_r1cs_dump, toy_witness
from dvpari_tpu_torch.storage import artifacts as art
from dvpari_tpu_torch.utils import xsk233_host as host

SEED = 7


@pytest.fixture
def clean_env(monkeypatch):
    for k in multihost.ENV:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    multihost.shutdown()


@pytest.mark.parametrize("case", ["empty", "partial", "rank_out_of_range", "full_cpu",
                                  "full_no_cuda"])
def test_torchrun_environment(clean_env, case):
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(multihost.free_port())}
    if case == "rank_out_of_range":
        for k, v in {**env, "RANK": "1"}.items():
            clean_env.setenv(k, v)
        with pytest.raises(ValueError, match="RANK=1 out of range"):
            multihost.maybe_initialize(device="cpu")
        return
    if case == "empty":
        assert multihost.maybe_initialize() is False
        with pytest.raises(RuntimeError, match="not initialised"):
            multihost.group()
        return
    if case == "partial":
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
            clean_env.setenv(k, env[k])
        with pytest.raises(RuntimeError, match="partly set torchrun environment"):
            multihost.maybe_initialize(device="cpu")
        return
    for k, v in env.items():
        clean_env.setenv(k, v)
    if case == "full_no_cuda":
        if torch.cuda.is_available():
            pytest.skip("checks the default device on a host without CUDA")
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.maybe_initialize()
        return
    assert multihost.maybe_initialize(device="cpu") is True
    g = multihost.group()
    assert (g.size, g.rank, g.device, g.backend) == (1, 0, torch.device("cpu"), "gloo")
    assert multihost.process_info() == (0, 1)
    assert multihost.maybe_initialize(device="cpu") is True  # idempotent


@pytest.mark.parametrize("C", [1, 4, 7, 64])
def test_runs_split_every_column_once(C):
    for R in (1, 2, 3, 4, 8):
        runs = [mesh.col_run(C, R, r) for r in range(R)]
        assert runs[0][0] == 0 and runs[-1][1] == C
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(runs, runs[1:]))
        assert all(b - a == -(-C // R) for a, b in runs[:-1] if b < C)
    if C == 4:
        assert [mesh.col_run(4, 3, r) for r in range(3)] == [(0, 2), (2, 4), (4, 4)]
        assert [mesh.point_run(101, 3, r) for r in range(3)] == [(0, 64), (64, 101), (101, 101)]
    if C == 64:
        assert [mesh.dom_run(64, 4, r) for r in (0, 3)] == [(0, 16), (48, 64)]
        with pytest.raises(ValueError):
            mesh.dom_run(64, 3, 0)
        assert sharded.can_shard_domain(64, 4) and sharded.can_shard_domain(64, 8)
        assert not sharded.can_shard_domain(64, 3) and not sharded.can_shard_domain(8, 4)


def test_redistribute_moves_slices_between_ranks():
    """Three ranks holding two pieces each of a 30-entry vector (the
    k-scalars' shape of layout) hand each rank its own run."""
    got = multihost.run_ranks(3, ranks.redistribute, (), device="cpu")
    for (lo, hi), out in zip(ranks.REDISTRIBUTE_WANT, got):
        want = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (fr.NLIMB, hi - lo))
        np.testing.assert_array_equal(out, want)


@pytest.fixture(scope="module")
def msm_operands():
    """101 points e_i G (4 columns, the last ragged) and scalars k_i."""
    rng = np.random.default_rng(SEED)
    es = [int(x) for x in rng.integers(1, 2**62, 101)]
    ks = [int.from_bytes(rng.bytes(29), "little") % fr.P for _ in range(101)]
    _, planes = xsk233.mulgen_limbs(fr.from_int(es), device="cpu")
    want = host.smul(sum(k * e for k, e in zip(ks, es)) % host.R, (host.GX, host.GY))
    return fr.from_int(ks), planes.numpy(), want


@pytest.mark.parametrize("R", [2, 3, 4])
def test_msm_sharded_equals_one_device_and_oracle(msm_operands, R):
    ks, planes, want = msm_operands
    one = xsk233.to_affine_int(xsk233.msm_limbs(ks, torch.from_numpy(planes), device="cpu"))
    got = multihost.run_ranks(R, ranks.msm, (ks, planes), device="cpu")
    assert [run for _, run in got] == [mesh.col_run(4, R, r) for r in range(R)]
    if R == 3:
        assert got[-1][1] == (4, 4)  # the last rank's run is empty
    for point, _ in got:
        assert xsk233.to_affine_int(point) == one == want


@pytest.mark.parametrize("R", [1, 2, 4])
def test_extend_sharded_equals_extend(R):
    tree = FFTree.build(256, False, 8, device="cpu", device_build=False)
    m = 128
    rng = np.random.default_rng(SEED + R)
    vals = [[int.from_bytes(rng.bytes(29), "little") % fr.P for _ in range(m)] for _ in range(2)]
    evals = np.stack([fr.from_int(v) for v in vals], axis=1)  # (20, 2, m): a batch axis
    args = (tree.layers, tree.x0s, tree.shift_by_one, tree.base_log_n)
    moieties = ("S1", "S0")
    runs = multihost.run_ranks(R, ranks.extend, (args, evals, moieties), device="cpu")
    for i, moiety in enumerate(moieties):
        want = fr.strong_normalize(tree.extend(torch.from_numpy(evals), moiety, 0)).numpy()
        np.testing.assert_array_equal(np.concatenate([r[i] for r in runs], axis=-1), want)


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """Three point vector files of 40, 20 and 50 random planes (unaligned
    segments, joined slot by slot) and their whole reads."""
    rng = np.random.default_rng(SEED)
    lens = (40, 20, 50)
    paths = []
    for i, n in enumerate(lens):
        pl = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 233, -(-n // 32)), dtype=np.int64)
                              .astype(np.int32))
        path = str(tmp_path_factory.mktemp("seg") / f"v{i}")
        art.write_point_vec(path, pl, n)
        paths.append(path)
    return paths, lens, [art.read_point_vec_planes(p) for p in paths]


def test_column_slice_reader_equals_slice_of_whole_read(segments):
    paths, _, whole = segments
    for p, w in zip(paths, whole):
        for cols in ((0, 1), (1, w.shape[-1]), (0, 0)):
            np.testing.assert_array_equal(art.read_point_vec_planes_cols(p, cols),
                                          w[:, :, cols[0]:cols[1]])
        dev = art.read_point_vec_planes_device(p, "cpu", cols=(0, 1))
        assert art.read_point_vec_planes_device(p, "cpu", cols=(0, 1)) is dev  # cached
        with pytest.raises(ValueError):
            art.read_point_vec_planes_cols(p, (0, w.shape[-1] + 1))


def test_planes_reader_joins_unaligned_segments(segments):
    paths, lens, whole = segments
    joined = xsk233.concat_planes([(torch.from_numpy(w.view(np.int32)), n)
                                   for w, n in zip(whole, lens)])
    read = art.planes_reader(list(zip(paths, lens)), "cpu")
    for c0, c1 in ((0, 4), (0, 2), (1, 3), (2, 4), (3, 4)):
        assert torch.equal(read(c0, c1), joined[..., c0:c1])


def test_column_slice_reader_rebuilds_a_missing_sidecar(tmp_path):
    """Real points, sidecar deleted: the reader decodes the records,
    writes the sidecar again and returns the same points."""
    _, planes = xsk233.mulgen_limbs(fr.from_int(list(range(1, 41))), device="cpu")
    path = str(tmp_path / "pts")
    art.write_point_vec(path, planes, 40)
    os.remove(path + ".planes.npz")
    got = art.read_point_vec_planes_cols(path, (1, 2))  # affine (Z = 1) from the records
    assert os.path.exists(path + ".planes.npz")
    assert (xsk233.to_affine_int(bs.unpack_points(torch.from_numpy(got.view(np.int32))))
            == xsk233.to_affine_int(bs.unpack_points(planes[..., 1:2])))


def test_ranks_rebuild_a_missing_sidecar_at_once(tmp_path):
    """Four ranks read a sidecar of 2^14 points that rank 0 keeps deleting
    and all of them rebuild: each rank's columns equal the slice of the
    whole read every time, and the sidecar left behind is whole."""
    _, planes = xsk233.mulgen_limbs(fr.from_int(list(range(1, 65))), device="cpu")
    path = str(tmp_path / "pts")
    art.write_point_vec(path, planes.repeat(1, 1, 256), 1 << 14)
    os.remove(path + ".planes.npz")
    whole = art.read_point_vec_planes(path)  # rebuilt from the records: affine planes
    got = multihost.run_ranks(4, ranks.reread_sidecar, (path, 12), device="cpu")
    for r, rounds in enumerate(got):
        c0, c1 = mesh.col_run(512, 4, r)
        for cols in rounds:
            np.testing.assert_array_equal(cols, whole[:, :, c0:c1])
    np.testing.assert_array_equal(art.read_point_vec_planes_cols(path, (0, 512)), whole)
    assert sorted(os.listdir(tmp_path)) == ["pts", "pts.planes.npz"]  # no temporary left


@pytest.fixture(scope="module")
def toy_cache(tmp_path_factory):
    """The toy circuit's setup and precomputes, shared by the toy tests."""
    cache = str(tmp_path_factory.mktemp("toy"))
    with open(os.path.join(cache, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
        f.write(toy_r1cs_dump())
    pub, wit = toy_witness()
    td = srs.Trapdoor.from_seed(b"dvpari-toy-43")
    srs.verifier_runs_setup(td, cache, len(pub), True, True, device="cpu")
    prover.prover_prepares_precomputes(cache, True, device="cpu")
    return cache, pub, wit


@pytest.mark.parametrize("R", [2, 3])
def test_toy_prove_over_ranks_gives_the_pinned_proof(toy_cache, R):
    """R = 2 runs the domain stages on runs of m = 8; R = 3 does not
    divide m, so they run whole and two of the three ranks have empty
    MSM runs."""
    cache, pub, wit = toy_cache
    got = multihost.run_ranks(R, dryrun.rank_prove, (cache, pub, wit), device="cpu")
    assert [r["proof"] for r in got] == [G.TOY_PROOF_HEX] * R


def test_group_prove_in_this_process(toy_cache, clean_env):
    """A world of one joined in this process proves the pinned proof, and
    a device other than the rank's is refused."""
    cache, pub, wit = toy_cache
    g = multihost.initialize(0, 1, "127.0.0.1", multihost.free_port(), "cpu")
    assert dryrun.proof_hex(prover.prove(cache, pub, wit, group=g)) == G.TOY_PROOF_HEX
    with pytest.raises(ValueError, match="not the rank's device"):
        prover.prove(cache, pub, wit, device="cpu:1", group=g)


@pytest.fixture(scope="module")
def dryrun_out():
    """`python -m dvpari_tpu_torch dryrun --ranks 1 2 4 --m 64 --device
    cpu`, run in this process (one setup for the three worlds): its
    printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["dryrun", "--ranks", "1", "2", "4", "--m", "64", "--device", "cpu"])
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("R", [1, 2, 4])
def test_dryrun_m64_matches_one_device_proof(dryrun_out, R):
    """The dryrun raises unless every rank's proof equals the one-device
    proof and verifies; here its report for R ranks is checked."""
    outs = {o["ranks"]: o for o in (json.loads(x) for x in dryrun_out if x.startswith("{"))}
    assert sorted(outs) == [1, 2, 4]
    out = outs[R]
    assert (out["m"], out["device"], len(out["rank_prove_s"])) == (64, "cpu", R)
    assert len({o["proof"] for o in outs.values()}) == 1
    assert any(f"{R} ranks on cpu: every rank's proof equals the one-device proof" in line
               for line in dryrun_out)
