"""The rank route: a cell whose configuration states two ranks, proved
by two processes of one gloo world on the CPU (benchmark/ranks.py), and
held to the same check as the one-process route."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.ranks import Ranks
from benchmark.tests import tiny

SEED = 2**31 + 1013


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("ranks"))


def flip_a0_on_rank_1(cache_dir, public_inputs, private_inputs, device=None, group=None):
    """The program's prove, with a0's lowest bit flipped on rank 1 only."""
    from dvpari_tpu_torch.protocol import prover
    from dvpari_tpu_torch.protocol.proof import Proof

    p = prover.prove(cache_dir, public_inputs, private_inputs, device=device, group=group)
    return Proof(p.commit_p, p.kzg_k, p.a0 ^ 1, p.b0) if group.rank == 1 else p


def without_all_gather(cache_dir, public_inputs, private_inputs, device=None, group=None):
    """The program's prove with the exchange between ranks left out where
    it gathers: each rank takes its own part for every rank's."""
    from dvpari_tpu_torch.parallel import mesh
    from dvpari_tpu_torch.protocol import prover

    mesh.all_gather = lambda t, g: [t.to(g.device)] * g.size
    return prover.prove(cache_dir, public_inputs, private_inputs, device=device, group=group)


_calls = []


def raise_on_rank_1s_second_call(cache_dir, public_inputs, private_inputs, device=None,
                                 group=None):
    """Rank r's (r, calls so far in this process), after a collective;
    rank 1 raises on its second call, so rank 0 waits for it."""
    from dvpari_tpu_torch.parallel import mesh

    _calls.append(public_inputs)
    if group.rank == 1 and len(_calls) == 2:
        raise RuntimeError("planted")
    mesh.all_true(True, group)
    return group.rank, len(_calls)


def test_a_rank_that_raises_fails_this_prove_and_every_later_one(tmp_path):
    pool = Ranks(2, "cpu")
    try:
        pool.join(str(tmp_path), [0], [0], raise_on_rank_1s_second_call, False)
        assert [o["proof"] for o in pool.prove(0)] == [(0, 1), (1, 1)]
        with pytest.raises(RuntimeError, match="planted"):
            pool.prove(0)
        assert pool.pids == []
        with pytest.raises(RuntimeError, match="failed earlier"):
            pool.prove(0)
    finally:
        pool.close()
    assert pool.pids == []


def import_a_forbidden_module_on_rank_1(cache_dir, public_inputs, private_inputs, device=None,
                                        group=None):
    """The program's prove, with a module named as the JAX package's
    parts planted in rank 1's sys.modules."""
    import types

    from dvpari_tpu_torch.protocol import prover

    if group.rank == 1:
        sys.modules.setdefault("flax", types.ModuleType("flax"))
    return prover.prove(cache_dir, public_inputs, private_inputs, device=device, group=group)


def test_a_rank_that_holds_a_forbidden_module_refuses_the_run(root):
    with pytest.raises(harness.ForbiddenModules, match="flax"):
        harness.run_cell(root, tiny.RANKED_CELL, SEED, 0.5, False, device="cpu",
                         prove=import_a_forbidden_module_on_rank_1)


def test_rank0_points_is_the_programs_split():
    from dvpari_tpu_torch.parallel import mesh

    for n in (1, 31, 32, 33, 65538, 65536, 262144, 524290, 4 * 524288):
        for R in (1, 2, 3, 4):
            lo, hi = mesh.point_run(n, R, 0)
            assert harness.rank0_points(n, R) == hi - lo, (n, R)


def test_collective_reader_takes_the_union_of_nccl_kernels(root):
    read = harness.load_cell(root, tiny.RANKED_CELL)["readers"]["prove.collective_s"][1]
    ev = [("ncclDevKernel_AllGather_RING_LL(x)", 10, 30), ("nccl:all_gather", 5, 40),
          ("ncclDevKernel_SendRecv(x)", 25, 50), ("ladder_kernel", 0, 100),
          ("ncclKernel_AllReduce(x)", 70, 80)]
    assert read({"trace": {"profile": {"device_events": ev}}}) == pytest.approx(50e-6)
    assert read({"trace": {"profile": {"device_events": ev[3:4]}}}) is None
    assert read({}) is None


def test_rank_route_is_correct_and_reads_like_one_process(root):
    one = harness.run_cell(root, tiny.CELL, SEED, 0.5, False, device="cpu")
    two = harness.run_cell(root, tiny.RANKED_CELL, SEED, 0.5, False, device="cpu")
    assert one["correct"] and two["correct"], (one["checks"], two["checks"])
    assert all(c["value"] == 0 for c in two["checks"].values())
    assert list(two) == list(one) and list(two["checks"]) == list(one["checks"])
    assert list(two["metrics"]) == list(one["metrics"])
    assert list(two["device"]) == list(one["device"])
    assert two["device"]["count"] == 2 and len(two["device"]["memory_peak_bytes_by_rank"]) == 2


@pytest.mark.parametrize("fault", [flip_a0_on_rank_1, without_all_gather])
def test_a_fault_in_the_ranks_is_not_correct(root, fault):
    """Rank 1 alone returns a wrong proof, or no rank sees the others'
    parts: every such proof is a mismatch."""
    out = harness.run_cell(root, tiny.RANKED_CELL, SEED, 0.5, False, device="cpu", prove=fault)
    assert not out["correct"], out["checks"]
    proves = out["attempted"] + 1  # the window's and the cold one
    wrong = proves if fault is flip_a0_on_rank_1 else 2 * proves
    assert out["checks"]["proofs_mismatched"]["value"] == wrong, out["checks"]


def test_the_control_reaches_every_rank(root):
    from benchmark import control

    out = control.control_run(root, tiny.RANKED_CELL, SEED, 0.5, device="cpu")
    assert not out["correct"], out["checks"]
    proofs = 2 * (out["attempted"] + 1)
    assert out["checks"]["proofs_mismatched"]["value"] == proofs, out["checks"]


def test_a_cell_whose_chips_differ_from_its_ranks_is_refused(root, tmp_path):
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for w in bench["workloads"]:
        if w["name"] == tiny.RANKED_CELL:
            w["chips"] = 1
    path = tmp_path / "BENCHMARK.json"
    json.dump(bench, open(path, "w"))
    os.symlink(os.path.join(root, "benchmark"), tmp_path / "benchmark")
    with pytest.raises(ValueError, match="rank"):
        harness.load_cell(str(tmp_path), tiny.RANKED_CELL)


def _ended(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_ranks_end_when_their_parent_leaves(tmp_path):
    """A parent that started its ranks and joined them into a world, then
    left by os._exit (as a process ended at a run's limit never reaches
    its clean-up), leaves no rank alive after 10 s."""
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {tiny.REPO!r})\n"
        "from benchmark.ranks import Ranks\n"
        "from dvpari_tpu_torch.protocol import prover\n"
        "pool = Ranks(2, 'cpu')\n"
        "pool.start()\n"
        f"pool.join({str(tmp_path)!r}, [], [], prover.prove, False)\n"
        "print(' '.join(map(str, pool.pids)), flush=True)\n"
        "os._exit(0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=tiny.REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    pids = [int(p) for p in r.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    while not all(_ended(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert all(_ended(p) for p in pids), [p for p in pids if not _ended(p)]


@pytest.mark.card
def test_four_rank_cell_is_correct_on_four_cards(card):
    """A 2 s run of the four-card cell (python -m pytest benchmark/tests
    -m card, from the repository's root, on a machine with four cards)."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA cards, torch sees {torch.cuda.device_count()}")
    out = harness.run_cell(tiny.REPO, "sp1shape_m19x4.prove_loop", SEED, 2.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
