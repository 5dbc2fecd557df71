"""What decides `correct`: the plain reference against the program at a
CPU size, the control, and a whole run with the timed path broken
underneath (the harness's look for a card skipped)."""

import pytest

from benchmark import harness
from benchmark.reference.domain import Domain
from benchmark.reference.prover import expected_proof
from benchmark.tests import tiny

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, **kw):
    return harness.run_cell(root, tiny.CELL, SEED, 0.5, False, device="cpu", **kw)


def test_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert list(out["checks"]) == ["proofs_mismatched", "verify_rejected", "tampered_accepted",
                                   "proofs_failed"]
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_the_comparison(root, seed):
    """The reference in the program's place, with alpha drawn before the
    commitment, through the harness's own run: every proof differs from
    the reference's, the program's verifier rejects it, and the run is
    not correct."""
    from benchmark import control

    out = control.control_run(root, tiny.CELL, seed, 0.5, device="cpu")
    assert not out["correct"], out["checks"]
    n = out["attempted"] + 1  # the window's proves and set-up's cold prove
    assert out["checks"]["proofs_mismatched"]["value"] == n, out["checks"]
    assert out["checks"]["verify_rejected"]["value"] == n, out["checks"]


def test_control_proofs_share_the_commitment_only(root):
    """The control departs from the reference at alpha and after it."""
    cell = harness.load_cell(root, tiny.CELL)
    inp = harness.make_inputs(cell, SEED)
    dom = Domain(inp["circuit"].m)
    for vals in inp["pool"]:
        want = expected_proof(dom, inp["circuit"], vals, inp["trapdoor"])
        ctl = expected_proof(dom, inp["circuit"], vals, inp["trapdoor"], bind_challenge=False)
        assert ctl.commit_p == want.commit_p and ctl != want


def test_limbs_round_trip(root):
    inp = harness.make_inputs(harness.load_cell(root, tiny.CELL), SEED)
    for vals in inp["pool"]:
        assert harness.unlimbs(harness.limbs(vals[3:])) == vals[3:]


def _stale(monkeypatch):
    """A prove that returns its first proof unchanged ever after."""
    from dvpari_tpu_torch.protocol import prover

    real, kept = prover.prove, []

    def prove(*a, **k):
        if not kept:
            kept.append(real(*a, **k))
        return kept[0]

    monkeypatch.setattr(prover, "prove", prove)


def _half_batch(monkeypatch):
    """Every MSM over the first half of its points only."""
    from dvpari_tpu_torch.ops import xsk233

    real = xsk233.msm_limbs

    def msm(scalars, planes, device="cuda"):
        s = scalars.clone()
        s[:, s.shape[1] // 2:] = 0
        return real(s, planes, device)

    monkeypatch.setattr(xsk233, "msm_limbs", msm)


def _altered(monkeypatch):
    """a0 of every proof with its lowest bit flipped where the proof is
    made."""
    from dvpari_tpu_torch.protocol import prover

    real = prover.Proof

    def proof(**kw):
        return real(**dict(kw, a0=kw["a0"] ^ 1))

    monkeypatch.setattr(prover, "Proof", proof)


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(root)
    assert not out["correct"], out["checks"]
    assert out["checks"]["proofs_mismatched"]["value"] > 0


@pytest.mark.card
def test_cell_is_correct_on_the_card(card, tmp_path):
    """A short run of the first cell on the card (python -m pytest
    benchmark/tests -m card, from the repository's root)."""
    out = harness.run_cell(tiny.REPO, "sp1shape_m16.prove_loop", SEED, 2.0, False)
    assert out["correct"], out["checks"]
