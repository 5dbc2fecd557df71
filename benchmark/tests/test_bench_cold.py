"""The cold-cache drive (drives/cold_cache.py): every proof of its window
reads the set-up's cache again, the check still decides `correct`, and
its traced run reads the cell's per-layer metrics."""

import json
import os

import pytest

from benchmark import harness
from benchmark.tests import test_bench_correctness as faults
from benchmark.tests import tiny

SEED = 2**31 + 4099
COLD_CELL = tiny.TINY + ".cold_cache"


def make_root(tmp) -> str:
    """tiny.make_root with one more cell: the tiny circuit under the
    cold_cache traffic, in the per-layer metrics that list a cold cell."""
    root = tiny.make_root(tmp)
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": COLD_CELL, "config": tiny.TINY, "traffic": "cold_cache",
                               "chips": 1, "why": "CPU test size"})
    for metric in bench["per_layer"]:
        if any(c.endswith(".cold_cache") for c in metric["workloads"]):
            metric["workloads"].append(COLD_CELL)
    json.dump(bench, open(path, "w"))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("cold"))


def _counted(monkeypatch):
    """Counts of the program's R1CS parses and SRS plane uploads."""
    from dvpari_tpu_torch import convert
    from dvpari_tpu_torch.r1cs import gnark

    n = {"parse": 0, "upload": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            n[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    wrap(gnark, "instance_from_dump", "parse")
    wrap(convert, "planes_from_numpy", "upload")
    return n


@pytest.mark.parametrize("cell, trace", [(tiny.CELL, False), (COLD_CELL, False),
                                         (COLD_CELL, True)])
def test_every_proof_of_the_window_reads_the_cache_again(root, monkeypatch, cell, trace):
    """After set-up the cold cell parses the R1CS once for each proof (the
    traced run's profiled one too) and puts the SRS planes of its three
    MSMs on the device again; the prove_loop cell does neither."""
    n = _counted(monkeypatch)
    at_setup = {}

    def log(line):
        if line.startswith("set-up "):
            at_setup.update(n)

    out = harness.run_cell(root, cell, SEED, 0.5, trace, device="cpu", log=log)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["attempted"] >= 1
    cold = cell == COLD_CELL
    proofs = (out["attempted"] + trace) if cold else 0
    assert n["parse"] - at_setup["parse"] == proofs
    assert n["upload"] - at_setup["upload"] >= 3 * proofs
    if not cold:
        assert n["upload"] == at_setup["upload"]
    if trace:
        assert set(out["metrics"]) >= {"prove.load_s", "prove.msm_s", "prove.fr_s",
                                       "prove.extend_s", "prove.r1cs_s", "setup.ecfft_s",
                                       "setup.tree_s", "setup.fanout_s", "setup.vanishing_s",
                                       "cold.load_s"}
    else:
        assert set(out["metrics"]) == {"setup_s", "proof_s", "verify_ms"}


def test_control_fails_the_comparison_on_the_cold_cell(root):
    from benchmark import control

    out = control.control_run(root, COLD_CELL, SEED + 1, 0.5, device="cpu")
    assert not out["correct"], out["checks"]
    n = out["attempted"] + 1  # the window's proves and set-up's cold prove
    assert out["checks"]["proofs_mismatched"]["value"] == n, out["checks"]
    assert out["checks"]["verify_rejected"]["value"] == n, out["checks"]


def _planes_reread_wrong(monkeypatch):
    """Every SRS plane upload after the first of each vector puts the
    vector's first point in its second slot: wrong only where the planes
    are read again."""
    from dvpari_tpu_torch import convert

    real, seen = convert.planes_from_numpy, set()

    def upload(planes, device="cuda"):
        key = planes.shape
        if key in seen:
            planes = planes.copy()
            planes[..., 1] = planes[..., 0]
        seen.add(key)
        return real(planes, device)

    monkeypatch.setattr(convert, "planes_from_numpy", upload)


@pytest.mark.parametrize("fault", [faults._stale, faults._half_batch, faults._altered,
                                   _planes_reread_wrong])
def test_a_broken_timed_path_is_not_correct_on_the_cold_cell(root, monkeypatch, fault):
    fault(monkeypatch)
    out = harness.run_cell(root, COLD_CELL, SEED + 2, 0.5, False, device="cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"]["proofs_mismatched"]["value"] > 0


def test_a_cell_over_ranks_is_refused_by_the_cold_drive(tmp_path):
    root = make_root(tmp_path)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny_m64x2.cold_cache", "config": tiny.RANKED,
                               "traffic": "cold_cache", "chips": 2, "why": "test"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    with pytest.raises(RuntimeError, match="rank processes"):
        harness.run_cell(root, "tiny_m64x2.cold_cache", SEED, 0.5, False, device="cpu")


@pytest.mark.card
def test_cold_cell_is_correct_on_the_card(card):
    """A 2 s run of the cold cell on the card (python -m pytest
    benchmark/tests -m card, from the repository's root)."""
    out = harness.run_cell(tiny.REPO, "sp1shape_m16.cold_cache", SEED, 2.0, False)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
