"""The harness's lookups, readers, attribution and refusals."""

import ast
import filecmp
import json
import os
import shutil
import subprocess
import sys

from types import SimpleNamespace

import pytest

from benchmark import attribution, harness, msm_cost
from benchmark.tests import tiny

BENCH = os.path.join(tiny.REPO, "benchmark")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_what_the_command_runs():
    """Top-level names compared whole: dvpari_tpu_torch is not dvpari_tpu."""
    for path in _sources():
        assert not _top_imports(path) & {"jax", "jaxlib", "flax", "dvpari_tpu"}, path


def test_reference_and_generator_import_nothing_of_the_port():
    for sub in ("reference", "circuits"):
        for path in _sources(sub):
            assert not _top_imports(path) & {"jax", "dvpari_tpu", "dvpari_tpu_torch"}, path
    code = ("import sys; import benchmark.reference.prover, benchmark.circuits.multiterm; "
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert not set(json.loads(out.replace("'", '"'))) & {"jax", "dvpari_tpu", "dvpari_tpu_torch",
                                                          "torch"}


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dvpari_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dvpari_tpu.fake", sys)
    assert harness.forbidden_modules() == ["dvpari_tpu"]


def test_new_config_traffic_and_metric_are_found_as_files(tmp_path):
    root = tiny.make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "traffic", "pool5.json"), "w") as f:
        json.dump({"drive": "closed_loop", "witness_pool": 5}, f)
    with open(os.path.join(root, "benchmark", "traffic", "backwards.json"), "w") as f:
        json.dump({"drive": "backwards", "witness_pool": 4}, f)
    with open(os.path.join(root, "benchmark", "drives", "backwards.py"), "w") as f:
        f.write("def run(window, traffic, seconds):\n"
                "    return {'order': [window.n - 1 - j for j in range(window.n)]}\n")
    with open(os.path.join(root, "benchmark", "metrics", "prove.witness_s.py"), "w") as f:
        f.write("def read(run):\n    return run['trace']['prove_phases'][0]['prove.witness']\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for traffic in ("pool5", "backwards"):
        bench["workloads"].append({"name": "tiny_m64." + traffic, "config": tiny.TINY,
                                   "traffic": traffic, "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prove.witness_s", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "r1cs/gnark.py",
                               "moves": "proof_s", "workloads": ["tiny_m64.pool5"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = harness.load_cell(root, "tiny_m64.pool5")
    assert cell["config"]["m"] == 64 and cell["traffic"]["witness_pool"] == 5
    assert cell["per_layer"] == ["prove.witness_s"]
    assert cell["end_to_end"] == ["setup_s", "proof_s", "verify_ms"]
    read = cell["readers"]["prove.witness_s"][1]
    assert read({"trace": {"prove_phases": [{"prove.witness": 0.25}]}}) == 0.25
    inp = harness.make_inputs(cell, 2**33 + 7)
    assert len(inp["pool"]) == 5
    gen = cell["drive"].requests(5)
    assert [next(gen) for _ in range(10)] == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    other = harness.load_cell(root, "tiny_m64.backwards")
    assert other["drive"].run(SimpleNamespace(n=4), other["traffic"], 1.0) == {"order": [3, 2, 1, 0]}
    # every file the benchmark had is there unchanged
    cmp = filecmp.dircmp(BENCH, os.path.join(root, "benchmark"), ignore=["__pycache__", "tests"])

    def unchanged(c):
        assert not c.diff_files and not c.left_only, (c.diff_files, c.left_only)
        for sub in c.subdirs.values():
            unchanged(sub)

    unchanged(cmp)


def test_closed_loop_counts_each_prove_and_verify():
    from benchmark.drives import closed_loop

    calls = []

    def prove(j):
        calls.append(j)
        if j == 1:
            raise RuntimeError("planted")
        return j

    w = SimpleNamespace(n=3, log=lambda s: None, prove=prove, sync=lambda: None,
                        verify=lambda j, proof: proof == j)
    r = closed_loop.run(w, {"witness_pool": 3}, 0.05)
    assert calls[:6] == [0, 1, 2, 0, 1, 2]
    assert r["attempted"] == len(calls) and r["failed"] == calls.count(1)
    n = r["attempted"] - r["failed"]
    assert len(r["prove_s"]) == len(r["verify_s"]) == len(r["verdicts"]) == n and all(r["verdicts"])
    assert r["window_s"] >= 0.05


def test_inputs_repeat_for_a_seed_and_differ_between_seeds(tmp_path):
    cell = harness.load_cell(tiny.make_root(tmp_path), tiny.CELL)
    a, b, c = (harness.make_inputs(cell, s) for s in (2**40 + 1, 2**40 + 1, 5))
    assert a["circuit"].dump == b["circuit"].dump and a["pool"] == b["pool"]
    assert a["trapdoor"] == b["trapdoor"] != c["trapdoor"]
    assert a["circuit"].dump != c["circuit"].dump
    assert len(a["circuit"].dump) == len(c["circuit"].dump)


def _record():
    phases = {"prove.extend": 0.3, "prove.quotient": 0.05, "prove.evaluate_at_alpha": 0.3,
              "prove.k_scalars": 0.2, "prove.challenge": 0.01, "prove.msm_gm": 0.2,
              "prove.msm_gq": 0.15, "prove.msm_gk": 0.35, "prove.witness": 0.02,
              "prove.matvec": 0.03, "prove.sat_check": 0.01}
    later = dict(phases, **{"prove.extend": 0.5})
    setup = {"setup.tree": 5.0, "setup.vanishing": 2.5, "setup.validate_z": 13.0,
             "setup.barycentric": 5.5, "setup.lagrange": 0.5, "setup.z_inv": 6.0,
             "setup.g_m": 0.5, "setup.g_q": 0.4, "setup.g_k": 0.6, "tree.device_build": 4.0}
    prof = {"busy_s": 0.5, "device_ops": 98000,
            "busy_by_phase_s": {"prove.msm_gm": 0.05, "prove.msm_gq": 0.05,
                                "prove.msm_gk": 0.15, "prove.extend": 0.14}}
    return {"setup_s": 50.0, "window_s": 51.0, "verdicts": [True] * 29 + [False],
            "verify_s": [0.01] * 29 + [0.5],
            "trace": {"prove_phases": [phases, later], "setup_phases": setup,
                      "cold_phases": {"prove.load_tree": 0.12, "prove.extend": 0.4},
                      "prove_s": [1.5, 2.5], "profile": prof,
                      "msm_points": [65538, 65536, 262144], "sm_clock_max_mhz": 1980.0}}


def test_each_metric_reader_reads_its_number():
    bench = json.load(open(os.path.join(tiny.REPO, "BENCHMARK.json")))
    cell = harness.load_cell(tiny.REPO, bench["workloads"][0]["name"])
    r = _record()
    got = {name: read(r) for name, (_, read) in cell["readers"].items()}
    least = sum(msm_cost.bound(msm_cost.msm_work(n), 1980.0)[0] for n in (65538, 65536, 262144))
    want = {"setup_s": 50.0, "proof_s": (51.0 - 0.01 * 29 - 0.5) / 29, "verify_ms": 10.0,
            "prove.extend_s": 0.4, "prove.fr_s": 0.56, "prove.device_ops": 98000,
            "prove.msm_s": 0.7, "msm.roofline_pct": 100 * least / 0.25,
            "prove.r1cs_s": 0.06, "device.idle_pct": 75.0, "setup.ecfft_s": 25.0,
            "setup.tree_s": 5.0, "setup.fanout_s": 1.5, "setup.vanishing_s": 2.5,
            "cold.load_s": 0.12}
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    # nothing to read: no number, never a 0
    empty = {"window_s": 1.0, "verdicts": [], "verify_s": []}
    assert all(read(empty) is None for name, (_, read) in cell["readers"].items()
               if name != "setup_s")


def test_attribution_charges_device_time_to_phases_and_names_gaps():
    ev = [("host_range", "prove.a", 0, 100), ("host_range", "prove.b", 100, 200),
          ("device_range", "prove.a", 5, 60), ("device_range", "prove.b", 110, 250),
          ("device", "k1", 10, 30), ("device", "k2", 25, 40), ("device", "k1", 150, 160),
          ("device", "copy", 70, 80)]
    s = attribution.summarize(ev, {"prove.a", "prove.b"})
    assert s["device_ops"] == 4
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["busy_by_phase_s"]["prove.a"] == pytest.approx(35e-6)
    assert s["busy_by_phase_s"]["prove.b"] == pytest.approx(10e-6)
    assert s["busy_by_phase_s"]["outside any phase"] == pytest.approx(10e-6)
    assert s["top_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert s["idle_gaps"] == [["prove.a", pytest.approx(70e-6)],
                              ["prove.a", pytest.approx(30e-6)]]


def test_from_profiler_leaves_out_the_profilers_nccl_ranges():
    """The profiler's "nccl:<collective>" range on the device timeline
    wraps NCCL's kernel, which alone is a device operation."""
    import torch

    def ev(key, dev, t0, t1):
        return SimpleNamespace(key=key, device_type=dev,
                               time_range=SimpleNamespace(start=t0, end=t1))

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    prof = SimpleNamespace(events=lambda: [
        ev("prove.msm_gm", cpu, 0, 100), ev("prove.msm_gm", cuda, 5, 90),
        ev("ladder_kernel", cuda, 10, 40), ev("nccl:all_gather", cuda, 50, 80),
        ev("ncclDevKernel_AllGather_RING_LL", cuda, 50, 80), ev("aten::add", cpu, 1, 2)])
    events = attribution.from_profiler(prof, {"prove.msm_gm"})
    assert events == [("host_range", "prove.msm_gm", 0, 100),
                      ("device_range", "prove.msm_gm", 5, 90),
                      ("device", "ladder_kernel", 10, 40),
                      ("device", "ncclDevKernel_AllGather_RING_LL", 50, 80)]
    s = attribution.summarize(events, {"prove.msm_gm"})
    assert s["device_ops"] == 2
    assert s["busy_by_phase_s"]["prove.msm_gm"] == pytest.approx(60e-6)


def _run(root, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "sp1shape_m16.prove_loop", "--seed", str(2**33), "--seconds", "1",
                           "--trace", "0"], cwd=root, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(tiny.REPO, env)
    assert r.returncode != 0 and r.stdout.strip() == "", (r.returncode, r.stdout)
    assert "CUDA" in r.stderr


def test_run_exits_nonzero_with_only_the_benchmarks_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(str(tmp_path), env)
    assert r.returncode != 0 and r.stdout.strip() == "", (r.returncode, r.stdout)
