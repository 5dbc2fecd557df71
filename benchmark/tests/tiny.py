"""A copy of the benchmark's data under a temporary root with two more
configurations and cells at a size the CPU runs in seconds, one proved
in this process and one over two ranks: the harness reads them as it
reads any, and no file of the benchmark changes."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny_m64"
CELL = TINY + ".prove_loop"
RANKED = "tiny_m64x2"  # the same circuit proved over two ranks
RANKED_CELL = RANKED + ".prove_loop"


def make_root(tmp, m: int = 64) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "benchmark", "configs", "sp1shape_m16.json")) as f:
        cfg = json.load(f)
    for name, ranks in ((TINY, 1), (RANKED, 2)):
        cfg.update(name=name, m=m, ranks=ranks)
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"], "file": path,
                                 "reduced": ["m"], "why": "CPU test size"})
        bench["workloads"].append({"name": name + ".prove_loop", "config": name,
                                   "traffic": "prove_loop", "chips": ranks,
                                   "why": "CPU test size"})
    for metric in bench["per_layer"]:
        metric["workloads"] += [CELL, RANKED_CELL]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
