"""A copy of the benchmark's data under a temporary root with one more
configuration and cell at a size the CPU runs in seconds: the harness
reads them as it reads any, and no file of the benchmark changes."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny_m64"
CELL = TINY + ".prove_loop"


def make_root(tmp, m: int = 64) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "benchmark", "configs", "sp1shape_m16.json")) as f:
        cfg = json.load(f)
    cfg.update(name=TINY, m=m)
    path = f"benchmark/configs/{TINY}.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": TINY, "source": cfg["source"], "file": path,
                             "reduced": ["m"], "why": "CPU test size"})
    bench["workloads"].append({"name": CELL, "config": TINY, "traffic": "prove_loop",
                               "chips": 1, "why": "CPU test size"})
    for metric in bench["per_layer"]:
        metric["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
