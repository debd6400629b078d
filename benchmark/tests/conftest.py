"""Fixtures of the benchmark's CPU tests: tiny copies of the cells in a
temporary checkout, and the card test's fixture."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from benchmark import run

#: each cell's traffic cut to a size the CPU renders in seconds
TINY = dict(width=16, height=16, warmup_passes=1, profiled_units=1)
TINY_LANES = {"path": 128, "volpath": 128, "sppm": 256}
TINY_SPP = {"path": 2, "volpath": 2, "sppm": 4}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def copy_checkout(dest):
    """BENCHMARK.json and benchmark/ copied into dest; returns dest."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(run.BENCH_DIR, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    return str(dest)


def shrink(root, cell_name, pixels=24):
    """Cut a cell's traffic file in the checkout at root to TINY."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}[cell_name]
    path = os.path.join(root, "benchmark", "workloads", f"{traffic}.json")
    with open(path) as f:
        w = json.load(f)
    for k, v in TINY.items():
        if k in w:
            w[k] = v
    if "integrator" in w:
        w["lanes_per_pass"] = TINY_LANES[w["integrator"]]
        w["spp"] = TINY_SPP[w["integrator"]]
    if "pixels" in w["check"]:
        w["check"]["pixels"] = pixels
    with open(path, "w") as f:
        json.dump(w, f)


#: a volpath cell of the tests alone (benchmark/tests/data): its scene,
#: the repo's 4x4x4 smoke grid, is no deployment, but it keeps the volpath
#: driver and reference running until a public volume scene is a cell
FIXTURE_CELL = "smoke.volpath-16"


def add_fixture_cell(root):
    """The volpath fixture as a configuration, a traffic mix and a cell of
    the checkout copy at root, added as new files and entries."""
    data = os.path.join(root, "benchmark", "tests", "data")
    shutil.copy(os.path.join(data, f"{FIXTURE_CELL}.json"),
                os.path.join(root, "benchmark", "workloads"))
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": "smoke_fixture", "source": "test",
                             "file": "benchmark/tests/data/smoke_glass.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": FIXTURE_CELL,
                               "config": "smoke_fixture",
                               "traffic": FIXTURE_CELL, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornell.path-2048" in m.get("workloads", ()):
            m["workloads"].append(FIXTURE_CELL)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout copy whose every cell is cut to TINY, with the volpath
    fixture cell added."""
    root = copy_checkout(tmp_path)
    add_fixture_cell(root)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for w in bench["workloads"]:
        shrink(root, w["name"])
    return root


@pytest.fixture
def card():
    """The first CUDA card; skips without one (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
