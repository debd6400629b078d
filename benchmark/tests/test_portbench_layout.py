"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file it resolves to."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run
from benchmark.tests.conftest import copy_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == TOP
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in names


def test_every_cell_resolves_to_its_files():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = run.load_cell(w["name"])
        assert os.path.exists(os.path.join(run.ROOT,
                                           cell["config_data"]["scene"]))
        assert os.path.exists(os.path.join(
            run.BENCH_DIR, "drivers", f"{cell['traffic']['driver']}.py"))
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(run.BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
        assert hasattr(run.load_module(run.ROOT, "metrics", m["name"]),
                       "read")
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))


def test_a_cell_added_as_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric
    added to a copy of the checkout as new files and new entries, no file
    of the copy edited but BENCHMARK.json."""
    root = copy_checkout(tmp_path)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "cornell_b.json"), "w") as f:
        json.dump({"scene": "benchmark/scenes/cornell_bench.pbrt"}, f)
    with open(os.path.join(bdir, "workloads", "cornell.path-64.json"),
              "w") as f:
        json.dump({"driver": "render", "integrator": "path", "width": 64,
                   "height": 64, "spp": 1, "lanes_per_pass": 4096,
                   "check": {"pixels": 8, "limits": {}}}, f)
    with open(os.path.join(bdir, "metrics", "passes_traced.py"), "w") as f:
        f.write("def read(trace):\n    return float(trace['units'])\n")
    b = bench()
    b["configs"].append({"name": "cornell_b", "source": "x",
                         "file": "benchmark/configs/cornell_b.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "cornell_b.path-64", "config": "cornell_b",
                           "traffic": "cornell.path-64", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "passes_traced", "unit": "passes",
                           "better": "higher", "source": "program_counter",
                           "layer": "render loop", "moves": "samples_per_s",
                           "workloads": ["cornell_b.path-64"]})
    b["end_to_end"][0].setdefault("workloads", []).append(
        "cornell_b.path-64")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = run.load_cell("cornell_b.path-64", root)
    assert cell["traffic"]["width"] == 64
    assert [m["name"] for m in cell["per_layer"]] == ["parse_build_s",
                                                     "passes_traced"]
    reader = run.load_module(root, "metrics", "passes_traced")
    assert reader.read({"units": 3}) == 3.0
    with pytest.raises(KeyError):
        run.load_cell("no.such-cell", root)
