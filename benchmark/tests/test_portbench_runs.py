"""Each cell run end to end on the CPU at a tiny size through the
program's plain paths, its result line against the contract, and the
run's refusals: without a card, and with JAX or the JAX package loaded."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import FIXTURE_CELL

CELLS = ("cornell.path-2048", FIXTURE_CELL, "cornell.grad-2048x1024",
         "cornell.sppm-362")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "compared"}


def execute(root, name, trace):
    cell = run.load_cell(name, root)
    return cell, run.execute(cell, 2 ** 31 + 977, 0.5, trace,
                             torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(tiny_root, name):
    cell, res = execute(tiny_root, name, 0)
    assert set(res) == RESULT_KEYS
    assert list(res)[-1] == "compared"
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in res["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ("cornell.path-2048",
                                  "cornell.grad-2048x1024"))
def test_traced_run_on_the_cpu(tiny_root, name):
    """The traced run's keys (the CPU has no device trace: the readers of
    device numbers give what they find, the host's numbers are there)."""
    cell, res = execute(tiny_root, name, 1)
    assert set(res) == RESULT_KEYS | {"breakdown"}
    assert list(res)[-1] == "compared"
    assert res["correct"] is True, res["compared"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "parse_build_s" in res["metrics"]
    assert set(res["metrics"]) <= {m["name"] for m in cell["per_layer"]}


def _run_cli(extra_env=None, code=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    argv = ([sys.executable, "-c", code] if code else
            [sys.executable, "-m", "benchmark.run", "--workload",
             "cornell.path-2048", "--seed", "5", "--seconds", "1",
             "--trace", "0"])
    return subprocess.run(argv, cwd=run.ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_refuses_without_a_card():
    """No CUDA card: exit status 3, nothing on stdout, no CPU fallback."""
    p = _run_cli()
    assert p.returncode == 3, p.stderr
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_nothing_it_runs_imports_jax_or_the_jax_package():
    """Everything a run imports, the program's modules the drivers and
    spans reach included, leaves no jax, jaxlib, flax or pbrt_tpu in
    sys.modules (by whole top-level name: pbrt_tpu_torch is allowed)."""
    code = (
        "import sys, json\n"
        "from benchmark import run, profile\n"
        "from benchmark.reference import compare, grad, sppm, volpath\n"
        "for d in ('render', 'grad'):\n"
        "    run.load_module(run.ROOT, 'drivers', d)\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "for m in b['per_layer']:\n"
        "    run.load_module(run.ROOT, 'metrics', m['name'])\n"
        "import pbrt_tpu_torch.parser.api, pbrt_tpu_torch.tools.pbrt\n"
        "import pbrt_tpu_torch.integrators.dispatch\n"
        "import pbrt_tpu_torch.integrators.diff\n"
        "import pbrt_tpu_torch.media.media, pbrt_tpu_torch.ops.intersect\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.startswith('pbrt_tpu_torch'))[:3]))\n")
    p = _run_cli(code=code)
    assert p.returncode == 0, p.stderr
    forbidden, ours = (json.loads(x) for x in p.stdout.split("\n")[:2])
    assert forbidden == []
    assert ours, "the program's modules were not imported"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pbrt_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pbrt_tpu.core", object())
    assert run.forbidden_modules() == ["pbrt_tpu"]
