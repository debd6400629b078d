"""benchmark/layers.py on a synthetic trace, and the layer readers of a
traced run on the CPU: on the program, and on a program without spans."""

from __future__ import annotations

import re
import time

import pytest
import torch

from benchmark import layers, run


def kernel(launched, dur_us, start):
    return dict(name="k", dur_s=dur_us * 1e-6, start=start,
                end=start + dur_us, launched=launched, op="aten::mul")


def synthetic():
    """A pass holding a sampler call and an intersect call whose
    interaction call is nested in it, and kernels launched in each, in
    the pass alone, outside every span and with no launch matched."""
    ranges = [(0, 100, "pass"), (10, 20, "sampler"), (30, 60, "intersect"),
              (40, 50, "interaction")]
    kernels = [kernel(15, 3, 200), kernel(35, 5, 210), kernel(45, 7, 220),
               kernel(55, 11, 230), kernel(70, 13, 250),
               kernel(120, 17, 270), kernel(None, 19, 300)]
    return dict(kernels=kernels, layers=ranges, sync_at=[16, 47, 80, 150])


def test_a_kernel_goes_to_its_innermost_span():
    seconds, rows = layers.split(synthetic())
    assert [layer for _, layer in rows] == [
        "sampler", "intersect", "interaction", "intersect", "pass", None]
    assert seconds == pytest.approx({"sampler": 3e-6, "intersect": 16e-6,
                                     "interaction": 7e-6, "pass": 13e-6,
                                     None: 17e-6})
    assert layers.innermost([16, 47, 80, 150], synthetic()["layers"]) \
        == ["sampler", "interaction", "pass", None]


def test_exclusive_times_sum_to_the_time_launched_inside_spans():
    p = synthetic()
    seconds, _ = layers.split(p)
    inside = sum(v for k, v in seconds.items() if k is not None)
    assert inside == pytest.approx(layers.inclusive_seconds(p, "pass"))
    assert layers.inclusive_seconds(p, "intersect") == pytest.approx(23e-6)
    assert layers.inclusive_seconds(p, "gather") is None


def test_idle_gaps_are_labelled_by_span_and_op():
    _, rows = layers.split(synthetic())
    gaps = dict(layers.idle_gaps(rows))
    assert gaps["interaction: aten::mul"] == pytest.approx(5e-6)
    assert gaps["outside: aten::mul"] == pytest.approx(7e-6)


NEW = {"sampler_ms_per_pass", "camera_ms_per_pass", "interaction_ms_per_pass",
       "shading_ms_per_pass", "lights_ms_per_pass", "film_ms_per_pass",
       "integrator_ms_per_pass", "live_lane_pct"}


def traced_path(root):
    cell = run.load_cell("cornell.path-2048", root)
    return run.execute(cell, 2 ** 31 + 977, 0.5, 1, torch.device("cpu"),
                       time.perf_counter())


def test_the_layer_readers_on_the_cpu(tiny_root, capsys):
    """On the CPU no kernel is traced: the layers that opened a span read
    0 ms.  The counted unit's lanes, as the driver's intersect wrapper
    records them, are the fixed-width wavefront's: each of the one-pass
    job's chunks submits its closest-hit and shadow lanes together, 1 + 2
    depth a pixel in 1 + depth calls; its live share lies in (0, 100]."""
    res = traced_path(tiny_root)
    assert res["correct"] is True, res["compared"]
    assert NEW <= set(res["metrics"])
    for name in NEW - {"live_lane_pct"}:
        assert res["metrics"][name]["value"] == 0.0
    err = capsys.readouterr().err
    assert "layer trace:" in err
    tests, lanes, calls = map(int, re.search(
        r"counted unit: (\d+) live tests of (\d+) intersect lanes in "
        r"(\d+) calls", err).groups())
    depth, pixels, chunks = 5, 16 * 16, 2
    assert (lanes, calls) == (pixels * (1 + 2 * depth),
                              chunks * (1 + depth))
    assert 0 < tests <= lanes
    assert res["metrics"]["live_lane_pct"]["value"] \
        == pytest.approx(100.0 * tests / lanes)


def test_a_program_without_spans_reads_none(tiny_root, monkeypatch):
    """The readers on a program whose stats module has no `tracing` (the
    program before its spans): each new metric is left out."""
    from pbrt_tpu_torch.utils import stats
    monkeypatch.delattr(stats, "tracing")
    res = traced_path(tiny_root)
    assert res["correct"] is True
    assert not NEW & set(res["metrics"])
    assert "parse_build_s" in res["metrics"]
