"""The port's layer spans (utils/stats.py: `span`, `tracing`) on the
render and gradient paths (CPU, 16x16 Cornell).

Off, a span opens no profiler range and changes no result; on, every
operation of a render job lies inside a layer's range, the sampler's
ranges hold no other layer, and each layer opens one range a call: an
intersect range a bounce, a pass range an SPPM iteration.
"""
from collections import Counter

import pytest
import torch

from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import diff, sppm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.utils import stats
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

W = H = 16
LAYERS = {"job", "pass", "camera", "sampler", "intersect", "interaction",
          "shading", "lights", "film", "gather", "step", "forward",
          "backward"}


@pytest.fixture(scope="module")
def setup():
    scene, cam_ctor = tflag.cornell(device="cpu")
    return scene, cam_ctor(W, H), TCfg("sobol", 7, 1)


def one_pass_job(setup, depth=5, **kw):
    """A one-pass job as a user runs it: a new film, one sample a
    pixel."""
    scene, cam, cfg = setup
    film = tfilm.make_film(W, H, "gaussian", device="cpu")
    return tpath.render(scene, cam, film, cfg, 1, max_depth=depth, **kw)


def profiled(fn):
    """fn() under torch.profiler on the CPU: (its result, the pbrt.
    ranges as (start, end, thread, name), the aten ops likewise)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans, ops = [], []
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.thread, e.name)
        if e.name.startswith(stats.PREFIX):
            spans.append(row)
        elif e.name.startswith("aten::"):
            ops.append(row)
    return out, spans, ops


def test_spans_off_open_nothing_and_leave_the_film_as_it_is(setup):
    film_off, spans, ops = profiled(lambda: one_pass_job(setup))
    assert ops and spans == []
    with stats.tracing():
        film_on = one_pass_job(setup)
    for k in ("weighted", "weight", "raw", "splat"):
        assert torch.equal(getattr(film_on, k), getattr(film_off, k)), k


def test_every_op_of_a_job_lies_inside_a_layer_span(setup):
    with stats.tracing():
        _, spans, ops = profiled(lambda: one_pass_job(setup))
    assert {n[len(stats.PREFIX):] for *_, n in spans} \
        == LAYERS - {"gather", "step", "forward", "backward"}
    for a, b, th, name in ops:
        assert any(s0 <= a and b <= s1 and st == th
                   for s0, s1, st, _ in spans), name
    inner = [s for s in spans if s[3] != stats.PREFIX + "sampler"]
    for s0, s1, _, _ in (s for s in spans
                         if s[3] == stats.PREFIX + "sampler"):
        assert not any(s0 <= a and b <= s1 for a, b, _, _ in inner)


def opened(spans):
    """How many ranges each layer opened."""
    return Counter(n[len(stats.PREFIX):] for *_, n in spans)


@pytest.mark.parametrize("depth", [2, 5])
def test_intersect_lanes_are_the_wavefront_batches(setup, depth,
                                                   monkeypatch):
    """Every bounce submits its closest-hit and shadow lanes together in
    one intersect call, so a pass opens 1 + depth intersect ranges and
    carries B (1 + 2 depth) lanes; the live tests `render(stats=)`
    counts are a share of them."""
    lanes = []
    inner = isect.intersect

    def recorded(scene, ray, *a, **k):
        lanes.append(int(ray.o.shape[0]))
        return inner(scene, ray, *a, **k)

    monkeypatch.setattr(isect, "intersect", recorded)
    c = stats.Stats()
    with stats.tracing():
        _, spans, _ = profiled(lambda: one_pass_job(setup, depth, stats=c))
    n = opened(spans)
    assert n["intersect"] == len(lanes) == 1 + depth
    assert n["job"] == n["pass"] == 1
    assert sum(lanes) == W * H * (1 + 2 * depth)
    tests = (c.counters["Intersections/Regular ray intersection tests"]
             + c.counters["Intersections/Shadow ray intersection tests"])
    assert 0 < tests <= sum(lanes)


def test_sppm_opens_a_pass_an_iteration(setup):
    scene, cam, cfg = setup
    with stats.tracing():
        _, spans, _ = profiled(lambda: sppm.render_sppm(
            scene, cam, W, H, cfg, n_iterations=4, max_depth=2))
    n = opened(spans)
    assert (n["job"], n["pass"], n["gather"]) == (1, 4, 4)


def test_a_gradient_step_opens_one_forward_and_one_backward(setup):
    scene, cam, cfg = setup
    target = torch.zeros((W * H, 31))
    init, step = diff.make_train_step(scene, cam, W, H, cfg, target,
                                      max_depth=2)
    params = {"mat_kd": scene.mat_kd.clone()}
    with stats.tracing():
        _, spans, _ = profiled(lambda: step(params, init(params),
                                            torch.arange(W * H), 0))
    n = opened(spans)
    assert (n["step"], n["forward"], n["backward"]) == (1, 1, 1)


def test_an_off_span_is_a_shared_no_op():
    assert stats.span("pass") is stats.span("pass")
    with stats.span("pass") as s:
        assert s is stats.span("pass")

    @stats.span("film")
    def f(x):
        return x + 1

    x = torch.zeros(3)
    assert torch.equal(f(x), x + 1) and f.__name__ == "f"

    def calls():
        f(x)
        with stats.tracing():
            with stats.tracing():
                f(x)
            f(x)
            with stats.span("pass"):
                pass
        f(x)
        with stats.span("pass"):
            pass

    _, spans, _ = profiled(calls)
    assert opened(spans) == {"film": 2, "pass": 1}
