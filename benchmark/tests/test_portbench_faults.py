"""The timed path broken underneath a tiny CPU run, past the harness's
look for a card: `correct` comes out false for each fault a cell can
have.  (No cell spans chips, so the exchange between chips cannot be
left out.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run


def correct(root, name):
    cell = run.load_cell(name, root)
    res = run.execute(cell, 2 ** 31 + 4242, 0.5, 0, torch.device("cpu"),
                      time.perf_counter())
    return res["correct"], res["compared"]


def _render_faults():
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.integrators import path as pathmod
    add = filmmod.add_samples
    trace = pathmod.trace_paths

    def unchanged(film, pfilm, L, ray_weight=None):
        return film                       # the pass leaves the film as it was

    def half(film, pfilm, L, ray_weight=None):
        # half the lanes, the mean taken over the rest
        n = pfilm.shape[0] // 2
        w = None if ray_weight is None else 2 * ray_weight[:n]
        return add(film, pfilm[:n], L[:n], w)

    def altered(*a, **k):
        out = trace(*a, **k)              # one lane in four twice as bright
        L = out[0] if isinstance(out, tuple) else out
        L = L * torch.where(torch.arange(L.shape[0]) % 4 == 0, 2.0,
                            1.0)[:, None]
        return (L,) + tuple(out[1:]) if isinstance(out, tuple) else L

    return {"unchanged": (filmmod, "add_samples", unchanged),
            "half": (filmmod, "add_samples", half),
            "altered": (pathmod, "trace_paths", altered)}


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_render_fault_is_caught(tiny_root, monkeypatch, fault):
    mod, attr, fn = _render_faults()[fault]
    monkeypatch.setattr(mod, attr, fn)
    ok, nums = correct(tiny_root, "cornell.path-2048")
    assert ok is False, nums


def _grad_faults():
    from pbrt_tpu_torch.integrators import diff
    from pbrt_tpu_torch.integrators import path as pathmod
    loss = diff.render_loss
    trace = pathmod.trace_paths

    def unchanged(params, grads, state, learning_rate, **kw):
        return dict(params), state        # the step leaves its state

    def half(params, scene, camera, W, H, cfg, pixel_ids, *a, **k):
        return loss(params, scene, camera, W, H, cfg,
                    pixel_ids[:pixel_ids.shape[0] // 2], *a, **k)

    def altered(*a, **k):
        return trace(*a, **k) * 1.05

    return {"unchanged": (diff, "adam_update", unchanged),
            "half": (diff, "render_loss", half),
            "altered": (pathmod, "trace_paths", altered)}


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_grad_fault_is_caught(tiny_root, monkeypatch, fault):
    mod, attr, fn = _grad_faults()[fault]
    monkeypatch.setattr(mod, attr, fn)
    ok, nums = correct(tiny_root, "cornell.grad-2048x1024")
    assert ok is False, nums
