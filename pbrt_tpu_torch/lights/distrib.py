"""Light selection (port of the "uniform" strategy of
pbrt_tpu.lights.distrib; the power and spatial strategies are not ported
yet)."""

from __future__ import annotations

import torch

from pbrt_tpu_torch.scene import ir


def select_light(scene: ir.SceneData, u):
    """Pick a light per lane uniformly; returns (l [B], sel_pdf [B])."""
    nl = max(scene.n_lights, 1)
    l = torch.clamp((u * nl).to(torch.int32), max=nl - 1)
    return l, torch.full_like(u, 1.0 / nl)


def selection_pdf(scene: ir.SceneData, like):
    """Probability that uniform selection picks any one light, shaped and
    placed like `like` (MIS at hit vertices)."""
    return torch.full_like(like, 1.0 / max(scene.n_lights, 1),
                           dtype=torch.float32)
