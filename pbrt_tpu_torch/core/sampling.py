"""Monte-Carlo warps and MIS weights (port of the parts of
pbrt_tpu.core.sampling that the Cornell path reaches)."""

from __future__ import annotations

import numpy as np
import torch

PI = float(np.pi)
INV_PI = float(1.0 / np.pi)


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map (reference: sampling.cpp:113)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x, (PI / 4.0) * (oy / torch.where(ox == 0, 1.0, ox)),
        (PI / 2.0) - (PI / 4.0) * (ox / torch.where(oy == 0, 1.0, oy)))
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], -1)


def cosine_sample_hemisphere(u1, u2):
    d = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=1e-14))
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def uniform_sample_triangle(u1, u2):
    """Barycentric (b0, b1) (reference: sampling.cpp:186)."""
    su0 = torch.sqrt(torch.clamp(u1, min=1e-14))
    return torch.stack([1.0 - su0, u2 * su0], -1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)
