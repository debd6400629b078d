"""Monte-Carlo warps, MIS weights and the discrete 1D distribution (port
of the parts of pbrt_tpu.core.sampling that the integrators and their
lights reach)."""

from __future__ import annotations

import numpy as np
import torch

PI = float(np.pi)
INV_PI = float(1.0 / np.pi)
INV_4PI = float(0.25 / np.pi)


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


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_hemisphere(u1, u2):
    r = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=1e-14))
    phi = 2 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), u1], -1)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-14))
    phi = 2 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2 * PI * torch.clamp(1.0 - cos_theta_max, min=1e-9))


def uniform_sample_triangle(u1, u2):
    """Barycentric (b0, b1) (reference: sampling.cpp:186)."""
    su0 = torch.sqrt(torch.clamp(u1, min=1e-14))
    return torch.stack([1.0 - su0, u2 * su0], -1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def build_distribution_1d(f):
    """Distribution1D (sampling.h:55-120) of nonnegative values f [..., n]:
    (cdf [..., n+1], func_int [...]).  cdf[..., i] = P(X < i/n); func_int
    is the mean of f (the reference's funcInt); where it is 0 the cdf is
    uniform."""
    n = f.shape[-1]
    c = torch.cumsum(f, -1) / n
    func_int = c[..., -1]
    pos = func_int[..., None] > 0
    cdf = torch.cat([torch.zeros_like(c[..., :1]),
                     c / torch.where(pos, func_int[..., None], 1.0)], -1)
    uniform = torch.linspace(0.0, 1.0, n + 1, dtype=f.dtype,
                             device=f.device)
    return torch.where(pos, cdf, uniform), func_int


def sample_distribution_1d_discrete(cdf, func_int, func, u):
    """An index ~ func [n] for each u (Distribution1D::SampleDiscrete):
    (idx, pmf)."""
    n = func.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    pmf = func[idx] / torch.clamp(func_int * n, min=1e-20)
    return idx, pmf
