"""Tabulated BSSRDF: the photon-beam-diffusion profile tables and their
per-lane queries (port of pbrt_tpu.materials.bssrdf; reference:
core/bssrdf.{h,cpp}: FresnelMoment1/2 :43-67, BeamDiffusionMS :68-120,
BeamDiffusionSS :122-144, ComputeBeamDiffusionBSSRDF :368-398,
SubsurfaceFromDiffuse :400-409, TabulatedBSSRDF::{Sr, Sample_Sr,
Pdf_Sr} :184-281).

The host half is numpy, a copy of the JAX package's: the whole
[n_rho, n_radius, n_depth] integrand is one broadcast evaluation at scene
build, and the profile / CDF tables it returns are what the device
queries read.  The device half (`sr_eval_device`, `sr_sample_device`,
`sr_pdf_device`) runs per lane on torch tensors over the [T, NR, NK]
stack of a scene's tables.
"""
from __future__ import annotations

import numpy as np
import torch

INV_4PI = 1.0 / (4.0 * np.pi)


def fresnel_moment1(eta):
    """First angular moment of the Fresnel reflectance (bssrdf.cpp:43)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return np.where(eta < 1, lo, hi)


def fresnel_moment2(eta):
    """Second angular moment (bssrdf.cpp:54)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / np.maximum(eta, 1e-6)
    hi = (-547.033 + 45.3087 * r ** 3 - 218.725 * r ** 2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return np.where(eta < 1, lo, hi)


def fresnel_moment1_torch(eta):
    """fresnel_moment1 on a tensor (the Sw lobe's normalisation)."""
    e2, e3 = eta * eta, eta * eta * eta
    e4, e5 = e3 * eta, e3 * eta * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1, lo, hi)


def _fr_dielectric(cos_i, eta):
    """Fresnel reflectance, unpolarized (cos_i < 0: exiting)."""
    cos_i = np.clip(cos_i, -1, 1)
    entering = cos_i > 0
    ei = np.where(entering, 1.0, eta)
    et = np.where(entering, eta, 1.0)
    ci = np.abs(cos_i)
    sin2_t = (ei / et) ** 2 * np.maximum(0.0, 1 - ci ** 2)
    tir = sin2_t >= 1
    ct = np.sqrt(np.maximum(1 - sin2_t, 0))
    r_par = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-9)
    r_perp = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-9)
    return np.where(tir, 1.0, 0.5 * (r_par ** 2 + r_perp ** 2))


def _phase_hg(cos_t, g):
    d = 1 + g * g + 2 * g * cos_t
    return INV_4PI * (1 - g * g) / np.maximum(d * np.sqrt(np.abs(d)),
                                              1e-9)


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Multiple-scattering dipole term (bssrdf.cpp:68; Habel et al.'s
    photon beam diffusion), broadcast over sigma_s / sigma_a / r."""
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = np.maximum(sigma_a + sigmap_s, 1e-9)
    rhop = sigmap_s / sigmap_t
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t ** 2)
    sigma_tr = np.sqrt(np.maximum(sigma_a / d_g, 0.0))
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    u = (np.arange(n_samples) + 0.5) / n_samples     # [S]
    zr = -np.log(1 - u) / sigmap_t[..., None]        # [...,S]
    zv = -zr + 2 * ze[..., None] if np.ndim(ze) else -zr + 2 * ze
    r_ = np.asarray(r)[..., None]
    dr = np.sqrt(r_ ** 2 + zr ** 2)
    dv = np.sqrt(r_ ** 2 + zv ** 2)
    st = sigma_tr[..., None] if np.ndim(sigma_tr) else sigma_tr
    phi_d = INV_4PI / d_g[..., None] * (np.exp(-st * dr) / dr
                                        - np.exp(-st * dv) / dv)
    e_dn = INV_4PI * (zr * (1 + st * dr) * np.exp(-st * dr) / dr ** 3
                      - zv * (1 + st * dv) * np.exp(-st * dv) / dv ** 3)
    e = phi_d * np.expand_dims(c_phi, -1) + e_dn * np.expand_dims(c_e, -1)
    kappa = 1 - np.exp(-2 * sigmap_t[..., None] * (dr + zr))
    return (kappa * rhop[..., None] ** 2 * e).mean(-1)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Single-scattering term (bssrdf.cpp:122)."""
    sigma_t = np.maximum(sigma_a + sigma_s, 1e-9)
    rho = sigma_s / sigma_t
    t_crit = np.asarray(r) * np.sqrt(max(eta * eta - 1, 0.0))
    u = (np.arange(n_samples) + 0.5) / n_samples
    ti = t_crit[..., None] - np.log(1 - u) / sigma_t[..., None]
    d = np.sqrt(np.asarray(r)[..., None] ** 2 + ti ** 2)
    cos_to = ti / np.maximum(d, 1e-12)
    ess = (rho[..., None] * np.exp(-sigma_t[..., None]
                                   * (d + t_crit[..., None]))
           / np.maximum(d ** 2, 1e-12)
           * _phase_hg(cos_to, g)
           * (1 - _fr_dielectric(-cos_to, eta))
           * np.abs(cos_to))
    return ess.mean(-1)


def compute_beam_diffusion_bssrdf(g, eta, n_rho=100, n_radius=64):
    """The (rho, radius) diffusion-profile table (bssrdf.cpp:368-398):
    rho [NR], radius [NRad], profile [NR,NRad] (with the 2 pi r area
    factor), the per-row radius cdf [NR,NRad] and rho_eff [NR]."""
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    i = np.arange(n_rho)
    rho = (1 - np.exp(-8 * i / (n_rho - 1))) / (1 - np.exp(-8))
    R, Rad = np.meshgrid(rho, radius, indexing="ij")   # [NR,NRad]
    profile = 2 * np.pi * Rad * (
        beam_diffusion_ss(R, 1 - R, g, eta, Rad)
        + beam_diffusion_ms(R, 1 - R, g, eta, Rad))
    profile = np.maximum(profile, 0.0)
    # effective albedo and radius cdf (the reference integrates the
    # Catmull-Rom spline; the trapezoid over the log-spaced radii is
    # within its interpolation error)
    seg = 0.5 * (profile[:, 1:] + profile[:, :-1]) * np.diff(radius)
    cdf = np.concatenate([np.zeros((n_rho, 1)), np.cumsum(seg, -1)], -1)
    rho_eff = cdf[:, -1].copy()
    return dict(rho=rho, radius=radius,
                profile=profile.astype(np.float32),
                cdf=cdf.astype(np.float32),
                rho_eff=rho_eff.astype(np.float32), g=g, eta=eta)


def subsurface_from_diffuse(table, rho_eff_target, mfp):
    """Per-channel (sigma_a, sigma_s) whose effective albedo is
    rho_eff_target at mean free path mfp (bssrdf.cpp:400-409;
    kdsubsurface's Kd / mfp)."""
    rho = np.interp(np.clip(rho_eff_target, 0.0,
                            float(table["rho_eff"].max()) - 1e-6),
                    table["rho_eff"], table["rho"])
    sigma_s = rho / np.maximum(mfp, 1e-9)
    sigma_a = (1 - rho) / np.maximum(mfp, 1e-9)
    return sigma_a, sigma_s


def eval_sr(table, rho, r_optical):
    """The profile Sr at optical radius r_optical, bilinear in (rho,
    radius) (TabulatedBSSRDF::Sr without its sigma_t^2 scale); numpy."""
    rho = np.clip(rho, table["rho"][0], table["rho"][-1])
    ri = np.interp(rho, table["rho"], np.arange(len(table["rho"])))
    ci = np.interp(r_optical, table["radius"],
                   np.arange(len(table["radius"])))
    r0 = np.clip(ri.astype(int), 0, len(table["rho"]) - 2)
    c0 = np.clip(ci.astype(int), 0, len(table["radius"]) - 2)
    fr, fc = ri - r0, ci - c0
    p = table["profile"]
    prof = ((1 - fr) * (1 - fc) * p[r0, c0] + fr * (1 - fc) * p[r0 + 1, c0]
            + (1 - fr) * fc * p[r0, c0 + 1] + fr * fc * p[r0 + 1, c0 + 1])
    # without the 2 pi r area factor: the canonical profile value
    return prof / np.maximum(2 * np.pi * r_optical, 1e-6)


def sample_sr(table, rho, u):
    """An optical radius drawn from the interpolated rho row's cdf
    (TabulatedBSSRDF::Sample_Sr); numpy, broadcast over rho / u."""
    rho = np.clip(rho, table["rho"][0], table["rho"][-1])
    ri = np.clip(np.interp(rho, table["rho"],
                           np.arange(len(table["rho"]))).astype(int),
                 0, len(table["rho"]) - 1)
    flat_r = np.ravel(np.broadcast_to(ri, np.shape(u)))
    flat_u = np.ravel(u)
    res = np.empty(flat_u.shape)
    for k in range(flat_u.shape[0]):
        row = table["cdf"][flat_r[k]]
        tot = max(row[-1], 1e-12)
        res[k] = np.interp(flat_u[k] * tot, row, table["radius"])
    return res.reshape(np.shape(u))


# ---------------------------------------------------------------------------
# the device queries of the probe pass (TabulatedBSSRDF::{Sr, Sample_Sr,
# Pdf_Sr}, bssrdf.cpp:184-281) over the [T,NR,NK] stacked tables
# ---------------------------------------------------------------------------

def _rho_row(rho_grid, rho):
    """The nearest rho row.  Sampling and pdf take the same row, so that
    the pdf is the sampled density (the reference couples them through
    the same Catmull-Rom weights)."""
    ri = torch.searchsorted(rho_grid, rho.contiguous())
    ri = torch.clamp(ri, 1, rho_grid.shape[0] - 1)
    lo = rho_grid[ri - 1]
    hi = rho_grid[ri]
    return torch.where(rho - lo < hi - rho, ri - 1, ri)


def _cell(grid, x):
    """(index of the cell below x, clamped to [0, N-2]; fraction in it,
    clamped to [0, 1]) on a sorted grid [N]."""
    n = grid.shape[0]
    i = torch.clamp(torch.searchsorted(grid, x.contiguous()) - 1, 0, n - 2)
    f = torch.clamp((x - grid[i])
                    / torch.clamp(grid[i + 1] - grid[i], min=1e-9), 0.0, 1.0)
    return i, f


def sr_eval_device(profile, rho_grid, radius_grid, tid, rho, r_opt):
    """The profile Sr(rho, r_opt) per unit optical area, bilinear over the
    [T,NR,NK] tables (callers scale by sigma_t^2 for world area).
    Arguments broadcast ([B,31] works)."""
    ri, fr = _cell(rho_grid, rho)
    ci, fc = _cell(radius_grid, r_opt)
    tid, ri, ci, fr, fc = torch.broadcast_tensors(tid, ri, ci, fr, fc)
    tid = tid.long()
    v = ((1 - fr) * (1 - fc) * profile[tid, ri, ci]
         + fr * (1 - fc) * profile[tid, ri + 1, ci]
         + (1 - fr) * fc * profile[tid, ri, ci + 1]
         + fr * fc * profile[tid, ri + 1, ci + 1])
    return v / torch.clamp(2 * np.pi * r_opt, min=1e-6)


def sr_sample_device(cdf, radius_grid, rho_grid, tid, rho, u):
    """An optical radius inverted from the nearest rho row's radius cdf
    (sr_pdf_device's row)."""
    NK = radius_grid.shape[0]
    row = cdf[tid.long(), _rho_row(rho_grid, rho)]
    row = row.expand(u.shape + (NK,))                    # [...,NK]
    tot = torch.clamp(row[..., -1], min=1e-12)
    target = u * tot
    ci = torch.clamp((row <= target[..., None]).sum(-1) - 1, 0, NK - 2)
    c0 = torch.gather(row, -1, ci[..., None])[..., 0]
    c1 = torch.gather(row, -1, ci[..., None] + 1)[..., 0]
    f = torch.clamp((target - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0,
                    1.0)
    r0 = radius_grid[ci]
    r1 = radius_grid[ci + 1]
    return r0 + f * (r1 - r0)


def sr_pdf_device(profile, cdf, rho_grid, radius_grid, tid, rho, r_opt):
    """The density of sr_sample_device per unit optical area: the nearest
    rho row's profile over its rho_eff and 2 pi r; 0 past the table."""
    NK = radius_grid.shape[0]
    tid = tid.long()
    rr = _rho_row(rho_grid, rho)
    prow = profile[tid, rr]
    prow = prow.expand(torch.broadcast_shapes(prow.shape[:-1], r_opt.shape)
                       + (NK,))                          # [...,NK]
    ci, fc = _cell(radius_grid, r_opt)
    ci = ci.expand(prow.shape[:-1])
    p0 = torch.gather(prow, -1, ci[..., None])[..., 0]
    p1 = torch.gather(prow, -1, ci[..., None] + 1)[..., 0]
    v = (1 - fc) * p0 + fc * p1
    rho_eff = torch.clamp(cdf[tid, rr][..., -1], min=1e-12)
    pdf = v / rho_eff / torch.clamp(2 * np.pi * r_opt, min=1e-6)
    return torch.where(r_opt >= radius_grid[-1], 0.0,
                       torch.clamp(pdf, min=0.0))
