"""FourierBSDF: measured and layered materials (port of
pbrt_tpu.materials.fourier; reference: materials/fourier.cpp, SCATFUN v1
layerlab files, and core/reflection.cpp FourierBSDF::f and Sample_f).

The host half is numpy, a copy of the JAX package's: `read_bsdf` /
`write_bsdf` for the file, `bake_grid`, which sums the ragged Fourier
series once at scene build into a regular (muI, muO, dPhi) lattice of
the BSDF's value [NM, NM, NP, 3], and `bake_cr_tables`, the lattice's
sampling marginals.  The device half reads them per lane: `eval_grid`
is a trilinear lookup; `sample_grid_cr` / `pdf_grid_cr` draw and score
wi by inverting the Catmull-Rom interpolant of the marginals, a fixed
_CR_NEWTON_ITERS Newton-bisection steps a lane (the reference's
SampleCatmullRom2D, interpolation.cpp:172-300).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

HEADER = b"SCATFUN\x01"


def read_bsdf(filename):
    """Parse a SCATFUN v1 .bsdf file -> dict (fourier.cpp:105-214)."""
    with open(filename, "rb") as f:
        if f.read(8) != HEADER:
            raise ValueError(f"{filename}: not a SCATFUN v1 file")
        (flags, n_mu, n_coeffs, m_max, n_channels, n_bases, _, _, _,
         ) = struct.unpack("<9i", f.read(36))
        (eta,) = struct.unpack("<f", f.read(4))
        f.read(16)  # alpha[2] + unused[2]
        if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
            raise ValueError(f"{filename}: unsupported BSDF variant")
        mu = np.frombuffer(f.read(4 * n_mu), "<f4")
        cdf = np.frombuffer(f.read(4 * n_mu * n_mu),
                            "<f4").reshape(n_mu, n_mu)
        off_len = np.frombuffer(f.read(4 * n_mu * n_mu * 2),
                                "<i4").reshape(n_mu, n_mu, 2)
        a = np.frombuffer(f.read(4 * n_coeffs), "<f4")
    return dict(mu=mu.astype(np.float64), cdf=cdf,
                a_offset=off_len[..., 0], m=off_len[..., 1],
                a=a.astype(np.float64), m_max=m_max,
                n_channels=n_channels, eta=float(eta))


def write_bsdf(filename, mu, coeffs, n_channels=1, eta=1.0):
    """Write a SCATFUN file (for tests/tools; inverse of read_bsdf).
    coeffs: nested [n_mu][n_mu] lists of [m*n_channels] arrays."""
    n_mu = len(mu)
    flat, offsets, lengths = [], np.zeros((n_mu, n_mu), np.int32), \
        np.zeros((n_mu, n_mu), np.int32)
    for i in range(n_mu):
        for o in range(n_mu):
            c = np.asarray(coeffs[i][o], np.float32).reshape(-1)
            offsets[i, o] = len(flat)
            lengths[i, o] = len(c) // n_channels
            flat.extend(c.tolist())
    flat = np.asarray(flat, np.float32)
    m_max = int(lengths.max())
    with open(filename, "wb") as f:
        f.write(HEADER)
        f.write(struct.pack("<9i", 1, n_mu, len(flat), m_max, n_channels,
                            1, 0, 0, 0))
        f.write(struct.pack("<f", eta))
        f.write(struct.pack("<4f", 0.0, 0.0, 0.0, 0.0))
        f.write(np.asarray(mu, np.float32).tobytes())
        f.write(np.zeros((n_mu, n_mu), np.float32).tobytes())  # cdf
        ol = np.stack([offsets, lengths], -1).astype("<i4")
        f.write(ol.tobytes())
        f.write(flat.tobytes())


def _catmull_rom_weights(nodes, x):
    """The reference's CatmullRomWeights (interpolation.cpp:47): 4
    weights over nodes[offset..offset+3] (offset may be -1 with a zero
    first weight; callers clamp the index)."""
    n = len(nodes)
    if x < nodes[0] or x > nodes[-1]:
        return None
    i = int(np.clip(np.searchsorted(nodes, x, side="right") - 1,
                    0, n - 2))
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[0] = 0.0
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[1] -= w3
        w[3] = w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
        w[3] = 0.0
    return i - 1, w


def _ak(tab, mu_i, mu_o):
    """Spline-weighted Fourier coefficients at (muI, muO) — the inner
    accumulation of FourierBSDF::f (reflection.cpp:380-404).
    Returns [m_max, n_channels]."""
    nc = tab["n_channels"]
    wi = _catmull_rom_weights(tab["mu"], mu_i)
    wo = _catmull_rom_weights(tab["mu"], mu_o)
    ak = np.zeros((tab["m_max"], nc))
    if wi is None or wo is None:
        return ak
    oi, wgt_i = wi
    oo, wgt_o = wo
    n = len(tab["mu"])
    for a in range(4):
        if wgt_i[a] == 0:
            continue
        ii = np.clip(oi + a, 0, n - 1)
        for b in range(4):
            w = wgt_o[b] * wgt_i[a]
            if w == 0:
                continue
            jj = np.clip(oo + b, 0, n - 1)
            m = tab["m"][ii, jj]
            if m == 0:
                continue
            off = tab["a_offset"][ii, jj]
            c = tab["a"][off:off + m * nc].reshape(nc, m)
            ak[:m] += w * c.T
    return ak


def bake_grid(tab, n_mu=64, n_phi=64):
    """Compile-time bake: regular lattice over (muI, muO, phi in [0,pi])
    of the **BSDF value f** (the stored series divided by |muI|,
    reflection.cpp:428 scale).  Returns grid [NM,NM,NP,3] float32."""
    mu_axis = np.linspace(-1.0, 1.0, n_mu)
    phi_axis = np.linspace(0.0, np.pi, n_phi)
    nc = tab["n_channels"]
    cosmat = np.cos(np.outer(phi_axis, np.arange(tab["m_max"])))
    grid = np.zeros((n_mu, n_mu, n_phi, nc), np.float32)
    for i, mi in enumerate(mu_axis):
        for o, mo in enumerate(mu_axis):
            grid[i, o] = np.maximum(cosmat @ _ak(tab, mi, mo), 0.0)
    grid /= np.maximum(np.abs(mu_axis)[:, None, None, None], 1e-3)
    if nc == 1:
        grid = np.repeat(grid, 3, axis=-1)
    else:
        # stored channels are (Y, R, B); G from the luminance identity
        # (reflection.cpp:412-415)
        y, r, b = grid[..., 0], grid[..., 1], grid[..., 2]
        g = 1.39829 * y - 0.100913 * b - 0.297375 * r
        grid = np.stack([r, g, b], -1)
    return np.maximum(grid, 0.0)


def bake_cr_tables(grid):
    """Compile-time marginals for the CR sampler: a0 [NMi, NMo] =
    phi-average luminance x |mu_i| (the f*cos importance; the stored
    lattice is f = series/|muI|, so multiplying back recovers the
    series the reference's file CDFs integrate) and lum [NMi, NMo, NP]
    luminance lattice for the phi conditional."""
    lum = grid.astype(np.float64) @ np.asarray([0.2126, 0.7152, 0.0722])
    nm = lum.shape[0]
    mu_axis = np.linspace(-1.0, 1.0, nm)
    a0 = lum.mean(-1) * np.abs(mu_axis)[:, None]
    a0 = a0 + max(a0.max(), 1e-9) * 1e-5               # coverage floor
    return (a0.astype(np.float32),
            np.maximum(lum, lum.max() * 1e-6).astype(np.float32))


def _axis_lookup(x, lo_v, hi_v, n):
    t = torch.clamp((x - lo_v) / (hi_v - lo_v) * (n - 1), 0.0, n - 1 - 1e-4)
    i0 = torch.floor(t).to(torch.int64)
    return i0, t - i0


def _cos_dphi(wo, wi):
    """cos of the azimuth between -wi and wo in the tangent plane."""
    xi, yi = -wi[..., 0], -wi[..., 1]
    xo, yo = wo[..., 0], wo[..., 1]
    li = torch.sqrt(xi * xi + yi * yi)
    lo = torch.sqrt(xo * xo + yo * yo)
    return torch.where((li > 1e-9) & (lo > 1e-9),
                       torch.clamp((xi * xo + yi * yo)
                                   / torch.clamp(li * lo, min=1e-9), -1, 1),
                       1.0)


def eval_grid(grid, wo, wi):
    """f(wo, wi) -> RGB [B,3], trilinear in the baked lattice.

    Axes: muI = cos theta(-wi), muO = cos theta(wo), phi = the azimuth
    between -wi and wo: FourierBSDF::f's conventions."""
    nm, _, npphi, _ = grid.shape
    i0, fi = _axis_lookup(-wi[..., 2], -1.0, 1.0, nm)
    o0, fo = _axis_lookup(wo[..., 2], -1.0, 1.0, nm)
    p0, fp = _axis_lookup(torch.arccos(_cos_dphi(wo, wi)), 0.0, np.pi,
                          npphi)
    out = 0.0
    for di in (0, 1):
        for do in (0, 1):
            for dp in (0, 1):
                w = ((fi if di else 1 - fi) * (fo if do else 1 - fo)
                     * (fp if dp else 1 - fp))
                out = out + w[..., None] * grid[i0 + di, o0 + do, p0 + dp]
    return out


# ---------------------------------------------------------------------------
# Catmull-Rom cdf inversion (the reference's SampleCatmullRom2D and its
# Fourier phi inversion, interpolation.cpp:172-300 / reflection.cpp:
# 491-573) over the baked lattice's marginals: the sampling density is
# the Catmull-Rom interpolant of the marginals, each segment's integral
# exact, inverted by a fixed number of Newton-bisection steps
# ---------------------------------------------------------------------------

_CR_NEWTON_ITERS = 12


def _cr_derivs(F):
    """Each cell's endpoint derivatives of the Catmull-Rom interpolant on
    a uniform lattice, pbrt's finite differences (interpolation.cpp:
    266-276): F [..., N] -> (d0, d1) [..., N-1], in cell widths."""
    interior = (F[..., 2:] - F[..., :-2]) * 0.5
    edge0 = F[..., 1:2] - F[..., 0:1]
    edge1 = F[..., -1:] - F[..., -2:-1]
    return (torch.cat([edge0, interior], -1),
            torch.cat([interior, edge1], -1))


def _cr_cell_integrals(F):
    """The spline's exact integral over each cell, in cell widths
    (IntegrateCatmullRom, interpolation.cpp:260-283)."""
    f0, f1 = F[..., :-1], F[..., 1:]
    d0, d1 = _cr_derivs(F)
    return (d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5


def _take(A, i):
    return torch.gather(A, -1, i[..., None])[..., 0]


def _cr_sample_1d(F, u):
    """x ~ the Catmull-Rom interpolant of F [B,N] over [0, N-1], u [B].
    Returns (x [B] in cell units, the interpolant's value there, its
    integral [B]): the pdf per cell unit is value / integral."""
    I = torch.clamp(_cr_cell_integrals(F), min=0.0)
    cdf = torch.cumsum(torch.cat([torch.zeros_like(I[..., :1]), I], -1), -1)
    total = torch.clamp(cdf[..., -1], min=1e-12)
    up = u * total
    idx = torch.clamp((cdf <= up[..., None]).sum(-1) - 1, 0,
                      F.shape[-1] - 2)
    f0 = _take(F, idx)
    f1 = _take(F, idx + 1)
    d0a, d1a = _cr_derivs(F)
    d0 = _take(d0a, idx)
    d1 = _take(d1a, idx)
    uu = up - _take(cdf, idx)                          # in cell units
    # the first guess inverts the linear interpolant
    steep = torch.abs(f0 - f1) > 1e-12
    lin = torch.where(
        steep,
        (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * uu * (f1 - f0),
                                     min=0.0)))
        / torch.where(steep, f0 - f1, 1.0),
        uu / torch.clamp(f0, min=1e-12))
    t = torch.clamp(lin, 0.0, 1.0)
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    fhat = f0
    for _ in range(_CR_NEWTON_ITERS):
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2.0 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                                   + t * (d0 + d1 + 2.0 * (f0 - f1))))
        below = Fhat - uu < 0
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        t = t - (Fhat - uu) / torch.where(torch.abs(fhat) > 1e-12, fhat, 1.0)
    t = torch.clamp(torch.where(torch.isfinite(t), t, 0.5), 0.0, 1.0)
    return idx.to(F.dtype) + t, torch.clamp(fhat, min=0.0), total


def _cr_eval_1d(F, x):
    """The interpolant's value at x [B] (cell units) and its integral:
    the pdf side of _cr_sample_1d."""
    N = F.shape[-1]
    idx = torch.clamp(x.to(torch.int64), 0, N - 2)
    t = torch.clamp(x - idx.to(F.dtype), 0.0, 1.0)
    f0 = _take(F, idx)
    f1 = _take(F, idx + 1)
    d0a, d1a = _cr_derivs(F)
    d0 = _take(d0a, idx)
    d1 = _take(d1a, idx)
    fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                               + t * (d0 + d1 + 2.0 * (f0 - f1))))
    I = torch.clamp(_cr_cell_integrals(F), min=0.0)
    total = torch.clamp(I.sum(-1), min=1e-12)
    return torch.clamp(fhat, min=0.0), total


def _cr_weights_uniform(x, n):
    """CatmullRomWeights (interpolation.cpp:47) on the uniform [0, n-1]
    lattice: (offset [B] = idx - 1, which may be -1, and w [B,4]) with
    sum_k w[k] F[clip(offset + k, 0, n-1)] the interpolant at x; a tap
    out of range carries weight 0, so clipping its index is safe."""
    idx = torch.clamp(x.to(torch.int64), 0, n - 2)
    t = torch.clamp(x - idx.to(x.dtype), 0.0, 1.0)
    t2, t3 = t * t, t * t * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    w0t = t3 - 2 * t2 + t
    w3t = t3 - t2
    first = idx == 0
    last = idx + 2 >= n
    w0 = torch.where(first, 0.0, -0.5 * w0t)
    w1f = (w1 - torch.where(first, w0t, 0.0)
           - torch.where(last, w3t, 0.5 * w3t))
    w2f = (w2 + torch.where(first, w0t, 0.5 * w0t)
           + torch.where(last, w3t, 0.0))
    w3 = torch.where(last, 0.0, 0.5 * w3t)
    return idx - 1, torch.stack([w0, w1f, w2f, w3], -1)


def _cr_taps(off, n):
    """The clipped 4-tap indices of a _cr_weights_uniform offset."""
    return torch.clamp(off[..., None] + torch.arange(4, device=off.device),
                       0, n - 1)


def _mu_conditional(a0, wo):
    """(F_mu [B,NMi]: the muI marginal's nodes at wo's muO, muO's offset
    and weights)."""
    nm = a0.shape[0]
    o_off, o_w = _cr_weights_uniform((wo[..., 2] + 1.0) * 0.5 * (nm - 1),
                                     nm)
    rows = a0.T[_cr_taps(o_off, nm)]                   # [B,4,NMi]
    F_mu = torch.clamp(torch.einsum('bk,bkn->bn', o_w, rows), min=0.0)
    return F_mu, o_off, o_w


def _phi_conditional(lum, o_off, o_w, x_mu):
    """The phi conditional's nodes [B,NP]: Catmull-Rom in both mu axes."""
    nm = lum.shape[0]
    i_off, i_w = _cr_weights_uniform(x_mu, nm)
    rows2 = lum.transpose(0, 1)[_cr_taps(o_off, nm)[..., :, None],
                                _cr_taps(i_off, nm)[..., None, :]]
    return torch.clamp(torch.einsum('bk,bl,bklp->bp', o_w, i_w,
                                    torch.clamp(rows2, min=0.0)), min=0.0)


def sample_grid_cr(a0, lum, wo, u_sign, u1, u2):
    """wi [B,3] drawn from the Catmull-Rom interpolated lattice marginals
    (SampleCatmullRom2D's twin); a0 [NMi,NMo], lum [NMi,NMo,NP].  Its
    density is pdf_grid_cr's."""
    nm = a0.shape[0]
    npphi = lum.shape[2]
    F_mu, o_off, o_w = _mu_conditional(a0, wo)
    x_mu, _, _ = _cr_sample_1d(F_mu, u1)
    mu_i = -1.0 + x_mu * (2.0 / (nm - 1))
    x_phi, _, _ = _cr_sample_1d(_phi_conditional(lum, o_off, o_w, x_mu), u2)
    dphi = x_phi * (np.pi / (npphi - 1))
    sgn = torch.where(u_sign < 0.5, 1.0, -1.0)
    phi_w = torch.atan2(wo[..., 1], wo[..., 0]) + sgn * dphi
    sin_i = torch.sqrt(torch.clamp(1.0 - mu_i * mu_i, min=0.0))
    # mu_i parameterises -wi (eval_grid's convention)
    return -torch.stack([sin_i * torch.cos(phi_w), sin_i * torch.sin(phi_w),
                         mu_i], -1)


def pdf_grid_cr(a0, lum, wo, wi):
    """The solid-angle density of sample_grid_cr at (wo, wi): the
    interpolants' values over their integrals in mu and phi (dw = dmu
    dphi), halved for the azimuth's mirror."""
    nm = a0.shape[0]
    npphi = lum.shape[2]
    F_mu, o_off, o_w = _mu_conditional(a0, wo)
    x_mu = (-wi[..., 2] + 1.0) * 0.5 * (nm - 1)
    f_mu, tot_mu = _cr_eval_1d(F_mu, x_mu)
    pdf_mu = f_mu / (tot_mu * (2.0 / (nm - 1)))
    dphi = torch.arccos(_cos_dphi(wo, wi))
    f_phi, tot_phi = _cr_eval_1d(_phi_conditional(lum, o_off, o_w, x_mu),
                                 dphi / np.pi * (npphi - 1))
    pdf_phi = f_phi / (tot_phi * (np.pi / (npphi - 1)))
    return 0.5 * torch.clamp(pdf_mu, min=0.0) * torch.clamp(pdf_phi, min=0.0)
