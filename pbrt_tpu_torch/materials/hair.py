"""Hair BSDF: the Chiang et al. 2016 model as the reference implements it
(port of pbrt_tpu.materials.hair; reference materials/hair.{h,cpp}):
longitudinal lobes Mp (the modified-Bessel form), azimuthal lobes Np (a
trimmed logistic about the specular azimuth Phi(p)) and attenuations Ap
(Fresnel at entry, absorption along the internal segments), for p = 0
(R), 1 (TT), 2 (TRT) and a residual lobe for p >= 3.

Directions are in the hair frame: +x along the fiber, (y, z) the normal
plane; h in [-1, 1] is where the ray crosses the fiber's width (curves
give v across it, h = 2v - 1).  sigma_a is a spectrum [..., S].
"""
from __future__ import annotations

import numpy as np
import torch

PI = np.pi
P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def beta_m_to_v(beta_m):
    """Longitudinal roughness -> the lobes' variances [..., P_MAX+1]
    (hair.cpp:258)."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2
          + 3.7 * beta_m ** 20) ** 2
    return torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], -1)


def beta_n_to_s(beta_n):
    """Azimuthal roughness -> the logistic's scale (hair.cpp:269)."""
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                             + 5.372 * beta_n ** 22)


# ---------------------------------------------------------------------------
# the longitudinal lobe Mp (hair.cpp:100-121)
# ---------------------------------------------------------------------------

def _i0(x):
    """Modified Bessel I0 by its first 10 series terms (hair.cpp:86-97)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    for i in range(10):
        if i > 0:
            ifact *= i
        val = val + x2i / (ifact * ifact)
        x2i = x2i * 0.25 * x * x
    return val


def _log_i0(x):
    """log I0: the series below 12, the asymptote x - log(2 pi x) / 2
    above."""
    x = torch.abs(x)
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    large = x + 0.5 * (-np.log(2 * PI)
                       + torch.log(1.0 / torch.clamp(x, min=1e-6))
                       + 1.0 / torch.clamp(8 * x, min=1e-6))
    return torch.where(x > 12.0, large, small)


def mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """The longitudinal scattering density in theta_i (hair.cpp:103-114)."""
    v = torch.clamp(v, min=1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    stable = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                       + torch.log(1.0 / (2.0 * v)))
    direct = (torch.exp(-b) * _i0(a)
              / (2.0 * v * torch.sinh(1.0 / torch.clamp(v, min=1e-5))))
    return torch.where(v <= 0.1, stable, direct)


# ---------------------------------------------------------------------------
# the azimuthal lobe Np (hair.cpp:123-166)
# ---------------------------------------------------------------------------

def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _phi(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def np_lobe(phi, p, s, gamma_o, gamma_t):
    """The azimuthal density about lobe p's specular azimuth
    (hair.cpp:158-166), wrapped to (-pi, pi]."""
    dphi = phi - _phi(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + PI, 2 * PI) - PI
    return trimmed_logistic(dphi, s, -PI, PI)


def sample_trimmed_logistic(u, s, a, b):
    """Inverse-cdf sample of the trimmed logistic (hair.cpp:183-190)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(a, s),
                                         1e-6, 1 - 1e-6) - 1.0)
    return torch.clamp(x, a, b)


# ---------------------------------------------------------------------------
# the attenuations Ap (hair.cpp:128-156), spectral [..., S]
# ---------------------------------------------------------------------------

def _fr_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = torch.clamp(1.0 - cos_i ** 2, min=0.0) / eta ** 2
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-14))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t,
                                                min=1e-6)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                 min=1e-6)
    return torch.where(sin2_t >= 1.0, 1.0,
                       0.5 * (r_par ** 2 + r_perp ** 2))


def ap(cos_to, eta, h, T):
    """The lobes' attenuations [..., P_MAX+1, S] (hair.cpp:128-147); T is
    one segment's transmittance [..., S]."""
    cos_go = torch.sqrt(torch.clamp(1.0 - h * h, min=1e-14))
    cos_t = cos_to * cos_go          # the full angle at the entry
    f = _fr_dielectric(cos_t, eta)[..., None]
    a0 = f.expand(T.shape)
    a1 = (1.0 - f) ** 2 * T
    a2 = a1 * T * f
    # the residual lobe: the tail of the geometric series
    a3 = a2 * f * T / torch.clamp(1.0 - f * T, min=1e-4)
    return torch.stack([a0, a1, a2, a3], -2)


# ---------------------------------------------------------------------------
# the BSDF
# ---------------------------------------------------------------------------

def _dir_angles(w):
    """(sin theta, cos theta, phi) with x the fiber's axis."""
    sin_t = torch.clamp(w[..., 0], -1.0, 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t ** 2, min=1e-14))
    return sin_t, cos_t, torch.atan2(w[..., 2], w[..., 1])


def _tilted(sin_to, cos_to, p, alpha):
    """Lobe p's scale tilt, a rotation by 2^p alpha (hair.cpp:337)."""
    shift = {0: -2.0, 1: 1.0, 2: 4.0}[p] * alpha
    s, c = torch.sin(shift), torch.cos(shift)
    return sin_to * c + cos_to * s, torch.abs(cos_to * c - sin_to * s)


def _tensors(ref, *xs):
    """Scalar parameters as tensors on ref's device (the lanes' own [B]
    tensors pass through)."""
    return tuple(torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
                 for x in xs)


def _fiber(wo, h, sigma_a, eta):
    """The per-lane terms every entry point needs: wo's angles, the
    refracted azimuths gamma_o / gamma_t and the segment transmittance."""
    sin_to, cos_to, phi_o = _dir_angles(wo)
    etap = torch.sqrt(torch.clamp(eta ** 2 - sin_to ** 2, min=1e-6)) \
        / torch.clamp(cos_to, min=1e-6)
    sin_gt = torch.clamp(h / etap, -1.0, 1.0)
    cos_gt = torch.sqrt(torch.clamp(1.0 - sin_gt ** 2, min=1e-14))
    gamma_o = torch.asin(torch.clamp(h, -1.0, 1.0))
    gamma_t = torch.asin(sin_gt)
    # the refracted longitudinal angle, for the path length inside
    sin_tt = sin_to / eta
    cos_tt = torch.sqrt(torch.clamp(1.0 - sin_tt ** 2, min=1e-14))
    T = torch.exp(-sigma_a * (2.0 * cos_gt
                              / torch.clamp(cos_tt, min=1e-4))[..., None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, T


def _ap_pdf(cos_to, eta, h, T):
    """The lobe-selection pdf, from the spectrum-averaged Ap
    (hair.cpp:351)."""
    a = ap(cos_to, eta, h, T).mean(-1)              # [...,4]
    return a / torch.clamp(a.sum(-1, keepdim=True), min=1e-9)


def hair_eval(wo, wi, h, sigma_a, eta=1.55, beta_m=0.3, beta_n=0.3,
              alpha=2.0 * PI / 180):
    """f(wo, wi) [..., S] in the hair frame (HairBSDF::f, hair.cpp:288)."""
    eta, beta_m, beta_n, alpha = _tensors(wo, eta, beta_m, beta_n, alpha)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _fiber(wo, h, sigma_a, eta)
    sin_ti, cos_ti, phi_i = _dir_angles(wi)
    phi = phi_i - phi_o
    v = beta_m_to_v(beta_m)
    s = beta_n_to_s(beta_n)
    a = ap(cos_to, eta, h, T)                       # [...,4,S]
    f = torch.zeros_like(T)
    for p in range(P_MAX):
        sin_tp, cos_tp = _tilted(sin_to, cos_to, p, alpha)
        m = mp(cos_ti, cos_tp, sin_ti, sin_tp, v[..., p])
        n = np_lobe(phi, p, s, gamma_o, gamma_t)
        f = f + (m * n)[..., None] * a[..., p, :]
    # the residual lobe: a uniform azimuth
    m3 = mp(cos_ti, cos_to, sin_ti, sin_to, v[..., P_MAX])
    f = f + (m3 / (2.0 * PI))[..., None] * a[..., P_MAX, :]
    return f / torch.clamp(torch.abs(wi[..., 2]), min=1e-4)[..., None]


def hair_pdf(wo, wi, h, sigma_a, eta=1.55, beta_m=0.3, beta_n=0.3,
             alpha=2.0 * PI / 180):
    """The solid-angle pdf of hair_sample (HairBSDF::Pdf, hair.cpp:465)."""
    eta, beta_m, beta_n, alpha = _tensors(wo, eta, beta_m, beta_n, alpha)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _fiber(wo, h, sigma_a, eta)
    sin_ti, cos_ti, phi_i = _dir_angles(wi)
    phi = phi_i - phi_o
    v = beta_m_to_v(beta_m)
    s = beta_n_to_s(beta_n)
    apdf = _ap_pdf(cos_to, eta, h, T)
    pdf = torch.zeros_like(cos_to)
    for p in range(P_MAX):
        sin_tp, cos_tp = _tilted(sin_to, cos_to, p, alpha)
        m = mp(cos_ti, cos_tp, sin_ti, sin_tp, v[..., p])
        n = np_lobe(phi, p, s, gamma_o, gamma_t)
        pdf = pdf + m * n * apdf[..., p]
    m3 = mp(cos_ti, cos_to, sin_ti, sin_to, v[..., P_MAX])
    return pdf + m3 / (2.0 * PI) * apdf[..., P_MAX]


def hair_sample(wo, h, sigma_a, u, eta=1.55, beta_m=0.3, beta_n=0.3,
                alpha=2.0 * PI / 180):
    """Importance-sample wi (HairBSDF::Sample_f, hair.cpp:389); u [..., 4]:
    the lobe, two for theta, one for phi.  Returns (wi, f, pdf)."""
    eta, beta_m, beta_n, alpha = _tensors(wo, eta, beta_m, beta_n, alpha)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _fiber(wo, h, sigma_a, eta)
    v = beta_m_to_v(beta_m)
    s = beta_n_to_s(beta_n)
    apdf = _ap_pdf(cos_to, eta, h, T)               # [...,4]
    cdf = torch.cumsum(apdf, -1)
    p_sel = (u[..., 0:1] > cdf).sum(-1)             # [...]: 0..3

    # the chosen lobe's tilted angles and variance
    sin_tp, cos_tp = sin_to, cos_to                 # the residual's
    for p in reversed(range(P_MAX)):
        a_, b_ = _tilted(sin_to, cos_to, p, alpha)
        sin_tp = torch.where(p_sel == p, a_, sin_tp)
        cos_tp = torch.where(p_sel == p, b_, cos_tp)
    vp = torch.gather(v.expand(p_sel.shape + (P_MAX + 1,)), -1,
                      p_sel[..., None])[..., 0]

    # the longitudinal sample (hair.cpp:414-422)
    u0 = torch.clamp(u[..., 1], 1e-5, 1.0)
    cos_theta = 1.0 + vp * torch.log(
        u0 + (1.0 - u0) * torch.exp(-2.0 / torch.clamp(vp, min=1e-5)))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=1e-14))
    cos_phi_l = torch.cos(2.0 * PI * u[..., 2])
    sin_ti = -cos_theta * sin_tp + sin_theta * cos_phi_l * cos_tp
    cos_ti = torch.sqrt(torch.clamp(1.0 - sin_ti ** 2, min=1e-14))

    # the azimuthal sample
    dphi_peak = _phi(p_sel.to(torch.float32), gamma_o, gamma_t)
    dphi_smp = sample_trimmed_logistic(u[..., 3], s, -PI, PI)
    dphi = torch.where(p_sel < P_MAX, dphi_peak + dphi_smp,
                       2.0 * PI * u[..., 3])
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], -1)
    f = hair_eval(wo, wi, h, sigma_a, eta, beta_m, beta_n, alpha)
    pdf = hair_pdf(wo, wi, h, sigma_a, eta, beta_m, beta_n, alpha)
    return wi, f, pdf
