"""Hosek-Wilkie analytic spectral sky-dome + solar radiance model (port
of pbrt_tpu.lights.hosek; host numpy, the JAX package's code).

Reference: ext/ArHosekSkyModel.c (BSD-licensed sample implementation of
Hosek & Wilkie, "An Analytic Model for Full Spectral Sky-Dome Radiance",
SIGGRAPH 2012, + the 2013 solar radiance extension); used by
`imgtool makesky` (tools/imgtool.cpp:87-188).

The reference evaluates one (theta, gamma, wavelength) scalar at a time
under a ParallelFor; here the whole sky dome is one broadcast numpy
evaluation on the host (env maps are made before a render).  The fitted
coefficient tables are read by path from `pbrt_tpu/data/hosek.npz`:

  datasets      [11 wl, 2 albedo, 10 turbidity, 6 elev-ctrl, 9 coefs]
  datasets_rad  [11, 2, 10, 6]      zenith radiance scale
  solar         [11, 10 turbidity, 45 pieces, 4 poly coefs]
  limb          [11, 6]             solar limb-darkening polynomials

Wavelength grid: 320..720nm step 40.
"""

from __future__ import annotations

import os

import numpy as np

from pbrt_tpu_torch import DATA_DIR

_DATA = None
TERRESTRIAL_SOLAR_RADIUS = np.radians(0.51) / 2.0


def _data():
    global _DATA
    if _DATA is None:
        _DATA = dict(np.load(os.path.join(DATA_DIR, "hosek.npz")))
    return _DATA


def _quintic_bezier(ctrl, x):
    """ctrl [..., 6, ...] evaluated at x along axis -2 of the 6 control
    points (ArHosekSkyModel_CookConfiguration's explicit expansion)."""
    c = [ctrl[..., k, :] if ctrl.ndim == 4 else ctrl[..., k]
         for k in range(6)]
    ix = 1.0 - x
    return (ix ** 5 * c[0] + 5 * ix ** 4 * x * c[1]
            + 10 * ix ** 3 * x ** 2 * c[2] + 10 * ix ** 2 * x ** 3 * c[3]
            + 5 * ix * x ** 4 * c[4] + x ** 5 * c[5])


def sky_model_state(solar_elevation, turbidity, albedo):
    """Cook the per-wavelength configuration (9 coefs) + radiance scale
    (alloc_init + CookConfiguration/CookRadianceConfiguration,
    ArHosekSkyModel.c:147-345).  Returns dict."""
    d = _data()
    t = np.clip(float(turbidity), 1.0, 10.0)
    a = np.clip(float(albedo), 0.0, 1.0)
    elev = float(solar_elevation)
    int_t = min(int(t), 10)
    frac_t = t - int_t
    x = (elev / (np.pi / 2.0)) ** (1.0 / 3.0)

    def cook(table):                     # [11,2,10,6,(9)]
        lo = _quintic_bezier(table[:, :, int_t - 1], x)     # [11,2,(9)]
        blend_a = (1 - a) * lo[:, 0] + a * lo[:, 1]
        if int_t < 10 and frac_t > 0:
            hi = _quintic_bezier(table[:, :, int_t], x)
            blend_b = (1 - a) * hi[:, 0] + a * hi[:, 1]
            return (1 - frac_t) * blend_a + frac_t * blend_b
        return blend_a

    return dict(configs=cook(d["datasets"]),          # [11,9]
                radiances=cook(d["datasets_rad"]),    # [11]
                turbidity=t, elevation=elev,
                solar_radius=TERRESTRIAL_SOLAR_RADIUS)


def _radiance_internal(config, theta, gamma):
    """The 9-coefficient distribution F(theta,gamma)
    (ArHosekSkyModel_GetRadianceInternal).  config [9]; theta/gamma
    broadcastable arrays."""
    A, B, C, D, E, F, G, H, I = [config[i] for i in range(9)]
    cg = np.cos(gamma)
    ct = np.maximum(np.cos(theta), 0.0)
    exp_m = np.exp(E * gamma)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.maximum(
        (1.0 + H * H - 2.0 * H * cg), 1e-12) ** 1.5
    zenith = np.sqrt(ct)
    return ((1.0 + A * np.exp(B / (ct + 0.01)))
            * (C + D * exp_m + F * ray_m + G * mie_m + I * zenith))


def sky_radiance(state, theta, gamma, wavelength):
    """In-scattered sky radiance, linear interp over the 40nm wavelength
    grid (arhosekskymodel_radiance)."""
    wl = np.asarray(wavelength, np.float64)
    lw = np.clip(((wl - 320.0) / 40.0).astype(int), 0, 10)
    fw = np.clip((wl - 320.0) / 40.0 - lw, 0.0, 1.0)

    def one(i):
        return (_radiance_internal(state["configs"][i], theta, gamma)
                * state["radiances"][i])

    if np.ndim(wl) == 0:
        lwi = int(lw)
        v = one(lwi)
        if fw > 1e-6 and lwi + 1 < 11:
            v = (1 - fw) * v + fw * one(lwi + 1)
        return np.where((wl >= 320) & (wl <= 720), v, 0.0)
    # vector wavelength: evaluate both brackets per element
    out = np.zeros(np.broadcast_shapes(np.shape(theta), wl.shape))
    for i in range(11):
        m_lo = lw == i
        m_hi = (lw == i - 1) & (fw > 1e-6)
        if m_lo.any() or m_hi.any():
            v = one(i)
            out = out + np.where(m_lo, (1 - fw) * v, 0.0) \
                + np.where(m_hi, fw * v, 0.0)
    return np.where((wl >= 320) & (wl <= 720), out, 0.0)


def _sr_internal(state, turb0, wl_idx, elevation):
    """Direct solar radiance piecewise cubic (arhosekskymodel_sr_internal);
    turb0 is the 0-based turbidity bracket."""
    d = _data()
    pieces = 45
    pos = np.minimum((np.cbrt(2.0 * elevation / np.pi)
                      * pieces).astype(int), 44)
    break_x = (pos / pieces) ** 3 * (np.pi * 0.5)
    x = elevation - break_x
    coefs = d["solar"][wl_idx, turb0, pos]     # [...,4]; read backwards
    return (coefs[..., 3] + x * (coefs[..., 2]
            + x * (coefs[..., 1] + x * coefs[..., 0])))


def solar_disc_radiance(state, wavelength, elevation, gamma):
    """Limb-darkened direct solar radiance inside the disc
    (arhosekskymodel_solar_radiance_internal2)."""
    d = _data()
    wl = np.asarray(wavelength, np.float64)
    sin_rad = np.sin(state["solar_radius"])
    ar2 = 1.0 / (sin_rad * sin_rad)
    sg = np.sin(gamma)
    sc2 = np.maximum(1.0 - ar2 * sg * sg, 0.0)
    sample_cos = np.sqrt(sc2)

    turb_low = int(state["turbidity"]) - 1
    turb_frac = state["turbidity"] - (turb_low + 1)
    if turb_low == 9:
        turb_low, turb_frac = 8, 1.0
    wl_low = np.clip(((wl - 320.0) / 40.0).astype(int), 0, 10)
    wl_frac = np.mod(wl, 40.0) / 40.0
    wl_frac = np.where(wl_low == 10, 1.0, wl_frac)
    wl_low = np.where(wl_low == 10, 9, wl_low)

    def sr(t0, wli):
        return _sr_internal(state, t0, wli, elevation)

    direct = ((1 - turb_frac) * ((1 - wl_frac) * sr(turb_low, wl_low)
                                 + wl_frac * sr(turb_low, wl_low + 1))
              + turb_frac * ((1 - wl_frac) * sr(turb_low + 1, wl_low)
                             + wl_frac * sr(turb_low + 1, wl_low + 1)))
    ld = ((1 - wl_frac)[..., None] * d["limb"][wl_low]
          + wl_frac[..., None] * d["limb"][np.minimum(wl_low + 1, 10)])
    dark = sum(ld[..., i] * sample_cos ** i for i in range(6))
    return np.where(sample_cos > 0.0, direct * dark, 0.0)


def solar_radiance(state, theta, gamma, wavelength):
    """Sky + solar disc (arhosekskymodel_solar_radiance)."""
    direct = solar_disc_radiance(state, wavelength,
                                 (np.pi / 2.0) - theta, gamma)
    return direct + sky_radiance(state, theta, gamma, wavelength)


def make_sky_image(resolution=512, turbidity=3.0, albedo=0.5,
                   elevation_deg=10.0, with_sun=True):
    """Lat-long RGB sky env map exactly like `imgtool makesky`
    (imgtool.cpp:142-185): 9 wavelengths averaged 3-per-RGB-channel;
    below-horizon rows stay black.  Returns [H, 2H, 3] float32."""
    elev = np.radians(elevation_deg)
    state = sky_model_state(elev, turbidity, albedo)
    lam = np.array([630, 680, 710, 500, 530, 560, 460, 480, 490],
                   np.float64)
    H, W = resolution, 2 * resolution
    theta = (np.arange(H) + 0.5) / H * np.pi
    phi = (np.arange(W) + 0.5) / W * 2.0 * np.pi
    T, P = np.meshgrid(theta, phi, indexing="ij")
    sun = np.array([0.0, np.sin(elev), np.cos(elev)])
    v = np.stack([np.cos(P) * np.sin(T), np.cos(T), np.sin(P) * np.sin(T)],
                 -1)
    gamma = np.arccos(np.clip(v @ sun, -1, 1))
    img = np.zeros((H, W, 3), np.float64)
    above = T <= np.pi / 2.0
    Ta = np.where(above, T, np.pi / 2.0)
    for c in range(9):
        if with_sun:
            val = solar_radiance(state, Ta, gamma, lam[c])
        else:
            val = sky_radiance(state, Ta, gamma, lam[c])
        img[..., c // 3] += np.where(above, val, 0.0) / 3.0
    return img.astype(np.float32)
