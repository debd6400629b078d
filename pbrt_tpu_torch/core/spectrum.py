"""Sampled-spectrum radiometry (port of pbrt_tpu.core.spectrum).

31 bins over 395-705 nm; a spectrum is the trailing axis of a tensor.
The CIE observer, the Smits RGB bases and the Apple-LCD primaries are
read from the JAX package's data tables with the same bin-averaging.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pbrt_tpu_torch import DATA_DIR

LAMBDA_START = 395.0
LAMBDA_END = 705.0
N_SPECTRAL_SAMPLES = 31

_EDGES = np.linspace(LAMBDA_START, LAMBDA_END, N_SPECTRAL_SAMPLES + 1)
BIN_CENTERS = 0.5 * (_EDGES[:-1] + _EDGES[1:])
BIN_WIDTH = (LAMBDA_END - LAMBDA_START) / N_SPECTRAL_SAMPLES


def _load_cie_tables():
    """Measured CIE 1931 tables (data/cie_1931.npz), bin-averaged."""
    d = np.load(os.path.join(DATA_DIR, "cie_1931.npz"))
    out = np.zeros((3, N_SPECTRAL_SAMPLES))
    for i in range(N_SPECTRAL_SAMPLES):
        xs = np.linspace(_EDGES[i], _EDGES[i + 1], 17)
        for c, ch in enumerate(("x", "y", "z")):
            out[c, i] = np.interp(xs, d["lam"], d[ch]).mean()
    return out


CIE_X, CIE_Y, CIE_Z = _load_cie_tables()
CIE_Y_INTEGRAL = float(np.sum(CIE_Y) * BIN_WIDTH)

XYZ_TO_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])
RGB_TO_XYZ = np.linalg.inv(XYZ_TO_RGB)


def _load_rgb2spect():
    """Smits basis tables (data/rgb2spect.npz) with the FromRGB trailing
    scales folded in, as the JAX package loads them."""
    d = np.load(os.path.join(DATA_DIR, "rgb2spect.npz"))
    names = ("white", "cyan", "magenta", "yellow", "red", "green", "blue")
    refl = {k: d[f"refl_{k}"].astype(np.float64) * float(d["refl_scale"])
            for k in names}
    illum = {k: d[f"illum_{k}"].astype(np.float64) * float(d["illum_scale"])
             for k in names}
    return refl, illum


_REFL_BASES, _ILLUM_BASES = _load_rgb2spect()


def _load_display_primaries():
    """Apple-LCD primaries (data/lcd_apple.npz), bin-averaged and balanced
    so equal drive gives the sRGB white."""
    d = np.load(os.path.join(DATA_DIR, "lcd_apple.npz"))
    prim = np.zeros((3, N_SPECTRAL_SAMPLES))
    for i, c in enumerate(BIN_CENTERS):
        xs = np.linspace(c - BIN_WIDTH / 2, c + BIN_WIDTH / 2, 17)
        for j, ch in enumerate(("r", "g", "b")):
            prim[j, i] = np.interp(xs, d["lam"], d[ch]).mean()
    cie = np.stack([CIE_X, CIE_Y, CIE_Z], 0)
    M = (cie @ prim.T) * (BIN_WIDTH / CIE_Y_INTEGRAL)
    s = np.linalg.solve(M, RGB_TO_XYZ @ np.ones(3))
    return prim * s[:, None]


_DISPLAY_PRIM = _load_display_primaries()


def from_rgb_np(rgb, kind="reflectance"):
    """Host-side RGB -> [..., 31] spectrum (Smits decomposition;
    kind: "reflectance" | "illuminant" | "display")."""
    rgb = np.asarray(rgb, np.float64)
    if kind == "display":
        return np.maximum(rgb @ _DISPLAY_PRIM, 0.0).astype(np.float32)
    B = _REFL_BASES if kind == "reflectance" else _ILLUM_BASES
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    s_r_gb = np.where(g <= b,
                      r * B["white"] + (g - r) * B["cyan"] + (b - g) * B["blue"],
                      r * B["white"] + (b - r) * B["cyan"] + (g - b) * B["green"])
    s_g_rb = np.where(r <= b,
                      g * B["white"] + (r - g) * B["magenta"] + (b - r) * B["blue"],
                      g * B["white"] + (b - g) * B["magenta"] + (r - b) * B["red"])
    s_b_rg = np.where(r <= g,
                      b * B["white"] + (r - b) * B["yellow"] + (g - r) * B["green"],
                      b * B["white"] + (g - b) * B["yellow"] + (r - g) * B["red"])
    s = np.where((r <= g) & (r <= b), s_r_gb,
                 np.where((g <= r) & (g <= b), s_g_rb, s_b_rg))
    return np.maximum(s, 0.0).astype(np.float32)


def from_rgb(rgb, kind="reflectance"):
    """Device-side [..., 3] RGB -> [..., 31] spectrum: from_rgb_np's
    decomposition on tensors (the JAX package's spectrum.from_rgb)."""
    if kind == "display":
        prim = torch.as_tensor(_DISPLAY_PRIM, dtype=rgb.dtype,
                               device=rgb.device)
        return torch.clamp(rgb @ prim, min=0.0)
    B = {k: torch.as_tensor(v, dtype=rgb.dtype, device=rgb.device)
         for k, v in (_REFL_BASES if kind == "reflectance"
                      else _ILLUM_BASES).items()}
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    s_r_gb = torch.where(
        g <= b, r * B["white"] + (g - r) * B["cyan"] + (b - g) * B["blue"],
        r * B["white"] + (b - r) * B["cyan"] + (g - b) * B["green"])
    s_g_rb = torch.where(
        r <= b, g * B["white"] + (r - g) * B["magenta"] + (b - r) * B["blue"],
        g * B["white"] + (b - g) * B["magenta"] + (r - b) * B["red"])
    s_b_rg = torch.where(
        r <= g, b * B["white"] + (r - b) * B["yellow"] + (g - r) * B["green"],
        b * B["white"] + (g - b) * B["yellow"] + (r - g) * B["red"])
    s = torch.where((r <= g) & (r <= b), s_r_gb,
                    torch.where((g <= r) & (g <= b), s_g_rb, s_b_rg))
    return torch.clamp(s, min=0.0)


def to_rgb_np(s):
    """Host-side [..., 31] spectrum -> linear RGB (float32)."""
    w = np.stack([CIE_X, CIE_Y, CIE_Z], -1)
    xyz = np.asarray(s, np.float64) @ w * (BIN_WIDTH / CIE_Y_INTEGRAL)
    return (xyz @ XYZ_TO_RGB.T).astype(np.float32)


def from_sampled(lambdas, values, n_sub=8):
    """Piecewise-linear SPD (lambda, value) samples -> binned [31] spectrum:
    the interpolant averaged over each bin, constant beyond the sampled
    range (the reference's AverageSpectrumSamples)."""
    lambdas = np.asarray(lambdas, dtype=np.float64).reshape(-1)
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    out = np.zeros(N_SPECTRAL_SAMPLES)
    for i in range(N_SPECTRAL_SAMPLES):
        lam = np.linspace(_EDGES[i], _EDGES[i + 1], n_sub * 4 + 1)
        v = np.interp(lam, lambdas, values)
        out[i] = np.trapezoid(v, lam) / (_EDGES[i + 1] - _EDGES[i])
    return out


def value_at_wavelength(s, lam):
    """Point-evaluate binned spectra s [..., 31] at wavelengths lam (nm)
    by linear interpolation between bin centres, clamped to the first
    and last centre (the fork's GetValueAtWavelength, spectrum.h:439-473).
    """
    centers = torch.as_tensor(BIN_CENTERS, dtype=s.dtype, device=s.device)
    lam = torch.clamp(torch.as_tensor(lam, dtype=s.dtype, device=s.device),
                      centers[0], centers[-1])
    idx = torch.clamp(torch.searchsorted(centers, lam) - 1, 0,
                      N_SPECTRAL_SAMPLES - 2)
    t = (lam - centers[idx]) / (centers[idx + 1] - centers[idx])
    return ((1 - t) * torch.take_along_dim(s, idx, -1)
            + t * torch.take_along_dim(s, idx + 1, -1))


# blackbody emission (reference: spectrum.cpp:1018 Blackbody /
# BlackbodyNormalized); host numpy, as the JAX package computes it
_H = 6.62606957e-34
_C = 299792458.0
_KB = 1.3806488e-23


def blackbody(lam_nm, T):
    """Planck spectral radiance at wavelengths [nm], W/(m^2 sr m)."""
    lam = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    return (2 * _H * _C * _C) / (lam ** 5 *
                                 np.expm1(_H * _C / (lam * _KB * T)))


def blackbody_normalized(lam_nm, T):
    """Planck's SPD divided by its value at Wien's peak (so its maximum
    is 1)."""
    lam_max = 2.8977721e-3 / T * 1e9
    return blackbody(lam_nm, T) / blackbody(np.array([lam_max]), T)[0]


def blackbody_spectrum(T, scale=1.0):
    """The normalized blackbody at the bin centres times scale, [31]."""
    return scale * blackbody_normalized(BIN_CENTERS, T)


def _xyz_matrix(s):
    return torch.as_tensor(np.stack([CIE_X, CIE_Y, CIE_Z], -1),
                           dtype=s.dtype, device=s.device)


def to_xyz(s):
    """[..., 31] spectrum -> [..., 3] XYZ."""
    return s @ _xyz_matrix(s) * (BIN_WIDTH / CIE_Y_INTEGRAL)


def to_rgb(s):
    m = torch.as_tensor(XYZ_TO_RGB.T, dtype=s.dtype, device=s.device)
    return to_xyz(s) @ m


def luminance(s):
    w = torch.as_tensor(CIE_Y, dtype=s.dtype, device=s.device)
    return (s @ w) * (BIN_WIDTH / CIE_Y_INTEGRAL)


def is_black(s):
    return torch.all(s == 0.0, dim=-1)
