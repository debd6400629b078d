"""Spectral film: [H,W,31] accumulators and filter-weighted splats (port of
pbrt_tpu.film.film).

The filter is discretized into the reference's 16x16 quadrant table
(film.cpp:50-80); each sample splats to its footprint of pixels with
`index_put_(accumulate=True)`.  On CUDA the accumulation order varies
from run to run, so sums agree to rounding, not bit for bit.  The JAX
package's aligned dynamic-slice splat is a TPU workaround and is not
ported.  The light-side integrators' splats (AddSplat) go to their own
unweighted [H,W,31] buffer, which develop adds times a splat scale; the
.dat holds `raw` alone, as the JAX package writes it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.utils.stats import span

FILTER_TABLE_WIDTH = 16
_RADIUS = {"box": (0.5, 0.5), "triangle": (2.0, 2.0),
           "gaussian": (2.0, 2.0), "mitchell": (2.0, 2.0),
           "sinc": (4.0, 4.0)}
#: the parameters the filters read (each reads its own; others are ignored)
FILTER_PARAMS = ("alpha", "B", "C", "tau")
#: maxsampleluminance at or above this is no clamp (the parser's default)
INF_LUMINANCE = 1e30


def filter_eval(name, x, y, rx, ry, params=None):
    """The reference's filters (src/filters/{box,triangle,gaussian,
    mitchell,sinc}.cpp) at offsets (x, y) from the sample (numpy)."""
    params = params or {}
    ax, ay = np.abs(x), np.abs(y)
    if name == "box":
        return np.where((ax <= rx) & (ay <= ry), 1.0, 0.0)
    if name == "triangle":
        return np.maximum(0.0, rx - ax) * np.maximum(0.0, ry - ay)
    if name == "gaussian":
        alpha = params.get("alpha", 2.0)

        def g(d, r):
            return np.maximum(0.0, np.exp(-alpha * d * d)
                              - np.exp(-alpha * r * r))
        return g(x, rx) * g(y, ry)
    if name == "mitchell":
        B = params.get("B", 1.0 / 3.0)
        C = params.get("C", 1.0 / 3.0)

        def m1d(v):
            v = np.abs(2.0 * v)
            out = np.where(
                v > 1,
                ((-B - 6 * C) * v ** 3 + (6 * B + 30 * C) * v * v
                 + (-12 * B - 48 * C) * v + (8 * B + 24 * C)) * (1.0 / 6.0),
                ((12 - 9 * B - 6 * C) * v ** 3
                 + (-18 + 12 * B + 6 * C) * v * v + (6 - 2 * B)) * (1.0 / 6.0))
            return np.where(v > 2, 0.0, out)
        return m1d(x / rx) * m1d(y / ry)
    if name == "sinc":
        tau = params.get("tau", 3.0)

        def ws(v, r):
            v = np.abs(v)
            s = np.where(v < 1e-5, 1.0,
                         np.sin(np.pi * v) / np.maximum(np.pi * v, 1e-9))
            lanczos = np.where(v < 1e-5, 1.0, np.sin(np.pi * v / tau)
                               / np.maximum(np.pi * v / tau, 1e-9))
            return np.where(v > r, 0.0, s * lanczos)
        return ws(x, rx) * ws(y, ry)
    raise ValueError(f"unknown filter {name}")


@dataclass
class Film:
    weighted: torch.Tensor      # [H,W,31] sum of filter-weighted radiance
    weight: torch.Tensor        # [H,W] sum of filter weights
    raw: torch.Tensor           # [H,W,31] unweighted per-pixel sums (.dat)
    splat: torch.Tensor         # [H,W,31] unweighted splats (lighttracer,
    #                             bdpt's t=1 strategies; add_splats)
    filter_table: torch.Tensor  # [16,16] quadrant table
    radius: tuple               # (rx, ry)
    footprint: int              # pixels per axis a sample can reach
    # the reference's boundary: the pixel set Ceil(pd-r)..Floor(pd+r)
    # inclusive and the table index clamped (film.h:130-147), so with a
    # box filter a sample of jitter exactly 0.0 lands full weight in two
    # pixels.  Matched-RNG renders need it (raw Sobol' emits 0.0 at
    # sample 0); the Owen-scrambled samplers never emit exact 0.
    pbrt_boundary: bool = False

    @property
    def height(self):
        return self.weighted.shape[0]

    @property
    def width(self):
        return self.weighted.shape[1]

    def to(self, device):
        return dataclasses.replace(
            self, weighted=self.weighted.to(device),
            weight=self.weight.to(device), raw=self.raw.to(device),
            splat=self.splat.to(device),
            filter_table=self.filter_table.to(device))


@span("film")
def make_film(width, height, filter_name="box", radius=None, device=None,
              pbrt_boundary=False, **filter_params):
    """An empty film on `device` (None: the first CUDA card) with the
    named filter, its radius (rx, ry) (default: the reference's) and its
    parameters.  pbrt_boundary: the reference's inclusive pixel set (see
    Film)."""
    if filter_name not in _RADIUS:
        raise ValueError(f"unknown filter {filter_name}")
    unknown = set(filter_params) - set(FILTER_PARAMS)
    if unknown:
        raise NotImplementedError(f"filter parameters {sorted(unknown)} "
                                  "are not ported")
    device = devmod.resolve(device)
    rx, ry = radius or _RADIUS[filter_name]
    ox = (np.arange(FILTER_TABLE_WIDTH) + 0.5) * rx / FILTER_TABLE_WIDTH
    oy = (np.arange(FILTER_TABLE_WIDTH) + 0.5) * ry / FILTER_TABLE_WIDTH
    X, Y = np.meshgrid(ox, oy, indexing="xy")
    table = filter_eval(filter_name, X, Y, rx, ry, filter_params)
    NS = spec.N_SPECTRAL_SAMPLES
    return Film(
        weighted=torch.zeros((height, width, NS), device=device),
        weight=torch.zeros((height, width), device=device),
        raw=torch.zeros((height, width, NS), device=device),
        splat=torch.zeros((height, width, NS), device=device),
        filter_table=torch.as_tensor(table, dtype=torch.float32,
                                     device=device),
        radius=(float(rx), float(ry)),
        # with pbrt_boundary the widest footprint is Floor(pd+r)+1 -
        # Ceil(pd-r)
        footprint=max(int(np.floor(2 * max(rx, ry))) + 1 if pbrt_boundary
                      else int(np.ceil(2 * max(rx, ry))), 1),
        pbrt_boundary=pbrt_boundary)


@span("film")
def add_samples(film: Film, pfilm, L, ray_weight=None) -> Film:
    """Splat a batch of samples, in place; returns the film.

    pfilm [B,2] continuous film coords; L [B,31]; ray_weight [B].  A
    sample at p affects the pixels within `radius` of p - 0.5
    (film.h:123-163)."""
    if ray_weight is None:
        ray_weight = torch.ones(pfilm.shape[0], device=pfilm.device)
    rx, ry = film.radius
    pd = pfilm - 0.5
    x0 = torch.ceil(pd[:, 0] - rx).to(torch.int64)
    y0 = torch.ceil(pd[:, 1] - ry).to(torch.int64)
    W, H = film.width, film.height
    inv_rx = FILTER_TABLE_WIDTH / rx
    inv_ry = FILTER_TABLE_WIDTH / ry
    Lw = L * ray_weight[:, None]
    for dy in range(film.footprint):
        for dx in range(film.footprint):
            px = x0 + dx
            py = y0 + dy
            fx = torch.abs(px.to(torch.float32) - pd[:, 0]) * inv_rx
            fy = torch.abs(py.to(torch.float32) - pd[:, 1]) * inv_ry
            ix = torch.clamp(fx.to(torch.int64), max=FILTER_TABLE_WIDTH - 1)
            iy = torch.clamp(fy.to(torch.int64), max=FILTER_TABLE_WIDTH - 1)
            inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            if film.pbrt_boundary:
                inb = (inb & (px.to(torch.float32) <= pd[:, 0] + rx)
                       & (py.to(torch.float32) <= pd[:, 1] + ry))
            else:
                inb = (inb & (fx < FILTER_TABLE_WIDTH)
                       & (fy < FILTER_TABLE_WIDTH))
            fw = torch.where(inb, film.filter_table[iy, ix], 0.0)
            idx = (torch.clamp(py, 0, H - 1), torch.clamp(px, 0, W - 1))
            film.weighted.index_put_(idx, Lw * fw[:, None], accumulate=True)
            film.weight.index_put_(idx, fw * ray_weight, accumulate=True)
    bx = torch.clamp(pfilm[:, 0].to(torch.int64), 0, W - 1)
    by = torch.clamp(pfilm[:, 1].to(torch.int64), 0, H - 1)
    film.raw.index_put_((by, bx), Lw, accumulate=True)
    return film


def add_splats(film: Film, pfilm, L) -> Film:
    """Film::AddSplat (film.cpp:154), in place; returns the film.  Each
    sample's L [B,31] adds, unweighted by any filter, to the pixel that
    floor(pfilm [B,2]) names; samples outside the film are dropped."""
    W, H = film.width, film.height
    px = torch.clamp(torch.floor(pfilm[:, 0]).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.floor(pfilm[:, 1]).to(torch.int64), 0, H - 1)
    inb = ((pfilm[:, 0] >= 0) & (pfilm[:, 0] < W)
           & (pfilm[:, 1] >= 0) & (pfilm[:, 1] < H))
    film.splat.index_put_((py, px), torch.where(inb[:, None], L, 0.0),
                          accumulate=True)
    return film


def develop_spectral(film: Film):
    """Final per-pixel spectra [H,W,31] (reference: film.cpp WriteImage):
    the filtered samples plus the splats, which the light-side integrators
    have already scaled (integrators/dispatch.py)."""
    return (film.weighted / torch.clamp(film.weight, min=1e-12)[..., None]
            + film.splat)


def develop_rgb(film: Film):
    return spec.to_rgb(develop_spectral(film))
