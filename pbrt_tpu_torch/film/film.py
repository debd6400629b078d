"""Spectral film: [H,W,31] accumulators and filter-weighted splats (port of
pbrt_tpu.film.film).

The filter is discretized into the reference's 16x16 quadrant table
(film.cpp:50-80); each sample splats to its footprint of pixels with
`index_put_(accumulate=True)`.  On CUDA the accumulation order varies
from run to run, so sums agree to rounding, not bit for bit.  The JAX
package's aligned dynamic-slice splat is a TPU workaround and is not
ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec

FILTER_TABLE_WIDTH = 16
_RADIUS = {"box": (0.5, 0.5), "gaussian": (2.0, 2.0)}
GAUSSIAN_ALPHA = 2.0


def filter_eval(name, x, y, rx, ry):
    """Box or Gaussian filter at offsets (x, y) (numpy; the other reference
    filters, and filter parameters, are not ported yet)."""
    if name == "box":
        return np.where((np.abs(x) <= rx) & (np.abs(y) <= ry), 1.0, 0.0)
    if name == "gaussian":
        def g(d, r):
            return np.maximum(0.0, np.exp(-GAUSSIAN_ALPHA * d * d)
                              - np.exp(-GAUSSIAN_ALPHA * r * r))
        return g(x, rx) * g(y, ry)
    raise NotImplementedError(f"filter {name!r} is not ported yet")


@dataclass
class Film:
    weighted: torch.Tensor      # [H,W,31] sum of filter-weighted radiance
    weight: torch.Tensor        # [H,W] sum of filter weights
    raw: torch.Tensor           # [H,W,31] unweighted per-pixel sums (.dat)
    filter_table: torch.Tensor  # [16,16] quadrant table
    radius: tuple               # (rx, ry)
    footprint: int              # pixels per axis a sample can reach

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
            filter_table=self.filter_table.to(device))


def make_film(width, height, filter_name="box", device="cpu"):
    rx, ry = _RADIUS[filter_name]
    ox = (np.arange(FILTER_TABLE_WIDTH) + 0.5) * rx / FILTER_TABLE_WIDTH
    oy = (np.arange(FILTER_TABLE_WIDTH) + 0.5) * ry / FILTER_TABLE_WIDTH
    X, Y = np.meshgrid(ox, oy, indexing="xy")
    table = filter_eval(filter_name, X, Y, rx, ry)
    NS = spec.N_SPECTRAL_SAMPLES
    return Film(
        weighted=torch.zeros((height, width, NS), device=device),
        weight=torch.zeros((height, width), device=device),
        raw=torch.zeros((height, width, NS), device=device),
        filter_table=torch.as_tensor(table, dtype=torch.float32,
                                     device=device),
        radius=(float(rx), float(ry)),
        footprint=max(int(np.ceil(2 * max(rx, ry))), 1))


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
            inb = ((px >= 0) & (px < W) & (py >= 0) & (py < H)
                   & (fx < FILTER_TABLE_WIDTH) & (fy < FILTER_TABLE_WIDTH))
            fw = torch.where(inb, film.filter_table[iy, ix], 0.0)
            idx = (torch.clamp(py, 0, H - 1), torch.clamp(px, 0, W - 1))
            film.weighted.index_put_(idx, Lw * fw[:, None], accumulate=True)
            film.weight.index_put_(idx, fw * ray_weight, accumulate=True)
    bx = torch.clamp(pfilm[:, 0].to(torch.int64), 0, W - 1)
    by = torch.clamp(pfilm[:, 1].to(torch.int64), 0, H - 1)
    film.raw.index_put_((by, bx), Lw, accumulate=True)
    return film


def develop_spectral(film: Film):
    """Final per-pixel spectra [H,W,31] (reference: film.cpp WriteImage)."""
    return film.weighted / torch.clamp(film.weight, min=1e-12)[..., None]


def develop_rgb(film: Film):
    return spec.to_rgb(develop_spectral(film))
