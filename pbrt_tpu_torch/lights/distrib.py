"""Light-selection distributions (port of pbrt_tpu.lights.distrib;
reference: src/core/lightdistrib.{h,cpp}).

Strategies:
  uniform: equal probability (UniformLightDistribution);
  all:     every light, each with probability 1 (directlighting's
           UniformSampleAllLights; trace_paths samples them all);
  power:   proportional to each light's estimated power
           (PowerLightDistribution);
  spatial: a power / distance^2 distribution per voxel of a dense GRID^3
           grid over the scene's bounds (SpatialLightDistribution,
           lightdistrib.cpp:96-113, which builds up to 64 voxels an axis
           lazily into a hash; the JAX package builds the dense grid
           eagerly at scene build, and so does the port).

The tables are built on the host at scene build (SceneBuilder) in numpy
float64 and cast to float32, as the JAX package builds them; selection is
a per-lane search of them on the scene's device.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.utils.stats import span

GRID = 8


def estimate_light_power(builder, world_radius, light_area):
    """Per-light power estimates (Light::Power), numpy [L]: point 4 pi I,
    spot 2 pi (1 - cos total) I, area pi L A, distant pi L R^2, infinite
    4 pi^2 L R^2 (R the world radius), mapped lights their mean I."""
    lights = builder.lights or [dict(type=ir.LIGHT_POINT, L=np.zeros(31),
                                     params=np.zeros(4))]
    wr = float(world_radius)
    out = np.zeros(len(lights))
    for i, rec in enumerate(lights):
        lum = float(np.mean(rec["L"]))
        t = rec["type"]
        if t == ir.LIGHT_POINT:
            out[i] = 4 * np.pi * lum
        elif t == ir.LIGHT_SPOT:
            out[i] = 2 * np.pi * (1 - float(rec["params"][0])) * lum
        elif t == ir.LIGHT_AREA:
            out[i] = np.pi * lum * float(light_area[i])
        elif t == ir.LIGHT_DISTANT:
            out[i] = np.pi * wr * wr * lum
        elif t == ir.LIGHT_INFINITE:
            out[i] = 4 * np.pi * np.pi * wr * wr * lum
        else:
            out[i] = lum
    return np.maximum(out, 1e-12)


def build_distributions(builder, world_lo, world_hi, light_area,
                        world_radius):
    """(power_cdf [L+1], power_pmf [L], spatial_cdf [G^3, L+1],
    spatial_pmf [G^3, L]) as float32 numpy arrays."""
    power = estimate_light_power(builder, world_radius, light_area)
    L = len(power)
    pmf = power / power.sum()
    cdf = np.zeros(L + 1)
    cdf[1:] = np.cumsum(pmf)

    # spatial: weight = power / max(dist(voxel centre, light)^2, voxel^2)
    lights = builder.lights or [dict(type=ir.LIGHT_POINT, pos=np.zeros(3),
                                     L=np.zeros(31))]
    lo = np.asarray(world_lo, np.float64)
    hi = np.asarray(world_hi, np.float64)
    ext = max(float(np.linalg.norm(hi - lo)), 1e-6)
    g = np.arange(GRID) + 0.5
    X, Y, Z = np.meshgrid(lo[0] + (hi[0] - lo[0]) * g / GRID,
                          lo[1] + (hi[1] - lo[1]) * g / GRID,
                          lo[2] + (hi[2] - lo[2]) * g / GRID,
                          indexing="ij")
    centers = np.stack([X, Y, Z], -1).reshape(-1, 3)    # [G^3, 3]
    w = np.zeros((centers.shape[0], L))
    for i, rec in enumerate(lights):
        t = rec["type"]
        if t in (ir.LIGHT_DISTANT, ir.LIGHT_INFINITE):
            w[:, i] = power[i] / (ext * ext)
        else:
            pos = (_area_light_centroid(builder, i) if t == ir.LIGHT_AREA
                   else np.asarray(rec["pos"], np.float64))
            d2 = np.sum((centers - pos[None, :]) ** 2, -1)
            w[:, i] = power[i] / np.maximum(d2, (ext / GRID) ** 2)
    w = np.maximum(w, 1e-12 * w.max() if w.max() > 0 else 1e-12)
    spat_pmf = w / w.sum(-1, keepdims=True)
    spat_cdf = np.zeros((centers.shape[0], L + 1))
    spat_cdf[:, 1:] = np.cumsum(spat_pmf, -1)
    return (cdf.astype(np.float32), pmf.astype(np.float32),
            spat_cdf.astype(np.float32), spat_pmf.astype(np.float32))


def _area_light_centroid(builder, light_idx):
    """An area light's proxy point: its mesh's vertex mean, or its
    sphere's centre."""
    tris = builder._mesh_light_tris.get(light_idx)
    soa = builder._concat()
    if tris:
        return soa["tri_v"][np.asarray(tris)].reshape(-1, 3).mean(0)
    cand = np.nonzero((soa["prim_light"] == light_idx)
                      & (soa["prim_type"] == ir.PRIM_SPHERE))[0]
    if len(cand):
        qi = int(soa["quad_refs"][cand[0]])
        return np.asarray(builder.quads[qi][0][:3, 3], np.float64)
    return np.zeros(3)


# ---------------------------------------------------------------------------
# selection on the device
# ---------------------------------------------------------------------------

@span("lights")
def select_light(scene, strategy, p, u):
    """Pick a light per lane at points p [B,3] from u [B]; returns
    (l [B] int64, selection pdf [B])."""
    nl = max(scene.n_lights, 1)
    if strategy == "uniform" or nl == 1:
        l = torch.clamp((u * nl).to(torch.int64), max=nl - 1)
        return l, torch.full_like(u, 1.0 / nl)
    if strategy == "power":
        l = torch.clamp(torch.searchsorted(scene.light_power_cdf, u,
                                           right=True) - 1, 0, nl - 1)
        return l, scene.light_power_pmf[l]
    vox = _voxel_of(scene, p)
    cdf = scene.light_spatial_cdf[vox]                     # [B, L+1]
    l = torch.clamp((cdf <= u[:, None]).sum(-1) - 1, 0, nl - 1)
    return l, scene.light_spatial_pmf[vox, l]


@span("lights")
def selection_pdf(scene, strategy, p, l):
    """The probability that the strategy at points p [B,3] picks light l
    [B] (MIS at hit vertices); 1 for "all", which samples every light
    (UniformSampleAllLights, integrator.cpp:54)."""
    nl = max(scene.n_lights, 1)
    if strategy == "all":
        return torch.ones(p.shape[:-1], device=p.device)
    if strategy == "uniform" or nl == 1:
        return torch.full(p.shape[:-1], 1.0 / nl, device=p.device)
    lc = torch.clamp(l, 0, nl - 1).long()
    if strategy == "power":
        return scene.light_power_pmf[lc]
    return scene.light_spatial_pmf[_voxel_of(scene, p), lc]


def _voxel_of(scene, p):
    rel = (p - scene.world_lo) / torch.clamp(
        scene.world_hi - scene.world_lo, min=1e-9)
    q = torch.clamp((rel * GRID).to(torch.int64), 0, GRID - 1)
    return (q[:, 0] * GRID + q[:, 1]) * GRID + q[:, 2]
