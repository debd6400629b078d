"""Participating media (port of pbrt_tpu.media.media): homogeneous media
in closed form and density grids by delta and ratio tracking.

Reference: src/core/medium.{h,cpp} (Henyey-Greenstein), src/media/
homogeneous.cpp (per-channel exponential distance sampling with a
spectral MIS weight), src/media/grid.cpp (GridDensityMedium: trilinear
density, delta tracking for Sample :62-88, ratio tracking for Tr :89+,
the majorant through invMaxDensity).

The reference's tracking loops run until every ray leaves the medium;
here, as in the JAX package, they run a fixed number of steps
(MAX_TRACK_STEPS for the one scene medium, LANE_TRACK_STEPS for the
per-lane media of MediumInterface) over the whole batch with live masks,
and a lane still tracking after the last step keeps what it has (a
truncation the JAX package makes too).  Every sample comes from the
counter-based RNG at the JAX package's salts, so a (pixel, sample) pair
draws the same numbers in both packages.  The loops stop early once no
lane is live, which a host sync every TRACK_CHECK steps finds out; the
steps skipped then would change nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import rng
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.media.presets import get_medium_scattering_properties

MEDIUM_NONE = 0
MEDIUM_HOMOGENEOUS = 1
MEDIUM_GRID = 2

#: tracking steps of the scene medium's delta / ratio tracking
MAX_TRACK_STEPS = 64
#: tracking steps of the per-lane walks (majorant flights over one
#: interface span); thicker grids are truncated, as in the JAX package
LANE_TRACK_STEPS = 32
#: the tracking loops test for a live lane every this many steps
TRACK_CHECK = 4


@dataclass
class MediumData:
    """The scene's one medium (volpath without MediumInterface)."""
    sigma_a: torch.Tensor          # [31]
    sigma_s: torch.Tensor          # [31]
    g: torch.Tensor                # [] HG asymmetry
    density: torch.Tensor          # [nz,ny,nx] (1,1,1 for homogeneous)
    world_to_medium: torch.Tensor  # [4,4] world -> unit-cube medium space
    inv_max_density: torch.Tensor  # []
    kind: int = MEDIUM_NONE

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_homogeneous(sigma_a, sigma_s, g=0.0, device="cpu"):
    return MediumData(
        sigma_a=_f32(sigma_a, device), sigma_s=_f32(sigma_s, device),
        g=_f32(g, device), density=torch.ones((1, 1, 1), device=device),
        world_to_medium=torch.eye(4, device=device),
        inv_max_density=_f32(1.0, device), kind=MEDIUM_HOMOGENEOUS)


def make_grid(sigma_a, sigma_s, g, density, medium_to_world, device="cpu"):
    d = np.asarray(density, np.float32)
    return MediumData(
        sigma_a=_f32(sigma_a, device), sigma_s=_f32(sigma_s, device),
        g=_f32(g, device), density=_f32(d, device),
        world_to_medium=_f32(np.linalg.inv(
            np.asarray(medium_to_world, np.float64)), device),
        inv_max_density=_f32(1.0 / max(float(d.max()), 1e-9), device),
        kind=MEDIUM_GRID)


def no_medium(device="cpu"):
    return MediumData(
        sigma_a=torch.zeros(spec.N_SPECTRAL_SAMPLES, device=device),
        sigma_s=torch.zeros(spec.N_SPECTRAL_SAMPLES, device=device),
        g=_f32(0.0, device), density=torch.ones((1, 1, 1), device=device),
        world_to_medium=torch.eye(4, device=device),
        inv_max_density=_f32(1.0, device), kind=MEDIUM_NONE)


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (medium.h:50-86)
# ---------------------------------------------------------------------------

def hg_p(g, cos_theta):
    denom = 1 + g * g + 2 * g * cos_theta
    return (1 - g * g) / (4 * np.pi * denom
                          * torch.sqrt(torch.clamp(denom, min=1e-9)))


def hg_sample(g, wo, u1, u2):
    """A direction ~ HG around -wo; returns (wi, pdf)."""
    g = torch.broadcast_to(g, u1.shape)
    sq = (1 - g * g) / torch.clamp(1 - g + 2 * g * u1, min=1e-6)
    cos_t = torch.where(torch.abs(g) < 1e-3, 1 - 2 * u1,
                        (1 + g * g - sq * sq) / torch.maximum(
                            2 * g, torch.where(g >= 0, 1e-6, -1e-6)))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0.0))
    phi = 2 * np.pi * u2
    v1, v2 = geom.coordinate_system(-wo)
    wi = ((sin_t * torch.cos(phi))[:, None] * v1
          + (sin_t * torch.sin(phi))[:, None] * v2 + cos_t[:, None] * -wo)
    return geom.normalize(wi), hg_p(g, cos_t)


# ---------------------------------------------------------------------------
# density lookup (grid.cpp:46, trilinear)
# ---------------------------------------------------------------------------

def density_at(med: MediumData, p_world):
    """Trilinear density at world points [B,3] (0 outside the unit cube
    of medium space)."""
    m = med.world_to_medium
    pm = p_world @ m[:3, :3].T + m[:3, 3]
    nz, ny, nx = med.density.shape
    g = torch.stack([pm[..., 0] * nx - 0.5, pm[..., 1] * ny - 0.5,
                     pm[..., 2] * nz - 0.5], -1)
    gi = torch.floor(g)
    f = g - gi
    gi = gi.to(torch.int64)

    def D(ix, iy, iz):
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
               & (iz >= 0) & (iz < nz))
        v = med.density[torch.clamp(iz, 0, nz - 1), torch.clamp(iy, 0, ny - 1),
                        torch.clamp(ix, 0, nx - 1)]
        return torch.where(inb, v, 0.0)

    ix, iy, iz = gi[..., 0], gi[..., 1], gi[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    d00 = D(ix, iy, iz) * (1 - fx) + D(ix + 1, iy, iz) * fx
    d10 = D(ix, iy + 1, iz) * (1 - fx) + D(ix + 1, iy + 1, iz) * fx
    d01 = D(ix, iy, iz + 1) * (1 - fx) + D(ix + 1, iy, iz + 1) * fx
    d11 = D(ix, iy + 1, iz + 1) * (1 - fx) + D(ix + 1, iy + 1, iz + 1) * fx
    d0 = d00 * (1 - fy) + d10 * fy
    d1 = d01 * (1 - fy) + d11 * fy
    inside = ((pm >= 0.0) & (pm <= 1.0)).all(-1)
    return torch.where(inside, d0 * (1 - fz) + d1 * fz, 0.0)


def _grid_span(med, o, d, tmax):
    """The ray interval inside the grid's unit cube."""
    m = med.world_to_medium
    return _grid_span_m(o @ m[:3, :3].T + m[:3, 3], d @ m[:3, :3].T, tmax)


def _live(live, k):
    """Whether a tracking loop must run step k + 1: every TRACK_CHECK
    steps a host sync asks whether any lane is still tracking."""
    return (k + 1) % TRACK_CHECK != 0 or bool(live.any())


# ---------------------------------------------------------------------------
# distance sampling and transmittance of the scene medium
# ---------------------------------------------------------------------------

def sample_distance(med: MediumData, o, d, tmax, pixel_id, sample_idx,
                    dim_salt):
    """A medium interaction along [0, tmax).

    Returns (t [B], interacted [B], weight [B,31]): weight multiplies
    beta, sigma_s / pdf at a medium event and the Tr ratio at a surface.
    Homogeneous: per-channel exponential with spectral MIS
    (homogeneous.cpp:44+).  Grid: delta tracking with the scalar majorant
    sigma_t (grid.cpp:62-88, which wants a spectrally uniform sigma_t)."""
    B = o.shape[0]
    NS = spec.N_SPECTRAL_SAMPLES
    sigma_t = med.sigma_a + med.sigma_s
    if med.kind == MEDIUM_HOMOGENEOUS:
        u_ch = rng.uniform_float(pixel_id, sample_idx, dim_salt)
        u_t = rng.uniform_float(pixel_id, sample_idx, dim_salt + 1)
        ch = torch.clamp((u_ch * NS).to(torch.int64), max=NS - 1)
        st_ch = torch.clamp(sigma_t[ch], min=1e-9)
        t_m = -torch.log(torch.clamp(1.0 - u_t, min=1e-9)) / st_ch
        interacted = t_m < tmax
        t = torch.minimum(t_m, tmax)
        tr = torch.exp(-sigma_t[None, :] * t[:, None])
        # the pdf averaged over channels (spectral MIS,
        # homogeneous.cpp:78+)
        pdf_m = torch.mean(sigma_t[None, :] * tr, -1)
        pdf_s = torch.mean(tr, -1)
        w_med = tr * med.sigma_s[None, :] / torch.clamp(pdf_m,
                                                        min=1e-12)[:, None]
        w_surf = tr / torch.clamp(pdf_s, min=1e-12)[:, None]
        return t, interacted, torch.where(interacted[:, None], w_med, w_surf)
    ones = torch.ones((B, NS), device=o.device)
    if med.kind == MEDIUM_GRID:
        st_scalar = torch.clamp(sigma_t.max(), min=1e-9)
        tlo, thi, live = _grid_span(med, o, d, tmax)
        t = tlo
        interacted = torch.zeros(B, dtype=torch.bool, device=o.device)
        for k in range(MAX_TRACK_STEPS):
            u1 = rng.uniform_float(pixel_id, sample_idx, dim_salt + 2 * k)
            u2 = rng.uniform_float(pixel_id, sample_idx,
                                   dim_salt + 2 * k + 1)
            t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) \
                * med.inv_max_density / st_scalar
            esc = t_new >= thi
            dens = density_at(med, o + t_new[:, None] * d)
            real = u2 < dens * med.inv_max_density
            interacted = interacted | (live & ~esc & real)
            t = torch.where(live & ~esc, t_new, t)
            live = live & ~esc & ~real
            if not _live(live, k):
                break
        # delta tracking's weight: sigma_s / sigma_t at an event, else 1
        w_med = (med.sigma_s / st_scalar)[None, :]
        return (torch.where(interacted, t, tmax), interacted,
                torch.where(interacted[:, None], w_med, ones))
    return tmax, torch.zeros(B, dtype=torch.bool, device=o.device), ones


def transmittance(med: MediumData, o, d, tmax, pixel_id, sample_idx,
                  dim_salt):
    """Tr along a (shadow) segment: exp(-sigma_t d) in a homogeneous
    medium, ratio tracking in a grid (grid.cpp:89+)."""
    B = o.shape[0]
    NS = spec.N_SPECTRAL_SAMPLES
    sigma_t = med.sigma_a + med.sigma_s
    if med.kind == MEDIUM_NONE:
        return torch.ones((B, NS), device=o.device)
    if med.kind == MEDIUM_HOMOGENEOUS:
        return transmittance_lanes(sigma_t[None, :], tmax)
    st_scalar = torch.clamp(sigma_t.max(), min=1e-9)
    tlo, thi, live = _grid_span(med, o, d, tmax)
    tr = torch.ones(B, device=o.device)
    t = tlo
    for k in range(MAX_TRACK_STEPS):
        u1 = rng.uniform_float(pixel_id, sample_idx,
                               dim_salt + 1000 + 2 * k)
        t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) \
            * med.inv_max_density / st_scalar
        esc = t_new >= thi
        dens = density_at(med, o + t_new[:, None] * d)
        ratio = 1.0 - dens * med.inv_max_density
        step = live & ~esc
        tr = torch.where(step, tr * torch.clamp(ratio, min=0.0), tr)
        t = torch.where(step, t_new, t)
        live = step & (tr > 1e-5)
        if not _live(live, k):
            break
    return tr[:, None].expand(B, NS)


# ---------------------------------------------------------------------------
# per-lane media (the per-primitive MediumInterface path)
# ---------------------------------------------------------------------------
# Each lane is keyed into the scene's padded medium table (SceneData
# med_density [K,DZ,DY,DX], med_w2m, med_dims, med_inv_maxd), so a grid
# can be bound to a shape's interface as the reference binds a
# GridDensityMedium through MediumInterface (api.cpp pbrtMediumInterface,
# scene.cpp:57-81 IntersectTr composing per-segment Tr).

def sample_distance_lanes(sigma_a, sigma_s, tmax, pixel_id, sample_idx,
                          dim_salt):
    """Per-lane homogeneous free flight (sigma_* [B,31], each lane's own
    medium).  Vacuum lanes (all-zero sigma) never interact and carry
    weight 1.  The estimator of sample_distance's homogeneous branch."""
    NS = spec.N_SPECTRAL_SAMPLES
    sigma_t = sigma_a + sigma_s
    u_ch = rng.uniform_float(pixel_id, sample_idx, dim_salt)
    u_t = rng.uniform_float(pixel_id, sample_idx, dim_salt + 1)
    ch = torch.clamp((u_ch * NS).to(torch.int64), max=NS - 1)
    st_ch = torch.clamp(torch.gather(sigma_t, 1, ch[:, None])[:, 0],
                        min=1e-9)
    t_m = -torch.log(torch.clamp(1.0 - u_t, min=1e-9)) / st_ch
    vacuum = sigma_t.amax(-1) <= 1e-12
    interacted = (t_m < tmax) & ~vacuum
    t = torch.where(vacuum, tmax, torch.minimum(t_m, tmax))
    tr = torch.exp(-sigma_t * t[:, None])
    pdf_m = torch.mean(sigma_t * tr, -1)
    pdf_s = torch.mean(tr, -1)
    w_med = tr * sigma_s / torch.clamp(pdf_m, min=1e-12)[:, None]
    w_surf = tr / torch.clamp(pdf_s, min=1e-12)[:, None]
    weight = torch.where(interacted[:, None], w_med, w_surf)
    return t, interacted, torch.where(vacuum[:, None], 1.0, weight)


def transmittance_lanes(sigma_t, tmax):
    """Per-lane homogeneous Tr = exp(-sigma_t d) (sigma_t [B,31] or
    [1,31])."""
    seg = torch.clamp(torch.where(torch.isfinite(tmax), tmax, 0.0), min=0.0)
    return torch.exp(-sigma_t * seg[:, None])


def _to_medium_lanes(w2m_b, o, d):
    """Rays in each lane's medium unit-cube space (w2m_b [B,4,4])."""
    om = torch.einsum('bij,bj->bi', w2m_b[:, :3, :3], o) + w2m_b[:, :3, 3]
    dm = torch.einsum('bij,bj->bi', w2m_b[:, :3, :3], d)
    return om, dm


def _grid_span_m(om, dm, tmax):
    """The ray interval inside the unit cube, from medium-space rays."""
    inv = 1.0 / torch.where(torch.abs(dm) > 1e-12, dm, 1e-12)
    t0 = (0.0 - om) * inv
    t1 = (1.0 - om) * inv
    tlo = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    thi = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax)
    return tlo, thi, thi > tlo


def density_at_lanes(density, dims, mk, p_med):
    """Trilinear density per lane (grid.cpp:46 GridDensityMedium::D).

    density [K,DZ,DY,DX]: padded row-major grids; dims [K,3] (nz,ny,nx)
    their extents; mk [B]: each lane's medium; p_med [B,3]: points in
    medium space.  Taps outside the extents add 0 (the reference's D()
    bounds test)."""
    K, DZ, DY, DX = density.shape
    flat = density.reshape(K, DZ * DY * DX)
    dims_b = dims[mk]                                    # [B,3]
    gx = p_med[:, 0] * dims_b[:, 2].to(torch.float32) - 0.5
    gy = p_med[:, 1] * dims_b[:, 1].to(torch.float32) - 0.5
    gz = p_med[:, 2] * dims_b[:, 0].to(torch.float32) - 0.5
    ix, iy, iz = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - ix, gy - iy, gz - iz
    ix, iy, iz = (x.to(torch.int64) for x in (ix, iy, iz))
    acc = torch.zeros_like(gx)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                inb = ((jx >= 0) & (jy >= 0) & (jz >= 0)
                       & (jx < dims_b[:, 2]) & (jy < dims_b[:, 1])
                       & (jz < dims_b[:, 0]))
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))
                idx = ((torch.clamp(jz, 0, DZ - 1) * DY
                        + torch.clamp(jy, 0, DY - 1)) * DX
                       + torch.clamp(jx, 0, DX - 1))
                acc = acc + torch.where(inb, w * flat[mk, idx], 0.0)
    return acc


def sample_distance_grid_lanes(density, dims, w2m_b, inv_maxd_b,
                               st_scalar_b, o, d, tmax, mk, pixel_id,
                               sample_idx, dim_salt):
    """Per-lane delta tracking (grid.cpp:62-88) through each lane's own
    grid; st_scalar_b [B]: the lane medium's scalar majorant sigma_t.
    Returns (t [B], interacted [B])."""
    om, dm = _to_medium_lanes(w2m_b, o, d)
    t, thi, live = _grid_span_m(om, dm, tmax)
    st = torch.clamp(st_scalar_b, min=1e-9)
    imd = torch.clamp(inv_maxd_b, min=1e-12)
    interacted = torch.zeros_like(live)
    for k in range(LANE_TRACK_STEPS):
        u1 = rng.uniform_float(pixel_id, sample_idx, dim_salt + 2 * k)
        u2 = rng.uniform_float(pixel_id, sample_idx, dim_salt + 2 * k + 1)
        t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) * imd / st
        esc = t_new >= thi
        dens = density_at_lanes(density, dims, mk, om + t_new[:, None] * dm)
        real = u2 < dens * imd
        interacted = interacted | (live & ~esc & real)
        t = torch.where(live & ~esc, t_new, t)
        live = live & ~esc & ~real
        if not _live(live, k):
            break
    return torch.where(interacted, t, tmax), interacted


def ratio_tr_lanes(density, dims, w2m_b, inv_maxd_b, st_scalar_b, o, d,
                   tmax, mk, pixel_id, sample_idx, dim_salt):
    """Per-lane ratio-tracking Tr (grid.cpp:89+) through each lane's own
    grid: a scalar Tr [B] (spectrally uniform by construction)."""
    om, dm = _to_medium_lanes(w2m_b, o, d)
    t, thi, live = _grid_span_m(om, dm, tmax)
    st = torch.clamp(st_scalar_b, min=1e-9)
    imd = torch.clamp(inv_maxd_b, min=1e-12)
    tr = torch.ones_like(t)
    for k in range(LANE_TRACK_STEPS):
        u1 = rng.uniform_float(pixel_id, sample_idx, dim_salt + 2 * k)
        t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) * imd / st
        esc = t_new >= thi
        dens = density_at_lanes(density, dims, mk, om + t_new[:, None] * dm)
        ratio = 1.0 - dens * imd
        step = live & ~esc
        tr = torch.where(step, tr * torch.clamp(ratio, min=0.0), tr)
        t = torch.where(step, t_new, t)
        live = step & (tr > 1e-5)
        if not _live(live, k):
            break
    return tr


def medium_coefficients(ps):
    """A MakeNamedMedium's (sigma_a [31], sigma_s [31], g) from its
    ParamSet `ps`: a named
    "preset" gives the defaults, explicit sigma_a / sigma_s override them,
    and both scale by "scale" (api.cpp MakeMedium:699-745)."""
    default_a, default_s = 1.0, 1.0
    preset = ps.find_one_string("preset", "")
    if preset:
        got = get_medium_scattering_properties(preset)
        if got is not None:
            default_a, default_s = got
    scale = ps.find_one_float("scale", 1.0)
    return (ps.find_one_spectrum("sigma_a", default_a) * scale,
            ps.find_one_spectrum("sigma_s", default_s) * scale,
            ps.find_one_float("g", 0.0))


def medium_grid(m):
    """A grid medium's (density [nz,ny,nx], data_to_medium [4,4] float64:
    translate(p0) scale(p1 - p0)), or None for a homogeneous one."""
    if m["type"] not in ("heterogeneous", "grid"):
        return None
    ps = m["params"]
    nx, ny, nz = (ps.find_one_int(k, 1) for k in ("nx", "ny", "nz"))
    dvals = ps.find_floats("density")
    dens = (np.asarray(dvals, np.float32).reshape(nz, ny, nx)
            if dvals is not None else np.ones((1, 1, 1), np.float32))
    p0 = np.asarray(ps.find_one_point("p0", [0, 0, 0]), np.float64)
    p1 = np.asarray(ps.find_one_point("p1", [1, 1, 1]), np.float64)
    d2m = np.eye(4)
    d2m[:3, 3] = p0
    for i in range(3):
        d2m[i, i] = p1[i] - p0[i]
    return dens, d2m
