"""Mesh area lights: sampling, pdf and emitted radiance (port of the mesh
area-light part of pbrt_tpu.lights.lights).

NEE contract (as in the JAX package):
  sample_li(scene, l, p, n, u1, u2) -> (wi, Li, pdf_solid_angle, dist,
                                        is_delta)
  pdf_li_area(scene, l, prev_p, wi, hit_t, hit_ng) -> solid-angle pdf
  area_le(scene, light_idx, ng, wo) -> emission toward wo
Point, spot, distant, infinite, goniometric, projection and sphere area
lights are not ported yet.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.scene import ir


def _sample_mesh_area(scene, l, p, u1, u2):
    """Uniform-by-area sample on a mesh light (triangle.cpp:470+).

    Returns (wi, pdf, dist, cos_l); cos_l is the emission-side cosine."""
    T = scene.light_tri_idx.shape[1]
    cdf = scene.light_tri_cdf[l]                             # [B,T+1]
    ti = torch.clamp((cdf <= u1[:, None]).sum(-1) - 1, 0, T - 1)
    row = scene.light_tri_packed[l * T + ti]                 # [B,10]
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    c0 = torch.gather(cdf, 1, ti[:, None])[:, 0]
    c1 = torch.gather(cdf, 1, ti[:, None] + 1)[:, 0]
    u1r = torch.clamp((u1 - c0) / torch.clamp(c1 - c0, min=1e-9),
                      0.0, 0.999999)
    bc = sampling.uniform_sample_triangle(u1r, u2)
    q = v0 + bc[:, 0:1] * e1 + bc[:, 1:2] * e2
    n_l = geom.normalize(geom.cross(e1, e2))
    n_l = torch.where((row[:, 9] > 0.5)[:, None], -n_l, n_l)
    to_q = q - p
    dq2 = torch.clamp(geom.length_sq(to_q), min=1e-12)
    dq = torch.sqrt(dq2)
    wi = to_q / dq[:, None]
    cos_l = geom.dot(n_l, -wi)
    area = torch.clamp(scene.light_area[l], min=1e-12)
    pdf = dq2 / torch.clamp(torch.abs(cos_l) * area, min=1e-9)
    return wi, pdf, dq, cos_l


def sample_li(scene: ir.SceneData, l, p, n, u1, u2):
    """Sample an incident direction from light l [B] toward points p [B,3].

    Returns (wi [B,3], Li [B,31], pdf [B] w.r.t. solid angle, dist [B],
    is_delta [B]).  n is unused by area lights (kept for the contract)."""
    l = l.long()
    wi, pdf, dist, cos_l = _sample_mesh_area(scene, l, p, u1, u2)
    front = scene.light_two_sided[l] | (cos_l > 0)
    li = torch.where(front[:, None], scene.light_L[l], 0.0)
    return wi, li, pdf, dist, torch.zeros_like(front)


def pdf_li_area(scene: ir.SceneData, light_idx, prev_p, wi, hit_t, hit_ng):
    """Solid-angle pdf that NEE at prev_p samples direction wi hitting an
    area light at distance hit_t with normal hit_ng (shape.cpp:136)."""
    l = torch.clamp(light_idx, 0, scene.light_L.shape[0] - 1).long()
    cos_l = torch.abs(geom.dot(hit_ng, -wi))
    area = torch.clamp(scene.light_area[l], min=1e-12)
    return hit_t * hit_t / torch.clamp(cos_l * area, min=1e-9)


def area_le(scene: ir.SceneData, light_idx, ng, wo):
    """Emitted radiance of an area-light prim toward wo (diffuse.h:55-76)."""
    l = torch.clamp(light_idx, 0, scene.light_L.shape[0] - 1).long()
    facing = scene.light_two_sided[l] | (geom.dot(ng, wo) > 0)
    return torch.where(((light_idx >= 0) & facing)[:, None],
                       scene.light_L[l], 0.0)
