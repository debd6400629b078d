"""Bidirectional path tracing with the full (s,t)-strategy MIS family (port
of pbrt_tpu.integrators.bdpt; reference: src/integrators/bdpt.{h,cpp},
GenerateCameraSubpath / GenerateLightSubpath :357-436, ConnectBDPT
:590-686, MISWeight :230-306).

Both subpaths are fixed-depth wavefront loops over SoA batches (one
[B]-shaped tensor per vertex field per depth); every (s,t) connection is
a batched visibility ray and a closed-form MIS weight over the stored
forward and reverse area densities.  At depth d a pass of B camera rays
makes d + 1 camera-subpath and d light-subpath closest-hit calls, then
d s=1, (d-1)d/2 s>=2 and d t=1 any-hit calls (K1 and K2 on the card).

The JAX package's documented deviations, all kept:
- s=1 connects to the generated light vertex instead of resampling with
  Sample_Li (bdpt.cpp:636); densities use the position measure;
- light subpaths start from area and point-like lights (spot, goniometric
  and projection with their factor at the connection); distant and
  infinite lights take part through s <= 1 only;
- infinite-light radiance along escaped camera rays is added with
  weight 1;
- each vertex shades in `geom.coordinate_system(ns)`, not
  bsdf.shading_frame: a hair vertex does not shade in the fiber frame
  that path, lighttracer and sppm use (ROADMAP, reference-side issues);
  materials are looked up without bump maps, footprints or the mix
  dimension, and sampled without hair's third dimension.

Launches: pbrt_tpu gathers a vertex's MaterialParams again at each
f_world / pdf_dir call and lets XLA merge the copies; here a vertex
gathers them once, at its first use, with its frame, and keeps them (the
same values).  The world-to-camera matrix is inverted once a render.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.integrators import lighttracer as lt
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim
from pbrt_tpu_torch.scene import ir

# sampler dimension bases (any disjoint layout works)
CAM_BASE = 5        # after path.py's camera dims 0..4
LIGHT_BASE = 120
#: camera rays a pass (the JAX package's render_bdpt default)
RAYS_PER_PASS = 1 << 15


def _remap0(x):
    """MISWeight's remap0 (bdpt.cpp:233): a 0 density becomes 1, so that
    delta ratios cancel."""
    return torch.where(x != 0.0, x, 1.0)


def _unit_to(p_from, p_to):
    d = p_to - p_from
    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))
    return d / dist[:, None], dist


def _convert_density(pdf_sw, p_from, p_to, ng_to, to_is_surface):
    """Solid angle to area density (Vertex::ConvertDensity, bdpt.h:270);
    to_is_surface: a python bool or a per-lane mask."""
    d = p_to - p_from
    dist2 = torch.clamp((d * d).sum(-1), min=1e-12)
    w = d / torch.sqrt(dist2)[:, None]
    if isinstance(to_is_surface, bool):
        cos = geom.absdot(ng_to, w) if to_is_surface else 1.0
    else:
        cos = torch.where(to_is_surface, geom.absdot(ng_to, w), 1.0)
    return pdf_sw * cos / dist2


class Vertex:
    """SoA vertex record of one subpath depth (fields [B, ...]).

    beta: the throughput on arrival; pdf_fwd / pdf_rev: area densities
    (bdpt.h Vertex); delta: this vertex scattered by a specular lobe;
    is_surface: a python bool, or a mask for a light vertex (area lights
    are surfaces); escaped: the ray that sought this vertex was traced and
    missed (none by default); connectible: Vertex::IsConnectible
    (bdpt.h:161; `valid` by default, as for the camera and the
    finite-position lights); is_area_light: a light vertex on an area
    light (none by default).  params() / frame() gather the vertex's
    materials and build its shading frame once and keep them."""

    def __init__(self, p, ng, ns, wo, uv, mat, beta, pdf_fwd, delta, valid,
                 light=None, le=None, is_surface=True, escaped=None,
                 connectible=None, is_area_light=None):
        self.p, self.ng, self.ns, self.wo, self.uv = p, ng, ns, wo, uv
        self.mat, self.beta = mat, beta
        self.pdf_fwd = pdf_fwd
        self.pdf_rev = torch.zeros_like(pdf_fwd)
        self.delta, self.valid = delta, valid
        self.light = light
        self.le = le
        self.is_surface = is_surface
        none = torch.zeros_like(valid)
        self.escaped = none if escaped is None else escaped
        self.connectible = valid if connectible is None else connectible
        self.is_area_light = none if is_area_light is None else is_area_light
        self._params = None
        self._frame = None

    def params(self, scene):
        if self._params is None:
            self._params = bsdf.gather_materials(scene, self.mat, uv=self.uv,
                                                 p=self.p)
        return self._params

    def frame(self):
        if self._frame is None:
            self._frame = geom.coordinate_system(self.ns)
        return self._frame

    def f_world(self, scene, wi_world):
        ss, ts = self.frame()
        wo_l = geom.world_to_frame(ss, ts, self.ns, self.wo)
        wi_l = geom.world_to_frame(ss, ts, self.ns, wi_world)
        return bsdf.eval_f(self.params(scene), wo_l, wi_l)

    def pdf_dir(self, scene, wo_world, wi_world):
        ss, ts = self.frame()
        wo_l = geom.world_to_frame(ss, ts, self.ns, wo_world)
        wi_l = geom.world_to_frame(ss, ts, self.ns, wi_world)
        return bsdf.pdf_f(self.params(scene), wo_l, wi_l)


# ---------------------------------------------------------------------------
# subpath generation (bdpt.cpp RandomWalk :357-420)
# ---------------------------------------------------------------------------

def _walk_subpath(scene, ray, beta, pdf_dir_sw, pixel_id, sample_idx, cfg,
                  n_verts, dim_base, alive0, prev_vertex):
    """Extend a subpath by up to n_verts surface vertices (one closest-hit
    call each), filling each predecessor's pdf_rev as directions are
    sampled."""
    B = ray.o.shape[0]
    dev = ray.o.device
    verts = []
    alive = alive0
    pdf_fwd_sw = (pdf_dir_sw if pdf_dir_sw is not None
                  else torch.ones(B, device=dev))
    pv = prev_vertex
    M = scene.mat_type.shape[0]

    def sdim(dim):
        return sample_dim(cfg, pixel_id, sample_idx, dim)

    for depth in range(n_verts):
        hit = isect.intersect_full(scene, ray)
        valid = alive & hit.valid
        ns = bsdf.bump_shading_normal(scene, hit.material, hit)
        pdf_fwd = _convert_density(pdf_fwd_sw, pv.p, hit.p, hit.ng, True)
        le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
        # Vertex::IsConnectible (bdpt.h:161): the vertex's own BSDF has a
        # non-specular lobe (v.delta, the sampled lobe, only zeroes MIS
        # terms)
        mt = scene.mat_type[torch.clamp(hit.material, 0, M - 1).long()]
        v = Vertex(hit.p, hit.ng, ns, hit.wo, hit.uv, hit.material, beta,
                   pdf_fwd, torch.zeros(B, dtype=torch.bool, device=dev),
                   valid, light=hit.light,
                   le=torch.where(valid[:, None], le, 0.0),
                   escaped=alive & ~hit.valid,   # traced and missed (env Le)
                   connectible=(valid & (hit.material >= 0)
                                & (mt != ir.MAT_MIRROR)
                                & (mt != ir.MAT_GLASS)))
        verts.append(v)
        alive = valid
        if depth == n_verts - 1:
            break
        mat = v.params(scene)
        ss, ts = v.frame()
        wo_l = geom.world_to_frame(ss, ts, ns, hit.wo)
        base = dim_base + depth * 3
        wi_l, f, pdf_s, is_spec, _, _ = bsdf.sample_f(
            mat, wo_l, sdim(base), sdim(base + 1), sdim(base + 2))
        wi_w = geom.frame_to_world(ss, ts, ns, wi_l)
        ok = (pdf_s > 1e-12) & ~spec.is_black(f)
        cos_t = geom.absdot(wi_w, ns)
        beta = torch.where(
            (alive & ok)[:, None],
            beta * f * (cos_t / torch.clamp(pdf_s, min=1e-12))[:, None],
            beta)
        # the PREVIOUS vertex's reverse density (bdpt.cpp:414-419)
        pv_rev = _convert_density(bsdf.pdf_f(mat, wi_l, wo_l), hit.p, pv.p,
                                  pv.ng, pv.is_surface)
        pv.pdf_rev = torch.where(valid & ~is_spec, pv_rev, pv.pdf_rev)
        alive = alive & ok
        # delta marks THIS vertex as specular-sampled (bdpt.cpp:408)
        v.delta = is_spec & valid
        pdf_fwd_sw = torch.where(is_spec, 0.0, pdf_s)
        pv = v
        nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength)
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
    return verts


def generate_camera_subpath(scene, ray, pixel_id, sample_idx, cfg, n_verts,
                            camera, width, height, frame=None):
    """Vertex 0 is the camera's (the lens point); 1.. are surface hits.
    The first edge's forward density is the camera's directional
    importance density Pdf_We (perspective.cpp:230+), which keeps the
    (s,t) ratios reciprocal between the NEE-like and splat-like pairs.
    frame: lighttracer.camera_frame's (computed when None)."""
    B = ray.o.shape[0]
    dev = ray.o.device
    NS = spec.N_SPECTRAL_SAMPLES
    d0 = geom.normalize(ray.d)
    cam_v = Vertex(ray.o, d0, d0, -d0, torch.zeros((B, 2), device=dev),
                   torch.full((B,), -1, dtype=torch.int32, device=dev),
                   torch.ones((B, NS), device=dev), torch.ones(B, device=dev),
                   torch.zeros(B, dtype=torch.bool, device=dev),
                   torch.ones(B, dtype=torch.bool, device=dev),
                   is_surface=False)
    pdf_dir0 = camera_pdf_dir(camera, width, height, d0, frame)
    return [cam_v] + _walk_subpath(
        scene, ray, torch.ones((B, NS), device=dev), pdf_dir0, pixel_id,
        sample_idx, cfg, n_verts - 1, CAM_BASE,
        torch.ones(B, dtype=torch.bool, device=dev), cam_v)


def generate_light_subpath(scene, pixel_id, sample_idx, cfg, n_verts):
    """Vertex 0 on a uniformly selected light (bdpt.cpp:427-436), then
    n_verts - 1 surface vertices."""
    B = pixel_id.shape[0]
    dev = pixel_id.device
    nl = max(scene.n_lights, 1)

    def sdim(dim):
        return sample_dim(cfg, pixel_id, sample_idx, dim)

    l = torch.clamp((sdim(LIGHT_BASE) * nl).to(torch.int64), max=nl - 1)
    o, d, Le, pdf, n_l = lt.sample_le(scene, l, sdim(LIGHT_BASE + 1),
                                      sdim(LIGHT_BASE + 2),
                                      sdim(LIGHT_BASE + 3),
                                      sdim(LIGHT_BASE + 4))
    sel_pdf = 1.0 / nl
    lc = torch.clamp(l, 0, scene.light_L.shape[0] - 1)
    lt_type = scene.light_type[lc]
    is_area = lt_type == ir.LIGHT_AREA
    pdf_pos = torch.where(is_area,
                          1.0 / torch.clamp(scene.light_area[lc], min=1e-9),
                          1.0)
    pdf_dir = pdf / torch.clamp(pdf_pos, min=1e-12)
    # every finite-position emitter (sample_le folds the spot cone and the
    # maps into Le); distant and infinite lights stay s=0 only
    supported = (is_area | (lt_type == ir.LIGHT_POINT)
                 | (lt_type == ir.LIGHT_SPOT) | (lt_type == ir.LIGHT_GONIO)
                 | (lt_type == ir.LIGHT_PROJECTION))
    alive = supported & (pdf > 1e-12) & (scene.n_lights > 0)
    # the light vertex's own beta, L / (pdf_pos * selection), for the s=1
    # connection (its directional factor applied there)
    beta0 = torch.where(alive[:, None],
                        scene.light_L[lc] / torch.clamp(
                            pdf_pos * sel_pdf, min=1e-12)[:, None], 0.0)
    lv = Vertex(o, n_l, n_l, d, torch.zeros((B, 2), device=dev),
                torch.full((B,), -1, dtype=torch.int32, device=dev), beta0,
                pdf_pos * sel_pdf, torch.zeros(B, dtype=torch.bool,
                                               device=dev), alive,
                light=l, is_surface=is_area, is_area_light=is_area)
    cos0 = torch.abs(geom.dot(n_l, d))
    beta = Le * torch.where(
        alive, cos0 / torch.clamp(pdf * sel_pdf, min=1e-12), 0.0)[:, None]
    ray = isect.spawn_ray(o, n_l, d, torch.full((B,), 550.0, device=dev))
    ray = ray.replace(tmax=torch.where(alive, ray.tmax, -1.0))
    return [lv] + _walk_subpath(scene, ray, beta, pdf_dir, pixel_id,
                                sample_idx, cfg, n_verts - 1,
                                LIGHT_BASE + 8, alive, lv)


# ---------------------------------------------------------------------------
# the camera's and the lights' emission densities
# ---------------------------------------------------------------------------

def camera_pdf_dir(camera, width, height, w_world, frame=None):
    """PerspectiveCamera::Pdf_We's directional part: 1 / (A cos^3)."""
    if frame is None:
        frame = lt.camera_frame(camera, width, height)
    wc = tfm.xform_vector(frame.w2c, w_world)
    cos_t = torch.clamp(wc[:, 2] / torch.clamp(geom.length(wc), min=1e-9),
                        min=1e-6)
    return 1.0 / (frame.area * cos_t ** 3)


def light_emit_pdf_dir(scene, light_idx, n_l, w):
    """The directional emission density sample_le samples by: the cosine
    hemisphere for area lights, the uniform sphere for the others."""
    li = torch.clamp(light_idx.long(), 0, scene.light_L.shape[0] - 1)
    is_area = scene.light_type[li] == ir.LIGHT_AREA
    return torch.where(is_area, geom.absdot(n_l, w) * sampling.INV_PI,
                       sampling.INV_4PI)


# ---------------------------------------------------------------------------
# the MIS weight (bdpt.cpp MISWeight :230-306)
# ---------------------------------------------------------------------------

def mis_weight(scene, cam_vs, light_vs, s, t, camera, width, height,
               frame=None):
    """The balance heuristic's 1 / (1 + sum r_i), the junction vertices'
    reverse densities recomputed for the strategy (the reference's
    ScopedAssignment block, bdpt.cpp:250-291)."""
    B = cam_vs[0].p.shape[0]
    dev = cam_vs[0].p.device
    if s + t == 2:
        return torch.ones(B, device=dev)
    nl = max(scene.n_lights, 1)
    pt = cam_vs[t - 1]
    pt_minus = cam_vs[t - 2] if t > 1 else None
    qs = light_vs[s - 1] if s > 0 else None
    qs_minus = light_vs[s - 2] if s > 1 else None
    n_rows = scene.light_L.shape[0]

    # pt.pdfRev
    if s > 0:
        w_qp, _ = _unit_to(qs.p, pt.p)
        if s == 1:
            pdf_dir = light_emit_pdf_dir(scene, qs.light, qs.ns, w_qp)
            pt_rev = _convert_density(pdf_dir, qs.p, pt.p, pt.ng,
                                      pt.is_surface)
        else:
            wo_qs, _ = _unit_to(qs.p, qs_minus.p)
            pt_rev = _convert_density(qs.pdf_dir(scene, wo_qs, w_qp), qs.p,
                                      pt.p, pt.ng, pt.is_surface)
    else:
        # PdfLightOrigin: the position density of the light the path hit
        lt_area = 1.0 / torch.clamp(scene.light_area[torch.clamp(
            pt.light.long(), 0, n_rows - 1)], min=1e-9)
        pt_rev = torch.where(pt.light >= 0, lt_area / nl, 0.0)

    # pt_minus.pdfRev
    ptm_rev = None
    if t > 1:
        w_pm, _ = _unit_to(pt.p, pt_minus.p)
        if s > 0:
            w_pq, _ = _unit_to(pt.p, qs.p)
            ptm_rev = _convert_density(pt.pdf_dir(scene, w_pq, w_pm), pt.p,
                                       pt_minus.p, pt_minus.ng,
                                       pt_minus.is_surface)
        else:
            pdf_dir = light_emit_pdf_dir(scene, pt.light, pt.ng, w_pm)
            ptm_rev = _convert_density(pdf_dir, pt.p, pt_minus.p,
                                       pt_minus.ng, pt_minus.is_surface)

    # qs.pdfRev, qs_minus.pdfRev
    qs_rev = qsm_rev = None
    if s > 0:
        w_pq, _ = _unit_to(pt.p, qs.p)
        if t > 1:
            w_pm2, _ = _unit_to(pt.p, pt_minus.p)
            qs_rev = _convert_density(pt.pdf_dir(scene, w_pm2, w_pq), pt.p,
                                      qs.p, qs.ng, qs.is_surface)
        else:
            qs_rev = _convert_density(
                camera_pdf_dir(camera, width, height, w_pq, frame), pt.p,
                qs.p, qs.ng, qs.is_surface)
    if s > 1:
        w_qp2, _ = _unit_to(qs.p, pt.p)
        w_qm, _ = _unit_to(qs.p, qs_minus.p)
        qsm_rev = _convert_density(qs.pdf_dir(scene, w_qp2, w_qm), qs.p,
                                   qs_minus.p, qs_minus.ng,
                                   qs_minus.is_surface)

    sum_ri = torch.zeros(B, device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    # the camera side, i = t-1 .. 1 (bdpt.cpp:293-298)
    ri = torch.ones(B, device=dev)
    for i in range(t - 1, 0, -1):
        rev = pt_rev if i == t - 1 else (
            ptm_rev if i == t - 2 else cam_vs[i].pdf_rev)
        ri = ri * _remap0(rev) / _remap0(cam_vs[i].pdf_fwd)
        d_i = no if i >= t - 1 else cam_vs[i].delta
        d_im = no if i - 1 >= t - 1 else cam_vs[i - 1].delta
        sum_ri = sum_ri + torch.where(~d_i & ~d_im, ri, 0.0)
    # the light side, i = s-1 .. 0 (bdpt.cpp:300-306)
    ri = torch.ones(B, device=dev)
    for i in range(s - 1, -1, -1):
        rev = qs_rev if i == s - 1 else (
            qsm_rev if i == s - 2 else light_vs[i].pdf_rev)
        ri = ri * _remap0(rev) / _remap0(light_vs[i].pdf_fwd)
        d_i = no if i == s - 1 else light_vs[i].delta
        if i > 0:
            d_prev = no if i - 1 == s - 1 else light_vs[i - 1].delta
        else:
            d_prev = scene.light_type[torch.clamp(
                light_vs[0].light.long(), 0, n_rows - 1)] != ir.LIGHT_AREA
        sum_ri = sum_ri + torch.where(~d_i & ~d_prev, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# the connection strategies (ConnectBDPT, bdpt.cpp:590-686)
# ---------------------------------------------------------------------------

def strategies(n_cam, n_light, max_path_verts, n_lights):
    """The any-hit calls of connect_strategies in their order: ("s1", t),
    (s, t) for s >= 2, then ("t1", s)."""
    out = []
    for t in range(2, n_cam + 1):
        if n_lights > 0 and t + 1 <= max_path_verts:
            out.append(("s1", t))
        out += [(s, t) for s in range(2, n_light + 1)
                if s + t <= max_path_verts]
    return out + [("t1", s) for s in range(2, n_light + 1)
                  if s + 1 <= max_path_verts]


def connect_strategies(scene, camera, width, height, cam_vs, light_vs, cfg,
                       max_path_verts, wavelength, frame=None):
    """Every (s,t) strategy of the batch: (L [B,31] of the t >= 2
    strategies, [(pfilm, splat_L), ...] of the t = 1 ones)."""
    if frame is None:
        frame = lt.camera_frame(camera, width, height)
    B = cam_vs[0].p.shape[0]
    dev = cam_vs[0].p.device
    L = torch.zeros((B, spec.N_SPECTRAL_SAMPLES), device=dev)
    splats = []
    T, S = len(cam_vs), len(light_vs)
    lv0 = light_vs[0]

    def weight(s, t, cvs=cam_vs):
        return mis_weight(scene, cvs, light_vs, s, t, camera, width, height,
                          frame)

    for t in range(2, T + 1):
        pt = cam_vs[t - 1]
        # ---- s = 0: the camera path lands on a light (:598-607) ----
        if t <= max_path_verts:
            on_light = pt.valid & (pt.light >= 0)
            L = L + torch.where(on_light[:, None],
                                pt.beta * pt.le * weight(0, t)[:, None], 0.0)
        # ---- s = 1: connect to the generated light vertex ----
        if scene.n_lights > 0 and t + 1 <= max_path_verts:
            w_pl, dist = _unit_to(pt.p, lv0.p)
            f_pt = pt.f_world(scene, w_pl) * geom.absdot(w_pl,
                                                         pt.ns)[:, None]
            # one-sided emission for area lights; the spot cone and the
            # maps for delta emitters
            cos_l = geom.dot(lv0.ns, -w_pl)
            emit_ok = torch.where(lv0.is_area_light, cos_l > 1e-6, True)
            emit_scale = lights.delta_emit_scale(scene, lv0.light, -w_pl)
            g_l = (torch.where(lv0.is_area_light,
                               torch.clamp(cos_l, min=0.0), 1.0)
                   * emit_scale) / torch.clamp(dist * dist, min=1e-12)
            cand = pt.connectible & lv0.valid & emit_ok & \
                ~spec.is_black(f_pt)
            sray = isect.spawn_shadow_ray(pt.p, pt.ng, w_pl, dist, cand,
                                          wavelength)
            occ = isect.occluded(scene, sray, ignore_light=isect
                                 .nee_ignore_light(scene, lv0.light))
            contrib = pt.beta * f_pt * lv0.beta * g_l[:, None]
            L = L + torch.where((cand & ~occ)[:, None],
                                contrib * weight(1, t)[:, None], 0.0)
        # ---- s >= 2: inner connections (:661-680) ----
        for s in range(2, S + 1):
            if s + t > max_path_verts:
                continue
            qs = light_vs[s - 1]
            w_qp, dist = _unit_to(qs.p, pt.p)
            g = (geom.absdot(qs.ns, w_qp) * geom.absdot(pt.ns, w_qp)
                 / torch.clamp(dist * dist, min=1e-12))
            f_qs = qs.f_world(scene, w_qp)
            f_pt = pt.f_world(scene, -w_qp)
            cand = (qs.connectible & pt.connectible & ~spec.is_black(f_qs)
                    & ~spec.is_black(f_pt))
            sray = isect.spawn_shadow_ray(qs.p, qs.ng, w_qp, dist, cand,
                                          wavelength)
            occ = isect.occluded(scene, sray)
            contrib = qs.beta * f_qs * f_pt * pt.beta * g[:, None]
            L = L + torch.where((cand & ~occ)[:, None],
                                contrib * weight(s, t)[:, None], 0.0)

    # ---- t = 1: light vertices connect to the camera (splats) ----
    cam0 = cam_vs[0]
    for s in range(2, S + 1):
        if s + 1 > max_path_verts:
            continue
        qs = light_vs[s - 1]
        w_qc, dist = _unit_to(qs.p, cam0.p)
        pfilm, we, cam_ok = lt.camera_we_splat(camera, width, height, qs.p,
                                               frame)
        f_qs = qs.f_world(scene, w_qc) * geom.absdot(w_qc, qs.ns)[:, None]
        cand = qs.connectible & cam_ok & ~spec.is_black(f_qs)
        sray = isect.spawn_shadow_ray(qs.p, qs.ng, w_qc, dist, cand,
                                      wavelength)
        occ = isect.occluded(scene, sray)
        contrib = qs.beta * f_qs * (we / torch.clamp(dist * dist,
                                                     min=1e-9))[:, None]
        splats.append((pfilm, torch.where(
            (cand & ~occ)[:, None], contrib * weight(s, 1, [cam0])[:, None],
            0.0)))
    return L, splats


def env_escape(scene, cam_vs, L):
    """Escaped camera rays pick up the infinite light's radiance with
    weight 1 (no other strategy here makes those paths)."""
    if not scene.has_infinite:
        return L
    for v in cam_vs[1:]:
        env = lights.env_le(scene, -v.wo)     # wo = -ray.d on a miss too
        L = L + torch.where(v.escaped[:, None], v.beta * env, 0.0)
    return L


# ---------------------------------------------------------------------------
# the render driver
# ---------------------------------------------------------------------------

def trace_pass(scene, camera, film, cfg, pixel_ids, sample_idx, max_depth,
               generate_rays=None, frame=None):
    """One pass: the camera rays of pixel_ids (int64 32-bit words; ids >=
    W*H pad) at sample sample_idx, both subpaths, every strategy; the
    t >= 2 radiance is added to `film` as samples, the t = 1 splats to
    film.splat, in place.  Returns the film."""
    H, W = film.height, film.width
    if frame is None:
        frame = lt.camera_frame(camera, W, H)
    ray, weight, pfilm, pid, sidx = pathmod.camera_rays_for_pixels(
        camera, W, H, cfg, pixel_ids, sample_idx, generate_rays)
    cam_vs = generate_camera_subpath(scene, ray, pid, sidx, cfg,
                                     max_depth + 2, camera, W, H, frame)
    light_vs = generate_light_subpath(scene, pid, sidx, cfg, max_depth + 1)
    L, splats = connect_strategies(scene, camera, W, H, cam_vs, light_vs,
                                   cfg, max_depth + 2, ray.wavelength, frame)
    L = env_escape(scene, cam_vs, L)
    L = torch.where(torch.isfinite(L), L, 0.0)
    filmmod.add_samples(film, pfilm, torch.clamp(L, min=0.0), weight)
    for spf, sl in splats:
        filmmod.add_splats(film, spf,
                           torch.where(torch.isfinite(sl), sl, 0.0))
    return film


def render_bdpt(scene, camera, film, cfg, spp, max_depth=5,
                generate_rays=None):
    """The whole BDPT render into `film`, in place: spp samples of every
    pixel in passes of RAYS_PER_PASS camera rays, one light subpath a
    camera sample.  Returns (film, splat scale 1 / spp).  max_depth
    follows the reference: the longest path has max_depth + 2 vertices.
    The last pass's padding lanes take pixel 0's samples and splat its
    light subpath again, as in the JAX package (ROADMAP, reference-side
    issue (aa))."""
    H, W = film.height, film.width
    frame = lt.camera_frame(camera, W, H)
    n_pix = H * W
    chunk = min(n_pix, RAYS_PER_PASS)
    n_chunks = -(-n_pix // chunk)
    ids = np.full(n_chunks * chunk, 0xFFFFFFFF, np.int64)
    ids[:n_pix] = np.arange(n_pix)
    dev = film.splat.device
    id_chunks = [torch.as_tensor(ids[c * chunk:(c + 1) * chunk], device=dev)
                 for c in range(n_chunks)]
    for s in range(spp):
        for pixel_ids in id_chunks:
            trace_pass(scene, camera, film, cfg, pixel_ids, s, max_depth,
                       generate_rays, frame)
    return film, 1.0 / spp
