"""Scene intermediate representation (port of pbrt_tpu.scene.ir).

`SceneBuilder` assembles triangle meshes, spheres, mesh area lights and
the MATTE, PLASTIC, MIRROR and GLASS materials on the host, orders the
primitives by the BVH, and returns a `SceneData`: a dataclass of tensors
with only the columns the path tracer reads.  Per-primitive and
per-material data are plain tables indexed per lane; the TPU package's
one-gather packings (`shade_all`, `mat_packed`) are not carried over.

`scene_from_jax` builds the same `SceneData` from the arrays of a
`pbrt_tpu` scene, so tests can trace one scene through both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import build_bvh_order
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.ops.dense_intersect import build_dense_tables

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1

LIGHT_AREA = 2

MAT_NONE = -1
MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_MIRROR = 2
MAT_GLASS = 3
PORTED_MATERIALS = (MAT_MATTE, MAT_PLASTIC, MAT_MIRROR, MAT_GLASS)

# the columns scene_from_jax copies from a pbrt_tpu scene unchanged
PRIM_COLUMNS = ("prim_type", "tri_v0", "tri_e1", "tri_e2", "tri_ns",
                "tri_uv", "quad_idx", "prim_material", "prim_light",
                "prim_flip_normal")
QUAD_COLUMNS = ("quad_w2o", "quad_params", "quad_prim")
MAT_COLUMNS = ("mat_type", "mat_kd", "mat_ks", "mat_kr", "mat_kt",
               "mat_rough_u", "mat_rough_v", "mat_eta", "mat_sigma",
               "mat_remap_rough")
LIGHT_COLUMNS = ("light_L", "light_two_sided", "light_area",
                 "light_tri_idx", "light_tri_cdf", "light_tri_packed")
JAX_COLUMNS = PRIM_COLUMNS + QUAD_COLUMNS + MAT_COLUMNS + LIGHT_COLUMNS
JAX_STATICS = ("n_lights", "n_quadrics", "clip_quadrics", "dense_chunk")


@dataclass
class SceneData:
    """Device-side scene (primitives in BVH-leaf order)."""
    # --- primitives ---
    prim_type: torch.Tensor        # [P] PRIM_* tag
    tri_v0: torch.Tensor           # [P,3]
    tri_e1: torch.Tensor           # [P,3]
    tri_e2: torch.Tensor           # [P,3]
    tri_ns: torch.Tensor           # [P,3,3] vertex normals (0 => geometric)
    tri_uv: torch.Tensor           # [P,3,2]
    quad_idx: torch.Tensor         # [P] quadric table index (-1 for tris)
    prim_material: torch.Tensor    # [P]
    prim_light: torch.Tensor       # [P] area-light index or -1
    prim_flip_normal: torch.Tensor  # [P] bool
    # --- quadrics (full spheres, or clipped when clip_quadrics) ---
    quad_w2o: torch.Tensor         # [Q,4,4]
    quad_params: torch.Tensor      # [Q,4] radius, zmin, zmax, phimax
    quad_prim: torch.Tensor        # [Q] prim index of each quadric
    # --- materials ---
    mat_type: torch.Tensor         # [M]
    mat_kd: torch.Tensor           # [M,31]
    mat_ks: torch.Tensor
    mat_kr: torch.Tensor
    mat_kt: torch.Tensor
    mat_rough_u: torch.Tensor      # [M]
    mat_rough_v: torch.Tensor
    mat_eta: torch.Tensor
    mat_sigma: torch.Tensor        # [M] Oren-Nayar sigma (degrees)
    mat_remap_rough: torch.Tensor  # [M] bool
    # --- mesh area lights ---
    light_L: torch.Tensor          # [L,31]
    light_two_sided: torch.Tensor  # [L] bool
    light_area: torch.Tensor       # [L]
    light_tri_idx: torch.Tensor    # [L,T] prim indices, -1 pad
    light_tri_cdf: torch.Tensor    # [L,T+1] area cdf
    light_tri_packed: torch.Tensor  # [L*T,10] v0|e1|e2|flip
    # --- dense intersector tables (ops/dense_intersect.py) ---
    dense_w: torch.Tensor          # [C,16,4*chunk] f32 sections s1|s2|num|s0
    dense_cb: torch.Tensor         # [C,8] chunk AABBs (centered coords)
    dense_center: torch.Tensor     # [3]
    # --- statics ---
    n_lights: int = 0
    n_quadrics: int = 0
    clip_quadrics: bool = False
    dense_chunk: int = 128

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


@dataclass
class MaterialSpec:
    """Host-side material description fed to the builder."""
    type: int = MAT_MATTE
    kd: np.ndarray = None          # [31]
    ks: np.ndarray = None
    kr: np.ndarray = None
    kt: np.ndarray = None
    rough_u: float = 0.0
    rough_v: float = 0.0
    eta: float = 1.5
    sigma: float = 0.0
    remap_roughness: bool = True

    def spectrum(self, key):
        v = getattr(self, key)
        if v is None:
            return np.zeros(spec.N_SPECTRAL_SAMPLES, np.float32)
        return np.asarray(v, np.float32)


@dataclass
class SceneBuilder:
    """Host-side scene assembly -> SceneData."""
    materials: list = field(default_factory=list)
    lights: list = field(default_factory=list)     # [31] radiance each
    quads: list = field(default_factory=list)      # (o2w, w2o, params)
    _chunks: list = field(default_factory=list)
    _mesh_light_tris: dict = field(default_factory=dict)
    _n_prims: int = 0

    def add_material(self, mspec: MaterialSpec) -> int:
        if mspec.type not in PORTED_MATERIALS:
            raise NotImplementedError(
                f"material type {mspec.type} is not ported yet")
        self.materials.append(mspec)
        return len(self.materials) - 1

    def add_area_light(self, L) -> int:
        """A one-sided diffuse area light with radiance L [31]; returns its
        id, which a mesh takes as light_id."""
        self.lights.append(np.asarray(L, np.float32))
        return len(self.lights) - 1

    def _add_chunk(self, F, tri_v, tri_ns, tri_uv, ptype, quad_ref,
                   material_id, light_id, flip):
        self._chunks.append(dict(
            tri_v=tri_v, tri_ns=tri_ns, tri_uv=tri_uv,
            prim_type=np.full(F, ptype, np.int32),
            quad_refs=np.full(F, quad_ref, np.int32),
            prim_material=np.full(F, material_id, np.int32),
            prim_light=np.full(F, light_id, np.int32),
            prim_flip=np.full(F, flip, bool)))
        first = self._n_prims
        self._n_prims += F
        return first

    def add_triangle_mesh(self, vertices, indices, material_id,
                          light_id=-1):
        """World-space vertices [V,3], indices [F,3]; no vertex normals
        and the default (0,0) (1,0) (1,1) uvs (per-vertex normals, uvs and
        object transforms are not ported yet)."""
        vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        F = len(indices)
        tri_uv = np.broadcast_to(np.array([[0., 0.], [1., 0.], [1., 1.]]),
                                 (F, 3, 2)).copy()
        first = self._add_chunk(F, vertices[indices], np.zeros((F, 3, 3)),
                                tri_uv, PRIM_TRIANGLE, -1, material_id,
                                light_id, False)
        if light_id >= 0:
            self._mesh_light_tris.setdefault(light_id, []).extend(
                range(first, first + F))
        return first, F

    def add_sphere(self, object_to_world: Transform, radius, material_id):
        """A full sphere (clipped spheres are not ported yet)."""
        qi = len(self.quads)
        self.quads.append((object_to_world.m.astype(np.float32),
                           object_to_world.m_inv.astype(np.float32),
                           np.asarray((radius, -radius, radius, 2 * np.pi),
                                      np.float32)))
        first = self._add_chunk(1, np.zeros((1, 3, 3)), np.zeros((1, 3, 3)),
                                np.zeros((1, 3, 2)), PRIM_SPHERE, qi,
                                material_id, -1,
                                object_to_world.swaps_handedness())
        return first, qi

    def _concat(self):
        keys = ("tri_v", "tri_ns", "tri_uv", "prim_type", "quad_refs",
                "prim_material", "prim_light", "prim_flip")
        return {k: np.concatenate([c[k] for c in self._chunks], 0)
                for k in keys}

    def _prim_bounds(self, soa):
        lo = soa["tri_v"].min(1).astype(np.float64)
        hi = soa["tri_v"].max(1).astype(np.float64)
        for i in np.nonzero(soa["prim_type"] != PRIM_TRIANGLE)[0]:
            o2w, _, params = self.quads[soa["quad_refs"][i]]
            r = abs(float(params[0]))
            corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r)
                                for z in (-r, r)])
            wc = Transform(o2w.astype(np.float64)).apply_point(corners)
            lo[i], hi[i] = wc.min(0), wc.max(0)
        return lo, hi

    def build(self, device="cpu") -> SceneData:
        P = self._n_prims
        if P == 0:
            raise ValueError("scene has no primitives")
        soa = self._concat()
        lo, hi = self._prim_bounds(soa)
        order = build_bvh_order(lo, hi)

        def reorder(key, dtype=np.float32):
            return soa[key][order].astype(dtype)

        tri = reorder("tri_v")
        tri_v0 = tri[:, 0]
        tri_e1 = tri[:, 1] - tri[:, 0]
        tri_e2 = tri[:, 2] - tri[:, 0]

        Q = max(len(self.quads), 1)
        q_w2o = np.tile(np.eye(4, dtype=np.float32), (Q, 1, 1))
        q_par = np.zeros((Q, 4), np.float32)
        for i, (_, mi, par) in enumerate(self.quads):
            q_w2o[i], q_par[i] = mi, par
        q_prim = np.zeros(Q, np.int32)
        qref = reorder("quad_refs", np.int32)
        qmask = np.nonzero(qref >= 0)[0]
        q_prim[qref[qmask]] = qmask

        mats = self.materials or [MaterialSpec()]

        def mcol(key):
            return np.stack([m.spectrum(key) for m in mats])

        # mesh area lights: padded per-light triangle lists + area CDFs
        Lc = max(len(self.lights), 1)
        inv_order = np.zeros(P, np.int64)
        inv_order[order] = np.arange(P)
        max_lt = max([len(v) for v in self._mesh_light_tris.values()] + [1])
        lt_idx = np.full((Lc, max_lt), -1, np.int32)
        lt_cdf = np.zeros((Lc, max_lt + 1), np.float32)
        l_area = np.zeros(Lc, np.float32)
        for li in range(len(self.lights)):
            tris = self._mesh_light_tris.get(li)
            if not tris:
                raise NotImplementedError(
                    "area lights on quadrics are not ported yet")
            t_old = np.asarray(tris)
            v = soa["tri_v"][t_old]
            areas = 0.5 * np.linalg.norm(
                np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
            total = areas.sum()
            lt_idx[li, :len(tris)] = inv_order[t_old]
            lt_cdf[li, 1:len(tris) + 1] = np.cumsum(areas) / max(total, 1e-20)
            lt_cdf[li, len(tris) + 1:] = 1.0
            l_area[li] = total
        flat_lt = lt_idx.reshape(-1)
        lt_safe = np.clip(flat_lt, 0, P - 1)
        lt_valid = (flat_lt >= 0).astype(np.float32)[:, None]
        prim_flip = reorder("prim_flip", bool)
        ltp = np.zeros((Lc * max_lt, 10), np.float32)
        ltp[:, 0:3] = tri_v0[lt_safe] * lt_valid
        ltp[:, 3:6] = tri_e1[lt_safe] * lt_valid
        ltp[:, 6:9] = tri_e2[lt_safe] * lt_valid
        ltp[:, 9] = prim_flip[lt_safe].astype(np.float32) * lt_valid[:, 0]
        light_L = (np.stack(self.lights) if self.lights
                   else np.zeros((1, spec.N_SPECTRAL_SAMPLES), np.float32))

        arrays = dict(
            prim_type=reorder("prim_type", np.int32),
            tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
            tri_ns=reorder("tri_ns"), tri_uv=reorder("tri_uv"),
            quad_idx=qref,
            prim_material=reorder("prim_material", np.int32),
            prim_light=reorder("prim_light", np.int32),
            prim_flip_normal=prim_flip,
            quad_w2o=q_w2o, quad_params=q_par, quad_prim=q_prim,
            mat_type=np.asarray([m.type for m in mats], np.int32),
            mat_kd=mcol("kd"), mat_ks=mcol("ks"), mat_kr=mcol("kr"),
            mat_kt=mcol("kt"),
            mat_rough_u=np.asarray([m.rough_u for m in mats], np.float32),
            mat_rough_v=np.asarray([m.rough_v for m in mats], np.float32),
            mat_eta=np.asarray([m.eta for m in mats], np.float32),
            mat_sigma=np.asarray([m.sigma for m in mats], np.float32),
            mat_remap_rough=np.asarray([m.remap_roughness for m in mats],
                                       bool),
            light_L=light_L,
            light_two_sided=np.zeros(Lc, bool),
            light_area=l_area, light_tri_idx=lt_idx, light_tri_cdf=lt_cdf,
            light_tri_packed=ltp)
        statics = dict(n_lights=len(self.lights), n_quadrics=len(self.quads),
                       clip_quadrics=False, dense_chunk=None)
        return _scene_from_arrays(arrays, statics, device)


def _scene_from_arrays(arrays, statics, device):
    dt = build_dense_tables(arrays["tri_v0"], arrays["tri_e1"],
                            arrays["tri_e2"], chunk=statics["dense_chunk"])
    cols = {k: torch.as_tensor(np.array(arrays[k]), device=device)
            for k in JAX_COLUMNS}
    return SceneData(
        **cols,
        dense_w=torch.as_tensor(dt["W"], device=device),
        dense_cb=torch.as_tensor(dt["chunk_bounds"], device=device),
        dense_center=torch.as_tensor(dt["center"], device=device),
        n_lights=int(statics["n_lights"]),
        n_quadrics=int(statics["n_quadrics"]),
        clip_quadrics=bool(statics["clip_quadrics"]),
        dense_chunk=int(dt["chunk"]))


def scene_from_jax(arrays: dict, statics: dict, device) -> SceneData:
    """The port's SceneData for a pbrt_tpu scene.

    arrays: {name: np.asarray(getattr(jax_scene, name))} for every name in
    JAX_COLUMNS; statics: the static fields named in JAX_STATICS.  The
    dense tables are recomputed from tri_v0/e1/e2, since the JAX scene's
    `dense_w` is the TPU's bf16x2 layout."""
    for k in JAX_COLUMNS:
        if k not in arrays:
            raise KeyError(f"scene_from_jax needs array {k!r}")
    types = set(np.asarray(arrays["mat_type"]).tolist())
    if not types <= set(PORTED_MATERIALS):
        raise NotImplementedError(f"material types {sorted(types)} include "
                                  "ones not ported yet")
    if np.any(np.asarray(arrays["prim_type"]) > PRIM_SPHERE):
        raise NotImplementedError("only triangles and spheres are ported")
    n_lights = int(statics["n_lights"])
    if np.any(np.asarray(arrays["light_tri_idx"])[:n_lights, 0] < 0):
        raise NotImplementedError("area lights on quadrics are not ported")
    return _scene_from_arrays(arrays, statics, device)
