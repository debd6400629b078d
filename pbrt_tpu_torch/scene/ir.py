"""Scene intermediate representation (port of pbrt_tpu.scene.ir).

`SceneBuilder` assembles triangle meshes, the quadrics (sphere, cylinder,
disk, cone, paraboloid), the lights (point,
spot, distant, goniometric, projection, area lights on meshes and
spheres, infinite lights with or without an env map), every material of
the JAX package and the texture table on the host,
orders the primitives by the BVH, and returns a `SceneData`: a dataclass
of tensors with only the columns the path tracer reads, and the static
flags (material families, texture kinds, bump, mix, Beckmann, Disney)
that keep absent families out of the launch stream (the light kinds
among them).  The light-selection tables of lights/distrib.py and the
env map's sampling tables are built here too.  Per-primitive and
per-material data are plain tables indexed per lane; the TPU package's
one-gather packings (`shade_all`, `mat_packed`) are not carried over.
The media that MediumInterface binds (homogeneous and density grids) go
into a per-medium table, each primitive carrying its inside and outside
medium and the scene its camera's (the JAX package's tables and
primitive order).  The subsurface materials carry a beam-diffusion
profile table each (deduplicated by (g, eta), `add_bssrdf_table`) and
their per-channel medium; fourier materials a baked lattice and its
sampling marginals (`add_fourier_grid`); hair reuses the material
record's slots (kd: sigma_a, rough_u / rough_v: beta_m / beta_n, sigma:
alpha in degrees); each primitive carries its per-mesh face index for
ptex.  has_sss, has_hair, has_fourier and has_ptex are static, as in
the JAX package: a scene without them launches nothing for them.

The hit search takes one of three routes, as pbrt_tpu's does
(pbrt_tpu/scene/ir.py:900, ops/intersect.py:450-459): the dense kernels
K1 / K2 over a table of chunked triangles (`use_dense`) for a scene of at
most MAX_DENSE_PRIMS primitives (MAX_MOTION_PRIMS once a mesh moves),
else the SAH kd-tree when the scene names `Accelerator "kdtree"`
(`use_kd`), else the octant-threaded BVH.  The BVH is always built: its
leaf order is the primitive order of every route.  Above the cap no
dense table is built.

Two-keyframe motion blur: a mesh given a second object-to-world keyframe
moves its vertices linearly over the shutter (`tri_motion`), and the
scene's dense table becomes the motion table (`dense_motion`; above the
cap the walks move each tested triangle to the ray's time); a quadric
given one interpolates its decomposed transform per ray (`quad_anim_*`).
The other shapes of the scene format (plymesh, loopsubdiv, heightfield,
curve, nurbs, hyperboloid) reach the builder as triangle meshes.

`scene_from_jax` builds the same `SceneData` from the arrays of a
`pbrt_tpu` scene, so tests can trace one scene through both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import MAX_LEAF_SIZE, build_bvh
from pbrt_tpu_torch.accel.kdtree import build_kdtree
from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.transform import Transform, animated_pair
from pbrt_tpu_torch.ops import accel_walk
from pbrt_tpu_torch.ops.dense_intersect import (build_dense_tables,
                                                build_dense_tables_motion)
from pbrt_tpu_torch.textures.textures import TEX_PTEX, TextureTable

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_CYLINDER = 2
PRIM_DISK = 3
PRIM_CONE = 4
PRIM_PARABOLOID = 5
# (the JAX package's PRIM_HYPERBOLOID = 6 never reaches a scene: the parser
# tessellates the hyperboloid, shapes/nurbs.py)

# light type tags
LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_AREA = 2          # emissive primitives (a mesh or a sphere)
LIGHT_INFINITE = 3
LIGHT_SPOT = 4
LIGHT_GONIO = 5
LIGHT_PROJECTION = 6

# material type tags (reference dispatch: api.cpp:552-625)
MAT_NONE = -1          # "" / "none": a pass-through interface
MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_MIRROR = 2
MAT_GLASS = 3
MAT_METAL = 4
MAT_UBER = 5
MAT_SUBSTRATE = 6
MAT_TRANSLUCENT = 7
MAT_RETRO = 8          # the fork's retroreflective
MAT_DISNEY = 9
MAT_HAIR = 10
MAT_FOURIER = 11
MAT_MIX = 12
MAT_ROUGHGLASS = 13    # glass with nonzero roughness
MAT_SUBSURFACE = 14
MAT_KDSUBSURFACE = 15
MAT_SSW = 16           # the BSSRDF exit lobe (a lane tag, never a material)

# scenes beyond these many primitives (animated meshes: the lower cap)
# leave the dense kernels for the BVH or kd-tree walks
# (pbrt_tpu/scene/ir.py:900; dense_route)
MAX_DENSE_PRIMS = 300_000
MAX_MOTION_PRIMS = 150_000

# the columns scene_from_jax copies from a pbrt_tpu scene unchanged
PRIM_COLUMNS = ("prim_type", "tri_v0", "tri_e1", "tri_e2", "tri_motion",
                "tri_ns", "tri_uv", "quad_idx", "prim_material",
                "prim_light", "prim_instance", "prim_flip_normal")
QUAD_COLUMNS = ("quad_w2o", "quad_params", "quad_type", "quad_prim",
                "quad_anim_t", "quad_anim_q", "quad_anim_s")
MAT_COLUMNS = ("mat_type", "mat_kd", "mat_ks", "mat_kr", "mat_kt",
               "mat_rough_u", "mat_rough_v", "mat_eta", "mat_sigma",
               "mat_remap_rough", "mat_kd_tex", "mat_ks_tex", "mat_bump_tex",
               "mat_mix_a", "mat_mix_b", "mat_mix_amt", "mat_disney",
               "fourier_grid", "fourier_a0", "fourier_lum", "bssrdf_profile",
               "bssrdf_cdf", "bssrdf_rho", "bssrdf_radius")
TEX_COLUMNS = ("tex_images", "tex_type", "tex_params", "tex_c1", "tex_c2",
               "world_radius")
LIGHT_COLUMNS = ("light_type", "light_L", "light_pos", "light_dir",
                 "light_params", "light_quad", "light_two_sided",
                 "light_area", "light_tri_idx", "light_tri_cdf",
                 "light_tri_packed", "light_sph_center", "light_sph_radius",
                 "light_power_cdf", "light_power_pmf", "light_spatial_cdf",
                 "light_spatial_pmf", "env_map", "env_cond_cdf",
                 "env_marg_cdf", "env_cond_int", "env_to_world",
                 "env_to_light", "world_lo", "world_hi")
# the media tables (MediumInterface): per-primitive bindings and the
# padded per-medium table, homogeneous and grid
MEDIA_COLUMNS = ("prim_medium_in", "prim_medium_out", "med_sigma_a",
                 "med_sigma_s", "med_g", "med_density", "med_dims",
                 "med_w2m", "med_inv_maxd", "med_is_grid")
JAX_COLUMNS = (PRIM_COLUMNS + QUAD_COLUMNS + MAT_COLUMNS + LIGHT_COLUMNS
               + TEX_COLUMNS + MEDIA_COLUMNS)
# what scene_from_jax reads from pbrt_tpu's packed material table, which
# alone holds the Beckmann flag and is what pbrt_tpu's shading reads: its
# rows are [bf16-hi; f32 residual], and hi + residual is the f32 value
# exactly
PACKED_COLUMNS = ("mat_eta_spec", "mat_k_spec", "mat_opacity",
                  "mat_beckmann", "mat_fourier_id", "mat_bssrdf_id",
                  "mat_sss_sigma_t", "mat_sss_rho")
# ... and from its one-gather shading rows (shade_all, int32 columns
# bitcast to f32 from column 24): the per-mesh face index
SHADE_COLUMNS = ("prim_face",)
# the walks' trees (accel/bvh.py, accel/kdtree.py) as pbrt_tpu and
# SceneBuilder hold them; pbrt_tpu leaves the kd arrays None without
# `Accelerator "kdtree"`
BVH_ARRAYS = ("bvh_packed", "bvh_hit", "bvh_miss")
KD_COLUMNS = ("kd_packed", "kd_prim_idx", "kd_bounds")
# ... and the BVH as SceneData holds it: both link tables in one
# (accel_walk.bvh_links)
BVH_COLUMNS = ("bvh_packed", "bvh_links")
JAX_ARRAYS = (JAX_COLUMNS + ("mat_packed", "shade_all") + BVH_ARRAYS
              + KD_COLUMNS)
JAX_STATICS = ("n_lights", "n_quadrics", "clip_quadrics", "dense_chunk",
               "has_animated_mesh", "has_animated_quads", "dense_motion",
               "has_disney", "has_mix", "has_beckmann", "has_bump",
               "has_hair", "has_fourier", "has_sss", "has_ptex",
               "mat_families", "tex_kinds", "light_kinds", "has_mesh_lights",
               "has_sphere_lights", "has_infinite", "inf_light_idx",
               "has_prim_media", "has_grid_media", "camera_medium",
               "n_nodes", "max_leaf", "use_dense", "use_kd", "kd_max_leaf")
# pbrt_tpu/scene/ir.py's MPK_* offsets into a mat_packed row
_NS = spec.N_SPECTRAL_SAMPLES
_MPK_ETA_SPEC, _MPK_K_SPEC, _MPK_OPACITY = 4 * _NS, 5 * _NS, 6 * _NS
_MPK_FOURIER, _MPK_BSSRDF = 7 * _NS + 17, 7 * _NS + 18
_MPK_SSS_SIGT = 7 * _NS + 19
_MPK_SSS_RHO = _MPK_SSS_SIGT + _NS
_MPK_BECKMANN = _MPK_SSS_RHO + _NS
_SHADE_FACE = 24 + 6


@dataclass
class SceneData:
    """Device-side scene (primitives in BVH-leaf order)."""
    # --- primitives ---
    prim_type: torch.Tensor        # [P] PRIM_* tag
    tri_v0: torch.Tensor           # [P,3]
    tri_e1: torch.Tensor           # [P,3]
    tri_e2: torch.Tensor           # [P,3]
    tri_motion: torch.Tensor       # [P,12] d0|de1|de2|pad: v0(t) = v0+t*d0
    tri_ns: torch.Tensor           # [P,3,3] vertex normals (0 => geometric)
    tri_uv: torch.Tensor           # [P,3,2]
    quad_idx: torch.Tensor         # [P] quadric table index (-1 for tris)
    prim_material: torch.Tensor    # [P]
    prim_light: torch.Tensor       # [P] area-light index or -1
    prim_instance: torch.Tensor    # [P] id of the Shape (sidecar names)
    prim_flip_normal: torch.Tensor  # [P] bool
    prim_face: torch.Tensor        # [P] face index within its Shape (ptex)
    # --- quadrics (the z / phi clip runs when clip_quadrics) ---
    quad_w2o: torch.Tensor         # [Q,4,4]
    # [Q,4] radius, zmin, zmax, phimax; a disk (radius, height,
    # innerradius, phimax), a cone (radius, 0, height, phimax)
    quad_params: torch.Tensor
    quad_type: torch.Tensor        # [Q] PRIM_* tag of each quadric
    quad_prim: torch.Tensor        # [Q] prim index of each quadric
    quad_anim_t: torch.Tensor      # [Q,2,3] keyframe translations
    quad_anim_q: torch.Tensor      # [Q,2,4] keyframe rotations (wxyz)
    quad_anim_s: torch.Tensor      # [Q,2,3,3] keyframe scales
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
    mat_kd_tex: torch.Tensor       # [M] texture index of Kd, -1: constant
    mat_ks_tex: torch.Tensor       # [M] ... of Ks
    mat_bump_tex: torch.Tensor     # [M] ... of the bump map, -1: none
    mat_mix_a: torch.Tensor        # [M] mix: material id of namedmaterial1
    mat_mix_b: torch.Tensor        # [M] ... of namedmaterial2
    mat_mix_amt: torch.Tensor      # [M] mix: P(select a)
    mat_disney: torch.Tensor       # [M,8] metallic, specTint, sheen,
    #                                sheenTint, clearcoat, ccGloss,
    #                                specTrans, anisotropic
    mat_eta_spec: torch.Tensor     # [M,31] conductor eta (metal)
    mat_k_spec: torch.Tensor       # [M,31] conductor k (metal)
    mat_opacity: torch.Tensor      # [M,31] (uber; 1 elsewhere)
    mat_beckmann: torch.Tensor     # [M] bool: Beckmann, not GGX
    # fourier: the baked (muI, muO, dphi) lattices of the scene's BSDF
    # files (materials/fourier.py bake_grid) and their sampling
    # marginals (bake_cr_tables); one zero placeholder without any
    mat_fourier_id: torch.Tensor   # [M] lattice index, -1
    fourier_grid: torch.Tensor     # [F,NM,NM,NP,3]
    fourier_a0: torch.Tensor       # [F,NMi,NMo] phi-mean luminance |muI|
    fourier_lum: torch.Tensor      # [F,NMi,NMo,NP] luminance lattice
    # subsurface: one beam-diffusion profile table per distinct (g, eta)
    # (materials/bssrdf.py), over shared rho / optical-radius grids, and
    # each material's medium
    mat_bssrdf_id: torch.Tensor    # [M] table index, -1
    mat_sss_sigma_t: torch.Tensor  # [M,31] extinction (world units)
    mat_sss_rho: torch.Tensor      # [M,31] single-scattering albedo
    bssrdf_profile: torch.Tensor   # [T,NR,NK] profile with 2 pi r
    bssrdf_cdf: torch.Tensor       # [T,NR,NK] each rho row's radius cdf
    bssrdf_rho: torch.Tensor       # [NR]
    bssrdf_radius: torch.Tensor    # [NK]
    # --- lights (a scene without lights holds one black point light) ---
    light_type: torch.Tensor       # [L] LIGHT_*
    light_L: torch.Tensor          # [L,31] radiance / intensity
    light_pos: torch.Tensor        # [L,3] point, spot, mapped lights
    light_dir: torch.Tensor        # [L,3] spot / distant / mapped axis
    light_params: torch.Tensor     # [L,4] spot: cos total, cos falloff;
    #                                mapped: -, -, texture id, cos(fov/2)
    light_quad: torch.Tensor       # [L] quadric of a sphere light, -1
    light_two_sided: torch.Tensor  # [L] bool
    light_area: torch.Tensor       # [L] mesh or sphere area
    light_tri_idx: torch.Tensor    # [L,T] prim indices, -1 pad
    light_tri_cdf: torch.Tensor    # [L,T+1] area cdf
    light_tri_packed: torch.Tensor  # [L*T,10] v0|e1|e2|flip
    light_sph_center: torch.Tensor  # [L,3] sphere light centre (world)
    light_sph_radius: torch.Tensor  # [L] sphere light radius (world)
    # light selection (lights/distrib.py): power, and per voxel of the
    # GRID^3 grid over [world_lo, world_hi]
    light_power_cdf: torch.Tensor   # [L+1]
    light_power_pmf: torch.Tensor   # [L]
    light_spatial_cdf: torch.Tensor  # [G^3,L+1]
    light_spatial_pmf: torch.Tensor  # [G^3,L]
    # the (last) infinite light's equirect map, 1x1 for a constant one
    # (black without one), and its 2D sampling tables
    env_map: torch.Tensor          # [He,We,31]
    env_cond_cdf: torch.Tensor     # [He,We+1] per-row cdf
    env_marg_cdf: torch.Tensor     # [He+1] row cdf
    env_cond_int: torch.Tensor     # [He] row integrals
    env_to_world: torch.Tensor     # [4,4]
    env_to_light: torch.Tensor     # [4,4]
    world_lo: torch.Tensor         # [3] scene bounds
    world_hi: torch.Tensor         # [3]
    # --- media (MediumInterface; the reference's api.cpp
    # pbrtMediumInterface): each primitive's inside / outside medium and
    # the media table; grids padded to the largest extents (homogeneous
    # rows hold a 1x1x1 grid of ones) ---
    prim_medium_in: torch.Tensor   # [P] medium inside, or -1 (vacuum)
    prim_medium_out: torch.Tensor  # [P] medium outside, or -1
    med_sigma_a: torch.Tensor      # [K,31]
    med_sigma_s: torch.Tensor      # [K,31]
    med_g: torch.Tensor            # [K]
    med_density: torch.Tensor      # [K,DZ,DY,DX]
    med_dims: torch.Tensor         # [K,3] (nz,ny,nx) of each grid
    med_w2m: torch.Tensor          # [K,4,4] world -> unit-cube medium
    med_inv_maxd: torch.Tensor     # [K] 1 / max density (the majorant)
    med_is_grid: torch.Tensor      # [K] bool
    # --- the BVH (accel/bvh.py's octant-threaded layout) and the walks'
    # triangle rows ---
    bvh_packed: torch.Tensor       # [N,8] f32 lo, hi, bitcast(leaf_bits),
    #                                axis
    bvh_links: torch.Tensor        # [8,N,2] i32 per-octant (enter, skip)
    #                                links side by side (accel_walk.bvh_links)
    tri_packed: torch.Tensor       # [P,12] f32 v0|e1|e2|0 (zero rows for
    #                                quadrics: they never hit)
    # --- textures (textures/textures.py); entry 0 is unused ---
    tex_images: torch.Tensor       # [T,2*RES,RES,3] mip canvases
    tex_type: torch.Tensor         # [T] TEX_*
    tex_params: torch.Tensor       # [T,8] uscale vscale udelta vdelta
    #                                wscale p5 p6 0
    tex_c1: torch.Tensor           # [T,3]
    tex_c2: torch.Tensor           # [T,3]
    world_radius: torch.Tensor     # [] half the scene's diagonal + 1e-3
    # --- dense intersector tables (ops/dense_intersect.py); None when
    # the scene is over the dense cap (use_dense false) ---
    dense_w: torch.Tensor = None   # [C,16,4*chunk] f32 s1|s2|num|s0
    #                                (motion: [C,16,N_COEF*4*chunk])
    dense_cb: torch.Tensor = None  # [C,8] chunk AABBs (centered coords)
    dense_static: torch.Tensor = None  # [C] bool: no triangle of the
    #                                chunk moves (all true when static)
    dense_center: torch.Tensor = None  # [3]
    # --- the SAH kd-tree (accel/kdtree.py), with `Accelerator "kdtree"`:
    # rows [split, bitcast(flags | above|offset | n_prims)] and the
    # duplicated primitive list ---
    kd_packed: torch.Tensor = None     # [Nk,4] f32 (ints bitcast)
    kd_prim_idx: torch.Tensor = None   # [M] i32
    kd_bounds: torch.Tensor = None     # [2,3] root box
    # the env map's luminance (the sampling tables' f32 product), so that
    # env sampling gathers one value a lane, not a row of spectra
    env_lum: torch.Tensor = None   # [He,We]
    # --- statics ---
    n_lights: int = 0
    n_quadrics: int = 0
    clip_quadrics: bool = False
    # the quadric types present (PRIM_*, sorted): the quadric test, normal
    # and uv launch only these (None: every type)
    quad_kinds: tuple = None
    dense_chunk: int = 128
    has_animated_mesh: bool = False
    has_animated_quads: bool = False
    dense_motion: bool = False     # dense_w is the motion table
    # the material families present (MAT_*, sorted) and the texture kinds
    # bound (TEX_*, sorted): the BSDF and texture dispatch launch only
    # these (None: every family)
    mat_families: tuple = None
    tex_kinds: tuple = None
    has_disney: bool = False
    has_mix: bool = False
    has_beckmann: bool = False
    has_bump: bool = False
    has_hair: bool = False
    has_fourier: bool = False      # a fourier lattice was registered
    has_sss: bool = False          # a BSSRDF table was registered
    has_ptex: bool = False
    # the light kinds present (LIGHT_*, sorted): sample_li launches only
    # these; area lights on meshes and on spheres separately
    light_kinds: tuple = ()
    has_mesh_lights: bool = False
    has_sphere_lights: bool = False
    has_infinite: bool = False
    inf_light_idx: int = 0         # the first infinite light's index
    has_prim_media: bool = False   # a MediumInterface bound a medium
    has_grid_media: bool = False   # ... and one of them is a grid
    camera_medium: int = -1        # the medium the camera sits in
    # the route (dense_route): the dense kernels, else the kd-tree when
    # built, else the BVH
    use_dense: bool = True
    use_kd: bool = False
    n_nodes: int = 0               # BVH nodes
    max_leaf: int = MAX_LEAF_SIZE  # prims a BVH leaf test takes (Queue 3 (v))
    kd_max_leaf: int = 0           # the largest kd leaf

    @property
    def device(self):
        return self.tri_v0.device

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
    eta_spec: np.ndarray = None    # [31] conductor eta (default 1)
    k_spec: np.ndarray = None      # [31] conductor k
    sigma: float = 0.0
    opacity: np.ndarray = None     # [31] (uber; default 1)
    remap_roughness: bool = True
    kd_tex: int = -1
    ks_tex: int = -1
    bump_tex: int = -1
    mix_a: int = -1
    mix_b: int = -1
    mix_amt: float = 0.5
    disney: tuple = (0.0,) * 8
    fourier_id: int = -1           # the scene's fourier lattice
    # subsurface: the profile table and the per-channel medium
    bssrdf_id: int = -1
    sss_sigma_t: np.ndarray = None  # [31] (default 1)
    sss_rho: np.ndarray = None      # [31] (default 0)
    # microfacet NDF: "ggx" (TrowbridgeReitz) or "beckmann" (microfacet.h:80)
    distribution: str = "ggx"
    name: str = ""

    def spectrum(self, key):
        v = getattr(self, key)
        if v is None:
            fill = 1.0 if key in ("eta_spec", "opacity",
                                  "sss_sigma_t") else 0.0
            return np.full(spec.N_SPECTRAL_SAMPLES, fill, np.float32)
        return np.asarray(v, np.float32)


@dataclass
class SceneBuilder:
    """Host-side scene assembly -> SceneData."""
    materials: list = field(default_factory=list)
    lights: list = field(default_factory=list)     # dicts (add_light)
    quads: list = field(default_factory=list)      # (o2w, w2o, params, o2w1)
    material_names: dict = field(default_factory=dict)
    has_animated_mesh: bool = False
    textures: TextureTable = field(default_factory=TextureTable)
    # media for MediumInterface: (sigma_a [31], sigma_s [31], g, density
    # [nz,ny,nx] or None, world_to_medium [4,4]); the (inside, outside)
    # pair that shapes added next take, and the camera's medium
    media_table: list = field(default_factory=list)
    current_medium: tuple = (-1, -1)
    camera_medium: int = -1
    fourier_grids: list = field(default_factory=list)   # [NM,NM,NP,3]
    bssrdf_tables: list = field(default_factory=list)   # [(key, table)]
    _chunks: list = field(default_factory=list)
    _mesh_light_tris: dict = field(default_factory=dict)
    _n_prims: int = 0

    def add_medium_record(self, sigma_a, sigma_s, g, density=None,
                          world_to_medium=None):
        """A medium for MediumInterface; returns its index.  density
        [nz,ny,nx] with world_to_medium [4,4] makes it a grid medium
        (GridDensityMedium, grid.cpp), bound per primitive like a
        homogeneous one."""
        self.media_table.append((
            np.asarray(sigma_a, np.float32), np.asarray(sigma_s, np.float32),
            float(g),
            None if density is None else np.asarray(density, np.float32),
            np.eye(4, dtype=np.float32) if world_to_medium is None
            else np.asarray(world_to_medium, np.float32)))
        return len(self.media_table) - 1

    def add_fourier_grid(self, grid) -> int:
        """A baked fourier lattice (materials/fourier.py bake_grid);
        returns its index."""
        self.fourier_grids.append(np.asarray(grid, np.float32))
        return len(self.fourier_grids) - 1

    def add_bssrdf_table(self, table) -> int:
        """A beam-diffusion profile table (materials/bssrdf.py
        compute_beam_diffusion_bssrdf); returns its index.  Tables are
        deduplicated by (g, eta): their rho and radius grids are the same
        by construction."""
        key = (round(float(table["g"]), 6), round(float(table["eta"]), 6))
        for i, (k, _) in enumerate(self.bssrdf_tables):
            if k == key:
                return i
        self.bssrdf_tables.append((key, table))
        return len(self.bssrdf_tables) - 1

    def add_material(self, mspec: MaterialSpec) -> int:
        self.materials.append(mspec)
        mid = len(self.materials) - 1
        if mspec.name:
            self.material_names[mid] = mspec.name
        return mid

    def add_light(self, **kw) -> int:
        """A light record: type (LIGHT_*), L [31], pos, dir, params [4],
        two_sided, and for an infinite light env_map [He,We,31] and
        light_to_world (a Transform).  Returns its id."""
        rec = dict(type=LIGHT_POINT,
                   L=np.zeros(spec.N_SPECTRAL_SAMPLES, np.float32),
                   pos=np.zeros(3, np.float32),
                   dir=np.array([0, 0, 1], np.float32),
                   params=np.zeros(4, np.float32), quad=-1, two_sided=False)
        rec.update(kw)
        self.lights.append(rec)
        return len(self.lights) - 1

    def add_area_light(self, L, two_sided=False) -> int:
        """A diffuse area light with radiance L [31]; returns its id, which
        a mesh or a sphere takes as light_id."""
        return self.add_light(type=LIGHT_AREA, L=np.asarray(L, np.float32),
                              two_sided=two_sided)

    def add_point_light(self, pos, I):
        return self.add_light(type=LIGHT_POINT,
                              pos=np.asarray(pos, np.float32),
                              L=np.asarray(I, np.float32))

    def add_distant_light(self, direction, L):
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self.add_light(type=LIGHT_DISTANT, dir=d.astype(np.float32),
                              L=np.asarray(L, np.float32))

    def add_infinite_light(self, L, env_map=None, light_to_world=None):
        return self.add_light(type=LIGHT_INFINITE,
                              L=np.asarray(L, np.float32), env_map=env_map,
                              light_to_world=light_to_world)

    def add_spot_light(self, pos, direction, I, cos_total, cos_falloff):
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self.add_light(type=LIGHT_SPOT,
                              pos=np.asarray(pos, np.float32),
                              dir=d.astype(np.float32),
                              L=np.asarray(I, np.float32),
                              params=np.array([cos_total, cos_falloff, 0, 0],
                                              np.float32))

    def _add_chunk(self, F, tri_v, tri_ns, tri_uv, ptype, quad_ref,
                   material_id, light_id, instance_id, flip, tri_dv=None):
        self._chunks.append(dict(
            tri_v=tri_v, tri_ns=tri_ns, tri_uv=tri_uv,
            tri_dv=np.zeros((F, 3, 3)) if tri_dv is None else tri_dv,
            prim_type=np.full(F, ptype, np.int32),
            quad_refs=np.full(F, quad_ref, np.int32),
            prim_material=np.full(F, material_id, np.int32),
            prim_light=np.full(F, light_id, np.int32),
            prim_instance=np.full(F, instance_id, np.int32),
            prim_flip=np.full(F, flip, bool),
            # the face index within the Shape (ptex's faceIndex)
            prim_face=np.arange(F, dtype=np.int32),
            prim_medium_in=np.full(F, self.current_medium[0], np.int32),
            prim_medium_out=np.full(F, self.current_medium[1], np.int32)))
        first = self._n_prims
        self._n_prims += F
        return first

    def add_triangle_mesh(self, vertices, indices, material_id,
                          normals=None, uvs=None, light_id=-1,
                          instance_id=0, flip_normal=False,
                          object_to_world: Transform = None,
                          object_to_world1: Transform = None):
        """Vertices [V,3] (object space when object_to_world is given),
        indices [F,3], optional per-vertex normals [V,3] and uvs [V,2]
        (default uvs (0,0) (1,0) (1,1)).

        object_to_world1: the second keyframe (mesh motion blur): the
        vertices move linearly from their object_to_world position to
        this one over the shutter."""
        vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if object_to_world is not None:
            w_verts = object_to_world.apply_point(vertices)
            w_norms = (None if normals is None else object_to_world
                       .apply_normal(np.asarray(normals, np.float64)
                                     .reshape(-1, 3)))
            if object_to_world.swaps_handedness():
                flip_normal = not flip_normal
        else:
            w_verts = vertices
            w_norms = (None if normals is None
                       else np.asarray(normals, np.float64).reshape(-1, 3))
        F = len(indices)
        tri_dv = None
        if object_to_world1 is not None:
            tri_dv = (object_to_world1.apply_point(vertices)
                      - w_verts)[indices]
            self.has_animated_mesh = True
        tri_ns = (w_norms[indices] if w_norms is not None
                  else np.zeros((F, 3, 3)))
        tri_uv = (np.asarray(uvs, np.float64).reshape(-1, 2)[indices]
                  if uvs is not None else np.broadcast_to(
                      np.array([[0., 0.], [1., 0.], [1., 1.]]),
                      (F, 3, 2)).copy())
        first = self._add_chunk(F, w_verts[indices], tri_ns, tri_uv,
                                PRIM_TRIANGLE, -1, material_id, light_id,
                                instance_id, flip_normal, tri_dv=tri_dv)
        if light_id >= 0:
            self._mesh_light_tris.setdefault(light_id, []).extend(
                range(first, first + F))
        return first, F

    def add_quadric(self, qtype, object_to_world: Transform, params,
                    material_id, light_id=-1, instance_id=0,
                    flip_normal=False, object_to_world1: Transform = None):
        """qtype: PRIM_SPHERE, PRIM_CYLINDER, PRIM_DISK, PRIM_CONE or
        PRIM_PARABOLOID; params (radius, zmin, zmax, phimax radians), a
        disk's (radius, height, innerradius, phimax) and a cone's (radius,
        0, height, phimax), as the JAX package keeps them.
        object_to_world1: the second keyframe (motion blur)."""
        if object_to_world.swaps_handedness():
            flip_normal = not flip_normal
        qi = len(self.quads)
        self.quads.append((object_to_world.m.astype(np.float32),
                           object_to_world.m_inv.astype(np.float32),
                           np.asarray(params, np.float32), int(qtype),
                           None if object_to_world1 is None
                           else object_to_world1.m.astype(np.float32)))
        first = self._add_chunk(1, np.zeros((1, 3, 3)), np.zeros((1, 3, 3)),
                                np.zeros((1, 3, 2)), qtype, qi, material_id,
                                light_id, instance_id, flip_normal)
        return first, qi

    def add_sphere(self, object_to_world: Transform, radius, material_id,
                   light_id=-1, zmin=None, zmax=None, phimax=2 * np.pi,
                   **kw):
        zmin = -radius if zmin is None else zmin
        zmax = radius if zmax is None else zmax
        return self.add_quadric(PRIM_SPHERE, object_to_world,
                                (radius, zmin, zmax, phimax), material_id,
                                light_id, **kw)

    def _concat(self):
        keys = ("tri_v", "tri_ns", "tri_uv", "tri_dv", "prim_type",
                "quad_refs", "prim_material", "prim_light", "prim_instance",
                "prim_flip", "prim_face", "prim_medium_in",
                "prim_medium_out")
        return {k: np.concatenate([c[k] for c in self._chunks], 0)
                for k in keys}

    def _prim_bounds(self, soa):
        # moving triangles: the union of both keyframes; quadrics: their
        # first keyframe's object box, as the JAX package bounds them (a
        # disk's a thin slab at its height)
        v1 = soa["tri_v"] + soa["tri_dv"]
        lo = np.minimum(soa["tri_v"].min(1), v1.min(1)).astype(np.float64)
        hi = np.maximum(soa["tri_v"].max(1), v1.max(1)).astype(np.float64)
        for i in np.nonzero(soa["prim_type"] != PRIM_TRIANGLE)[0]:
            o2w, _, params, qtype, _ = self.quads[soa["quad_refs"][i]]
            r = abs(float(params[0]))
            zmin, zmax = float(params[1]), float(params[2])
            zs = ((zmin - 1e-4, zmin + 1e-4) if qtype == PRIM_DISK
                  else (min(zmin, zmax), max(zmin, zmax)))
            corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r)
                                for z in zs])
            wc = Transform(o2w.astype(np.float64)).apply_point(corners)
            lo[i], hi[i] = wc.min(0), wc.max(0)
        return lo, hi

    def build(self, device=None, accel="bvh") -> SceneData:
        """The SceneData on `device` (None: the first CUDA card).

        The BVH is always built (SAH, leaves of MAX_LEAF_SIZE); accel
        "kdtree" also builds the kd-tree over the reordered bounds, as
        pbrt_tpu does, and a scene over the dense cap then walks it."""
        device = devmod.resolve(device)
        P = self._n_prims
        if P == 0:
            raise ValueError("scene has no primitives")
        soa = self._concat()
        lo, hi = self._prim_bounds(soa)
        bvh = build_bvh(lo, hi, MAX_LEAF_SIZE)
        order = bvh.prim_order
        kd = build_kdtree(lo[order], hi[order]) if accel == "kdtree" else None

        def reorder(key, dtype=np.float32):
            return soa[key][order].astype(dtype)

        tri = reorder("tri_v")
        tri_v0 = tri[:, 0]
        tri_e1 = tri[:, 1] - tri[:, 0]
        tri_e2 = tri[:, 2] - tri[:, 0]
        tri_dv = reorder("tri_dv")
        tri_motion = np.zeros((P, 12), np.float32)
        tri_motion[:, 0:3] = tri_dv[:, 0]
        tri_motion[:, 3:6] = tri_dv[:, 1] - tri_dv[:, 0]
        tri_motion[:, 6:9] = tri_dv[:, 2] - tri_dv[:, 0]

        Q = max(len(self.quads), 1)
        q_w2o = np.tile(np.eye(4, dtype=np.float32), (Q, 1, 1))
        q_par = np.zeros((Q, 4), np.float32)
        q_type = np.zeros(Q, np.int32)
        q_at = np.zeros((Q, 2, 3), np.float32)
        q_aq = np.tile(np.asarray([1, 0, 0, 0], np.float32), (Q, 2, 1))
        q_as = np.tile(np.eye(3, dtype=np.float32), (Q, 2, 1, 1))
        animated_quads = False
        for i, (m, mi, par, qt, m1) in enumerate(self.quads):
            q_w2o[i], q_par[i], q_type[i] = mi, par, qt
            moving = m1 is not None and not np.allclose(m1, m)
            animated_quads |= moving
            q_at[i], q_aq[i], q_as[i] = animated_pair(m, m1 if moving else m)
        q_prim = np.zeros(Q, np.int32)
        qref = reorder("quad_refs", np.int32)
        qmask = np.nonzero(qref >= 0)[0]
        q_prim[qref[qmask]] = qmask
        clip_q = any(_needs_clip(p, qt) for _, _, p, qt, _ in self.quads)

        mats = self.materials or [MaterialSpec()]

        def mcol(key):
            return np.stack([m.spectrum(key) for m in mats])

        def mlist(key, dtype):
            return np.asarray([getattr(m, key) for m in mats], dtype)

        tex_imgs, tex_t, tex_p, tex_a, tex_b = self.textures.arrays()
        lo_w, hi_w = lo.min(0), hi.max(0)
        radius = 0.5 * float(np.linalg.norm(hi_w - lo_w)) + 1e-3
        world_radius = np.float32(radius)
        light_arrays, light_statics = self._light_tables(
            soa, order, reorder("prim_flip", bool), tri_v0, tri_e1, tri_e2,
            lo_w, hi_w, radius)
        arrays = dict(
            prim_type=reorder("prim_type", np.int32),
            tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
            tri_motion=tri_motion,
            tri_ns=reorder("tri_ns"), tri_uv=reorder("tri_uv"),
            quad_idx=qref,
            prim_material=reorder("prim_material", np.int32),
            prim_light=reorder("prim_light", np.int32),
            prim_instance=reorder("prim_instance", np.int32),
            prim_flip_normal=reorder("prim_flip", bool),
            prim_face=reorder("prim_face", np.int32),
            quad_w2o=q_w2o, quad_params=q_par, quad_type=q_type,
            quad_prim=q_prim,
            quad_anim_t=q_at, quad_anim_q=q_aq, quad_anim_s=q_as,
            mat_type=np.asarray([m.type for m in mats], np.int32),
            mat_kd=mcol("kd"), mat_ks=mcol("ks"), mat_kr=mcol("kr"),
            mat_kt=mcol("kt"),
            mat_rough_u=np.asarray([m.rough_u for m in mats], np.float32),
            mat_rough_v=np.asarray([m.rough_v for m in mats], np.float32),
            mat_eta=np.asarray([m.eta for m in mats], np.float32),
            mat_sigma=np.asarray([m.sigma for m in mats], np.float32),
            mat_remap_rough=np.asarray([m.remap_roughness for m in mats],
                                       bool),
            mat_kd_tex=mlist("kd_tex", np.int32),
            mat_ks_tex=mlist("ks_tex", np.int32),
            mat_bump_tex=mlist("bump_tex", np.int32),
            mat_mix_a=mlist("mix_a", np.int32),
            mat_mix_b=mlist("mix_b", np.int32),
            mat_mix_amt=mlist("mix_amt", np.float32),
            mat_disney=mlist("disney", np.float32).reshape(len(mats), 8),
            mat_eta_spec=mcol("eta_spec"), mat_k_spec=mcol("k_spec"),
            mat_opacity=mcol("opacity"),
            mat_beckmann=np.asarray([m.distribution == "beckmann"
                                     for m in mats], bool),
            mat_fourier_id=mlist("fourier_id", np.int32),
            mat_bssrdf_id=mlist("bssrdf_id", np.int32),
            mat_sss_sigma_t=mcol("sss_sigma_t"), mat_sss_rho=mcol("sss_rho"),
            **self._fourier_arrays(), **self._bssrdf_arrays(),
            tex_images=tex_imgs, tex_type=tex_t, tex_params=tex_p,
            tex_c1=tex_a, tex_c2=tex_b, world_radius=world_radius,
            prim_medium_in=reorder("prim_medium_in", np.int32),
            prim_medium_out=reorder("prim_medium_out", np.int32),
            bvh_packed=bvh.packed, bvh_hit=bvh.hit_links,
            bvh_miss=bvh.miss_links, **_kd_arrays(kd),
            **self._media_arrays(), **light_arrays)
        use_dense = dense_route(P, self.has_animated_mesh)
        statics = dict(n_quadrics=len(self.quads),
                       clip_quadrics=bool(clip_q), dense_chunk=None,
                       has_animated_mesh=self.has_animated_mesh,
                       has_animated_quads=animated_quads,
                       dense_motion=self.has_animated_mesh and use_dense,
                       use_dense=use_dense, use_kd=kd is not None,
                       n_nodes=bvh.n_nodes, max_leaf=bvh.max_leaf_size,
                       kd_max_leaf=0 if kd is None else kd["max_leaf"],
                       has_prim_media=bool(self.media_table),
                       has_grid_media=any(m[3] is not None
                                          for m in self.media_table),
                       camera_medium=int(self.camera_medium),
                       has_fourier=bool(self.fourier_grids),
                       has_sss=bool(self.bssrdf_tables),
                       **light_statics,
                       **material_statics(arrays["mat_type"],
                                          arrays["mat_beckmann"],
                                          arrays["mat_bump_tex"], tex_t))
        return _scene_from_arrays(arrays, statics, device)

    def _fourier_arrays(self):
        """The fourier lattices and their sampling marginals, as the JAX
        package stacks them (pbrt_tpu/scene/ir.py:828-835), with zero
        placeholders in a scene without any."""
        from pbrt_tpu_torch.materials.fourier import bake_cr_tables
        if not self.fourier_grids:
            return dict(fourier_grid=np.zeros((1, 2, 2, 2, 3), np.float32),
                        fourier_a0=np.zeros((1, 2, 2), np.float32),
                        fourier_lum=np.zeros((1, 2, 2, 2), np.float32))
        crs = [bake_cr_tables(g) for g in self.fourier_grids]
        return dict(fourier_grid=np.stack(self.fourier_grids),
                    fourier_a0=np.stack([c[0] for c in crs]),
                    fourier_lum=np.stack([c[1] for c in crs]))

    def _bssrdf_arrays(self):
        """The profile tables stacked (pbrt_tpu/scene/ir.py:998-1022),
        with zero placeholders in a scene without any."""
        t = [tab for _, tab in self.bssrdf_tables]
        if not t:
            return dict(bssrdf_profile=np.zeros((1, 2, 2), np.float32),
                        bssrdf_cdf=np.zeros((1, 2, 2), np.float32),
                        bssrdf_rho=np.array([0.0, 1.0], np.float32),
                        bssrdf_radius=np.array([0.0, 1.0], np.float32))
        return dict(bssrdf_profile=np.stack([x["profile"] for x in t]),
                    bssrdf_cdf=np.stack([x["cdf"] for x in t]),
                    bssrdf_rho=np.asarray(t[0]["rho"], np.float32),
                    bssrdf_radius=np.asarray(t[0]["radius"], np.float32))

    def _media_arrays(self):
        """The media table as the JAX package's builder makes it
        (pbrt_tpu/scene/ir.py:920-946, :1023-1045): grids zero-padded to
        the largest extents, a 1x1x1 grid of ones for a homogeneous
        medium, one vacuum row when there is no medium."""
        table = self.media_table
        K = max(len(table), 1)
        dens = [m[3] if m[3] is not None else np.ones((1, 1, 1), np.float32)
                for m in table] or [np.ones((1, 1, 1), np.float32)]
        DZ, DY, DX = (max(d.shape[i] for d in dens) for i in range(3))
        density = np.zeros((K, DZ, DY, DX), np.float32)
        dims = np.ones((K, 3), np.int32)
        w2m = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        inv_maxd = np.ones(K, np.float32)
        for i, d in enumerate(dens):
            density[i, :d.shape[0], :d.shape[1], :d.shape[2]] = d
            dims[i] = d.shape
            inv_maxd[i] = 1.0 / max(float(d.max()), 1e-9)
            if i < len(table):
                w2m[i] = table[i][4]
        zeros = np.zeros((1, spec.N_SPECTRAL_SAMPLES), np.float32)
        return dict(
            med_sigma_a=np.stack([m[0] for m in table]) if table else zeros,
            med_sigma_s=np.stack([m[1] for m in table]) if table else zeros,
            med_g=np.asarray([m[2] for m in table] or [0.0], np.float32),
            med_density=density, med_dims=dims, med_w2m=w2m,
            med_inv_maxd=inv_maxd,
            med_is_grid=np.asarray([m[3] is not None for m in table]
                                   or [False], bool))

    def _light_tables(self, soa, order, prim_flip, tri_v0, tri_e1, tri_e2,
                      world_lo, world_hi, world_radius):
        """The light records' arrays and statics, as the JAX package's
        builder makes them (pbrt_tpu/scene/ir.py:731-846): mesh lights'
        padded triangle lists and area cdfs, sphere lights' world centre
        and radius, the selection tables and the env map's tables."""
        from pbrt_tpu_torch.lights.distrib import build_distributions
        P = len(order)
        Lc = max(len(self.lights), 1)
        lights = self.lights or [dict(type=LIGHT_POINT,
                                      L=np.zeros(31, np.float32),
                                      pos=np.zeros(3, np.float32),
                                      dir=np.array([0, 0, 1], np.float32),
                                      params=np.zeros(4, np.float32),
                                      quad=-1, two_sided=False)]
        inv_order = np.zeros(P, np.int64)
        inv_order[order] = np.arange(P)
        max_lt = max([len(v) for v in self._mesh_light_tris.values()] + [1])
        lt_idx = np.full((Lc, max_lt), -1, np.int32)
        lt_cdf = np.zeros((Lc, max_lt + 1), np.float32)
        l_area = np.zeros(Lc, np.float32)
        l_quad = np.full(Lc, -1, np.int32)
        for li, rec in enumerate(lights):
            if rec["type"] != LIGHT_AREA:
                continue
            tris = self._mesh_light_tris.get(li, [])
            if tris:
                t_old = np.asarray(tris)
                v = soa["tri_v"][t_old]
                areas = 0.5 * np.linalg.norm(
                    np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
                total = areas.sum()
                lt_idx[li, :len(tris)] = inv_order[t_old]
                lt_cdf[li, 1:len(tris) + 1] = (np.cumsum(areas)
                                               / max(total, 1e-20))
                lt_cdf[li, len(tris) + 1:] = 1.0
                l_area[li] = total
            else:
                # an area light on a sphere: its quadric (one on another
                # quadric gets no light geometry, as in the JAX package)
                cand = np.nonzero((soa["prim_light"] == li)
                                  & (soa["prim_type"] == PRIM_SPHERE))[0]
                if len(cand):
                    qi = int(soa["quad_refs"][cand[0]])
                    l_quad[li] = qi
                    r = float(self.quads[qi][2][0])
                    # a uniform scale in o2w scales the radius
                    s = np.linalg.norm(self.quads[qi][0][:3, 0])
                    l_area[li] = 4 * np.pi * (r * s) ** 2
        flat_lt = lt_idx.reshape(-1)
        lt_safe = np.clip(flat_lt, 0, P - 1)
        lt_valid = (flat_lt >= 0).astype(np.float32)[:, None]
        ltp = np.zeros((Lc * max_lt, 10), np.float32)
        ltp[:, 0:3] = tri_v0[lt_safe] * lt_valid
        ltp[:, 3:6] = tri_e1[lt_safe] * lt_valid
        ltp[:, 6:9] = tri_e2[lt_safe] * lt_valid
        ltp[:, 9] = prim_flip[lt_safe].astype(np.float32) * lt_valid[:, 0]
        l_sphc = np.zeros((Lc, 3), np.float32)
        l_sphr = np.zeros(Lc, np.float32)
        for li in range(Lc):
            qi = int(l_quad[li])
            if qi >= 0:
                o2w_q = np.asarray(self.quads[qi][0], np.float32)
                l_sphc[li] = o2w_q[:3, 3]
                l_sphr[li] = (float(self.quads[qi][2][0])
                              * float(np.linalg.norm(o2w_q[:3, 0])))

        # the infinite light's env map (a constant one: 1x1); the last
        # infinite light's, as in the JAX package
        env = np.zeros((1, 1, spec.N_SPECTRAL_SAMPLES), np.float32)
        env_to_world = np.eye(4, dtype=np.float32)
        for rec in lights:
            if rec["type"] == LIGHT_INFINITE:
                if rec.get("env_map") is not None:
                    env = np.asarray(rec["env_map"], np.float32)
                else:
                    env = rec["L"].reshape(1, 1, -1).astype(np.float32)
                if rec.get("light_to_world") is not None:
                    env_to_world = rec["light_to_world"].m.astype(np.float32)
        # its importance distribution: luminance times sin(theta)
        He, We = env.shape[:2]
        lum = env @ spec.CIE_Y.astype(np.float32)
        theta = (np.arange(He) + 0.5) / He * np.pi
        f2d = lum * np.sin(theta)[:, None] + 1e-12
        cond_cdf = np.zeros((He, We + 1), np.float32)
        cond_int = f2d.mean(1)
        cond_cdf[:, 1:] = np.cumsum(f2d, 1) / np.maximum(
            f2d.sum(1, keepdims=True), 1e-20)
        marg = np.zeros(He + 1, np.float32)
        marg[1:] = np.cumsum(cond_int) / max(cond_int.sum(), 1e-20)
        pw_cdf, pw_pmf, sp_cdf, sp_pmf = build_distributions(
            self, world_lo, world_hi, l_area, world_radius)
        arrays = dict(
            light_type=np.asarray([rec["type"] for rec in lights], np.int32),
            light_L=np.stack([rec["L"] for rec in lights]).astype(np.float32),
            light_pos=np.stack([rec["pos"] for rec in lights]).astype(
                np.float32),
            light_dir=np.stack([rec["dir"] for rec in lights]).astype(
                np.float32),
            light_params=np.stack([rec["params"] for rec in lights]).astype(
                np.float32),
            light_quad=l_quad,
            light_two_sided=np.asarray([bool(rec["two_sided"])
                                        for rec in lights]),
            light_area=l_area, light_tri_idx=lt_idx, light_tri_cdf=lt_cdf,
            light_tri_packed=ltp, light_sph_center=l_sphc,
            light_sph_radius=l_sphr, light_power_cdf=pw_cdf,
            light_power_pmf=pw_pmf, light_spatial_cdf=sp_cdf,
            light_spatial_pmf=sp_pmf, env_map=env, env_cond_cdf=cond_cdf,
            env_marg_cdf=marg, env_cond_int=cond_int.astype(np.float32),
            env_to_world=env_to_world,
            env_to_light=np.linalg.inv(env_to_world.astype(np.float64))
            .astype(np.float32),
            world_lo=np.asarray(world_lo, np.float32),
            world_hi=np.asarray(world_hi, np.float32))
        statics = dict(
            n_lights=len(self.lights),
            light_kinds=tuple(sorted({int(rec["type"])
                                      for rec in self.lights})),
            has_mesh_lights=any(rec["type"] == LIGHT_AREA and l_quad[i] < 0
                                for i, rec in enumerate(self.lights)),
            has_sphere_lights=bool((l_quad[:len(self.lights)] >= 0).any()),
            has_infinite=any(rec["type"] == LIGHT_INFINITE
                             for rec in lights),
            inf_light_idx=next((i for i, rec in enumerate(lights)
                                if rec["type"] == LIGHT_INFINITE), 0))
        return arrays, statics


def _needs_clip(params, qtype):
    """Whether a quadric needs the z / phi clip tests: every one but a
    full sphere (pbrt_tpu/scene/ir.py:876-884)."""
    if qtype != PRIM_SPHERE:
        return True
    return (float(params[3]) < 2 * np.pi - 1e-5
            or float(params[1]) > -float(params[0]) + 1e-6
            or float(params[2]) < float(params[0]) - 1e-6)


def dense_route(n_prims, animated):
    """Whether a scene of n_prims primitives takes the dense kernels:
    at most MAX_DENSE_PRIMS, or MAX_MOTION_PRIMS once a mesh moves (the
    motion table is 4x as large), as pbrt_tpu/scene/ir.py:900 decides.
    Above the cap it walks the BVH or the kd-tree."""
    return 0 < n_prims <= (MAX_MOTION_PRIMS if animated else MAX_DENSE_PRIMS)


def _kd_arrays(kd):
    """The SceneData columns of a build_kdtree result (None: no tree), as
    pbrt_tpu packs them (pbrt_tpu/scene/ir.py:1111-1117)."""
    if kd is None:
        return dict.fromkeys(KD_COLUMNS)
    return dict(
        kd_packed=np.concatenate([
            kd["nodes_f"][:, None],
            kd["nodes_i"].astype(np.int32).view(np.float32)], 1),
        kd_prim_idx=kd["prim_idx"], kd_bounds=kd["bounds"])


def material_statics(mat_type, beckmann, bump_tex, tex_type):
    """The static flags of a material and texture table (as the JAX
    package's builder sets them).  A subsurface material's lanes turn
    into mirror (the smooth interface's reflection), rough glass (the
    rough interface's) and the Sw exit lobe at run time, so those
    families are present with it (pbrt_tpu/scene/ir.py:984-990)."""
    mat_type = np.asarray(mat_type)
    fams = {int(t) for t in set(mat_type.tolist())}
    if fams & {MAT_SUBSURFACE, MAT_KDSUBSURFACE}:
        fams |= {MAT_MIRROR, MAT_ROUGHGLASS, MAT_SSW}
    return dict(
        mat_families=tuple(sorted(fams)),
        tex_kinds=tuple(sorted({int(t) for t in np.asarray(tex_type)[1:]})),
        has_disney=bool(np.any(mat_type == MAT_DISNEY)),
        has_mix=bool(np.any(mat_type == MAT_MIX)),
        has_beckmann=bool(np.any(beckmann)),
        has_bump=bool(np.any(np.asarray(bump_tex) >= 0)),
        has_hair=bool(np.any(mat_type == MAT_HAIR)),
        has_ptex=bool(np.any(np.asarray(tex_type) == TEX_PTEX)))


def _scene_from_arrays(arrays, statics, device):
    use_dense = bool(statics["use_dense"])
    dense = {}
    if use_dense:
        if statics["dense_motion"]:
            dt = build_dense_tables_motion(
                arrays["tri_v0"], arrays["tri_e1"], arrays["tri_e2"],
                arrays["tri_motion"], chunk=statics["dense_chunk"])
        else:
            dt = build_dense_tables(arrays["tri_v0"], arrays["tri_e1"],
                                    arrays["tri_e2"],
                                    chunk=statics["dense_chunk"])
            dt["chunk_static"] = np.ones(dt["W"].shape[0], bool)
        dense = dict(dense_w=dt["W"], dense_cb=dt["chunk_bounds"],
                     dense_static=dt["chunk_static"],
                     dense_center=dt["center"])
    v0 = np.asarray(arrays["tri_v0"], np.float32)
    tri_packed = np.concatenate([v0, np.asarray(arrays["tri_e1"], np.float32),
                                 np.asarray(arrays["tri_e2"], np.float32),
                                 np.zeros_like(v0)], 1)
    cols = {k: torch.as_tensor(np.array(arrays[k]), device=device)
            for k in JAX_COLUMNS + PACKED_COLUMNS + SHADE_COLUMNS
            + ("bvh_packed",)
            + (KD_COLUMNS if statics["use_kd"] else ())}
    cols.update((k, torch.as_tensor(np.array(v), device=device))
                for k, v in dense.items())
    # the f32 product of the env tables' builder (pbrt_tpu/scene/ir.py:820)
    env_lum = np.asarray(arrays["env_map"], np.float32) @ \
        spec.CIE_Y.astype(np.float32)
    return SceneData(
        **cols,
        bvh_links=accel_walk.bvh_links(
            *(torch.as_tensor(np.array(arrays[k]), device=device)
              for k in ("bvh_hit", "bvh_miss"))),
        env_lum=torch.as_tensor(env_lum, device=device),
        tri_packed=torch.as_tensor(tri_packed, device=device),
        n_lights=int(statics["n_lights"]),
        n_quadrics=int(statics["n_quadrics"]),
        clip_quadrics=bool(statics["clip_quadrics"]),
        quad_kinds=tuple(sorted({int(t) for t in np.asarray(
            arrays["quad_type"])[:int(statics["n_quadrics"])]})),
        dense_chunk=int(dt["chunk"]) if use_dense else 0,
        has_animated_mesh=bool(statics["has_animated_mesh"]),
        has_animated_quads=bool(statics["has_animated_quads"]),
        dense_motion=bool(statics["dense_motion"]),
        mat_families=tuple(statics["mat_families"]),
        tex_kinds=tuple(statics["tex_kinds"]),
        has_disney=bool(statics["has_disney"]),
        has_mix=bool(statics["has_mix"]),
        has_beckmann=bool(statics["has_beckmann"]),
        has_bump=bool(statics["has_bump"]),
        has_hair=bool(statics["has_hair"]),
        has_fourier=bool(statics["has_fourier"]),
        has_sss=bool(statics["has_sss"]),
        has_ptex=bool(statics["has_ptex"]),
        light_kinds=tuple(int(k) for k in statics["light_kinds"]),
        has_mesh_lights=bool(statics["has_mesh_lights"]),
        has_sphere_lights=bool(statics["has_sphere_lights"]),
        has_infinite=bool(statics["has_infinite"]),
        inf_light_idx=int(statics["inf_light_idx"]),
        has_prim_media=bool(statics["has_prim_media"]),
        has_grid_media=bool(statics["has_grid_media"]),
        camera_medium=int(statics["camera_medium"]),
        use_dense=use_dense, use_kd=bool(statics["use_kd"]),
        n_nodes=int(statics["n_nodes"]), max_leaf=int(statics["max_leaf"]),
        kd_max_leaf=int(statics["kd_max_leaf"]))


def scene_from_jax(arrays: dict, statics: dict, device) -> SceneData:
    """The port's SceneData for a pbrt_tpu scene.

    arrays: {name: np.asarray(getattr(jax_scene, name))} for every name in
    JAX_ARRAYS; statics: the static fields named in JAX_STATICS.  The
    conductor spectra, the opacity, the Beckmann flag, the fourier and
    BSSRDF ids and the subsurface medium come from the packed material
    table (PACKED_COLUMNS), the face index from the shading rows
    (SHADE_COLUMNS).  The BVH, the kd-tree (when
    `use_kd`) and the route's flags come across unchanged.  The dense
    tables (static, or motion when `dense_motion`) are recomputed from
    tri_v0/e1/e2 and tri_motion when `use_dense`, since the JAX scene's
    `dense_w` is the TPU's bf16x2 layout."""
    for k in JAX_ARRAYS:
        if k not in arrays:
            raise KeyError(f"scene_from_jax needs array {k!r}")
    packed = np.asarray(arrays["mat_packed"], np.float32)
    M = packed.shape[0] // 2
    row = packed[:M] + packed[M:]          # bf16 hi + residual: exact f32
    shade = np.asarray(arrays["shade_all"], np.float32)
    arrays = dict(arrays,
                  mat_eta_spec=row[:, _MPK_ETA_SPEC:_MPK_ETA_SPEC + _NS],
                  mat_k_spec=row[:, _MPK_K_SPEC:_MPK_K_SPEC + _NS],
                  mat_opacity=row[:, _MPK_OPACITY:_MPK_OPACITY + _NS],
                  mat_beckmann=row[:, _MPK_BECKMANN] > 0.5,
                  mat_fourier_id=np.round(row[:, _MPK_FOURIER]).astype(
                      np.int32),
                  mat_bssrdf_id=np.round(row[:, _MPK_BSSRDF]).astype(
                      np.int32),
                  mat_sss_sigma_t=row[:, _MPK_SSS_SIGT:_MPK_SSS_SIGT + _NS],
                  mat_sss_rho=row[:, _MPK_SSS_RHO:_MPK_SSS_RHO + _NS],
                  prim_face=np.ascontiguousarray(
                      shade[:, _SHADE_FACE]).view(np.int32))
    return _scene_from_arrays(arrays, statics, devmod.resolve(device))
