"""pbrt scene-API state machine (port of pbrt_tpu.parser.api; reference:
src/core/api.{h,cpp}).

Directives: Identity, Translate, Scale, Rotate, LookAt, Transform,
ConcatTransform, CoordinateSystem / CoordSysTransform (with the "camera"
and "world" systems that Camera and WorldBegin name), ActiveTransform,
TransformTimes (recorded and read nowhere: motion spans the shutter
[0, 1]), TransformBegin/End, Camera "perspective"/
"orthographic"/"environment"/"realistic"/"omni"/"realisticEye" (and its
aliases; another kind renders as perspective), Film (any name read as
"image"; its cropwindow and maxsampleluminance too),
PixelFilter "box"/"triangle"/"gaussian"/"mitchell"/"sinc", Sampler (its
aliases mapped, an unknown kind falling back to halton with a warning,
as in the JAX package), Integrator, Accelerator (a scene under the dense
cap takes the dense kernels whatever it names; above it "kdtree" walks
the kd-tree and any other kind the BVH),
Include, WorldBegin/End, AttributeBegin/End, ObjectBegin / ObjectEnd /
ObjectInstance (each instance baked into world-space primitives with an
instance id of its own), ReverseOrientation, Texture (constant, scale,
mix and bilerp folded to constants; imagemap, checkerboard, uv, dots,
fbm, wrinkled, marble, windy, ptex), Material and MakeNamedMaterial /
NamedMaterial for "" / "none", matte, plastic, mirror, glass (rough glass
too), metal, uber, substrate, translucent, retroreflective, disney, mix,
hair (sigma_a, color, or eumelanin and pheomelanin), fourier (a SCATFUN
bsdffile, baked at parse time), subsurface (sigma_a / sigma_s, or a
measured preset by "string name") and kdsubsurface (Kd and mfp through
SubsurfaceFromDiffuse), with texture-valued Kd / Ks, "string
distribution" ("ggx" or "beckmann") and "texture bumpmap", LightSource
"point"/"spot"/"distant"/"infinite"/"exinfinite" (an env map in any
format film/io.py reads)/"goniometric"/"projection", AreaLightSource
on any shape (every kind diffuse),
MakeNamedMedium (homogeneous, and "heterogeneous" / "grid" density grids
under the CTM at their creation; presets, sigma_a, sigma_s, scale, g),
MediumInterface (the camera's medium resolved at WorldEnd), and Shape
"trianglemesh", "plymesh", "sphere", "cylinder", "disk", "cone",
"paraboloid", and "hyperboloid", "loopsubdiv", "heightfield", "curve"
and "nurbs" tessellated to triangles (shapes/).  Each keeps the JAX
package's semantics and warnings, including the two-keyframe CTM that
gives meshes and quadrics motion blur (but for meshes inside ObjectBegin)
and the imagemap or ptex file that cannot be read becoming a 0.5
constant and the fourier file a matte material.

A directive, light, shape or material the JAX package does not know is
skipped with a warning, as there (an unknown material is matte).  A
camera, film or area light kind that the JAX package renders as another
(perspective, "image", diffuse) and TransformTimes other than 0 1 are
read as there, with a warning naming what the render does instead.  A
PixelFilter other than those above raises NotImplementedError, as the
JAX package raises on it.
"""

from __future__ import annotations

import copy
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from pbrt_tpu_torch.cameras.lens import LENS_KINDS
from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.materials import bssrdf as bssrdfmod
from pbrt_tpu_torch.materials import fourier as fouriermod
from pbrt_tpu_torch.materials.metal_data import conductor_eta_k
from pbrt_tpu_torch.media.media import medium_coefficients, medium_grid
from pbrt_tpu_torch.media.presets import get_medium_scattering_properties
from pbrt_tpu_torch.parser.paramset import ParamSet, parse_param_list
from pbrt_tpu_torch.parser.tokenizer import (TokenStream, tokenize,
                                             tokenize_file, unquote)
from pbrt_tpu_torch.samplers.samplers import SAMPLER_TYPES
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.scene.ir import MaterialSpec, SceneBuilder
from pbrt_tpu_torch.shapes.curve import curve_from_params
from pbrt_tpu_torch.shapes.nurbs import (tessellate_hyperboloid,
                                         tessellate_nurbs)
from pbrt_tpu_torch.shapes.ply import read_ply
from pbrt_tpu_torch.shapes.subdiv import loop_subdivide
from pbrt_tpu_torch.textures import ptex as ptexmod
from pbrt_tpu_torch.textures import textures as texmod

log = logging.getLogger("pbrt_tpu_torch")


@dataclass
class GraphicsState:
    """reference: api.cpp:212+ GraphicsState (the ported attributes)."""
    material_id: int = 0
    area_light: dict | None = None
    reverse_orientation: bool = False
    # name -> ("const", value) or ("tex", texture id), by texture type
    float_textures: dict = field(default_factory=dict)
    spectrum_textures: dict = field(default_factory=dict)
    named_materials: dict = field(default_factory=dict)  # name -> id
    # MediumInterface's named media ("" is vacuum)
    inside_medium: str = ""
    outside_medium: str = ""

    def clone(self):
        g = copy.copy(self)
        g.float_textures = dict(self.float_textures)
        g.spectrum_textures = dict(self.spectrum_textures)
        g.named_materials = dict(self.named_materials)
        return g


@dataclass
class RenderJob:
    """Everything WorldEnd produced; consumed by the CLI and the tests."""
    scene: object
    camera_kind: str
    camera_params: dict
    cam_to_world: tfm.Transform
    film_width: int
    film_height: int
    film_filename: str
    film_scale: float
    spectral_flag: bool
    crop_window: tuple
    filter_name: str
    filter_params: dict
    sampler_kind: str
    spp: int
    integrator_kind: str
    integrator_params: dict
    instance_names: dict
    material_names: dict
    film_diagonal: float = 35.0     # mm (the lens cameras' film)
    max_sample_luminance: float = 1e30
    # second camera keyframe (camera motion blur); None for a static camera
    cam_to_world1: object = None
    # MakeNamedMedium's media by name ({"name", "params", "type", "m2w"}),
    # and the names bound to primitives through MediumInterface (volpath
    # tracks those per lane; another medium is the scene's one medium)
    media: dict = field(default_factory=dict)
    prim_media_names: tuple = ()


CAMERA_KINDS = ("perspective", "orthographic", "environment") + LENS_KINDS
FILTER_KINDS = ("box", "triangle", "gaussian", "mitchell", "sinc")


def _unported(what):
    return NotImplementedError(f"{what} is not ported to pbrt_tpu_torch")


def _map_sampler(kind):
    """The JAX package's sampler aliases; an unknown kind renders with
    halton, with a warning."""
    kind = {"random": "independent", "lowdiscrepancy": "zerotwosequence",
            "02sequence": "zerotwosequence"}.get(kind, kind)
    if kind not in SAMPLER_TYPES:
        log.warning("unknown sampler %r; using halton", kind)
        return "halton"
    return kind


def _check_unused(ps: ParamSet, where):
    for name in ps.unused():
        log.warning('parameter "%s" unused in %s', name, where)


class PbrtAPI:
    """State machine; feed directives via parse_file / parse_string.  The
    scene is built at WorldEnd on `device` (None: the first CUDA card)."""

    def __init__(self, device=None):
        self.device = devmod.resolve(device)
        self.scene_dir = "."
        self.ctm = [tfm.Transform(), tfm.Transform()]  # two time samples
        self.active_bits = 3
        self.transform_stack = []
        self.graphics = GraphicsState()
        self.graphics_stack = []
        self.builder = SceneBuilder()
        self.camera_kind = "perspective"
        self.transform_times = (0.0, 1.0)
        self.camera_params = ParamSet()
        self.camera_to_world = tfm.Transform()
        self.camera_to_world1 = None
        self.film_params = ParamSet()
        self.filter_name = "box"
        self.filter_params = ParamSet()
        self.sampler_kind = "halton"
        self.sampler_params = ParamSet()
        self.integrator_kind = "path"
        self.integrator_params = ParamSet()
        self.next_instance_id = 1
        self.instance_names = {}
        self.named_coord_systems = {}
        self.accel_kind = "bvh"
        # ObjectBegin: the name being recorded, and each object's shapes
        self.current_object = None
        self.objects = {}
        self.media = {}
        self._medium_ids = {}          # name -> media-table index or -1
        self._camera_medium_name = ""
        # the default material, id 0, as in the JAX package
        self.graphics.material_id = self.builder.add_material(
            MaterialSpec(type=ir.MAT_MATTE, kd=np.full(31, 0.5, np.float32),
                         name="matte"))

    def _apply(self, t: tfm.Transform):
        for i in range(2):
            if self.active_bits & (1 << i):
                self.ctm[i] = self.ctm[i] * t

    # ------------------------------------------------------------- parsing
    def parse_file(self, path):
        self.scene_dir = os.path.dirname(os.path.abspath(path))
        return self._parse(TokenStream(tokenize_file(path), path))

    def parse_string(self, text, scene_dir="."):
        self.scene_dir = scene_dir
        return self._parse(TokenStream(tokenize(text)))

    def _parse(self, stream):
        job = None
        while True:
            tok = stream.next()
            if tok is None:
                break
            handler = getattr(self, "_d_" + tok, None)
            if handler is None:
                log.warning("unknown directive %r; skipped", tok)
                continue
            result = handler(stream)
            if result is not None:
                job = result
        return job

    # -------------------------------------------------------- transforms
    def _d_Identity(self, s):
        for i in range(2):
            if self.active_bits & (1 << i):
                self.ctm[i] = tfm.Transform()

    def _d_Translate(self, s):
        self._apply(tfm.translate(*(float(s.next()) for _ in range(3))))

    def _d_Scale(self, s):
        self._apply(tfm.scale(*(float(s.next()) for _ in range(3))))

    def _d_Rotate(self, s):
        self._apply(tfm.rotate(*(float(s.next()) for _ in range(4))))

    def _d_LookAt(self, s):
        v = [float(s.next()) for _ in range(9)]
        # LookAt gives world-to-camera = inverse(cam_to_world)
        self._apply(tfm.look_at(v[0:3], v[3:6], v[6:9]).inverse())

    def _read_matrix(self, s):
        if s.next() != "[":
            raise ValueError("Transform expects [ 16 floats ]")
        vals = []
        while True:
            tok = s.next()
            if tok == "]":
                break
            vals.append(float(tok))
        # pbrt matrices are column-major in the file
        return tfm.Transform(np.asarray(vals).reshape(4, 4).T)

    def _d_Transform(self, s):
        t = self._read_matrix(s)
        for i in range(2):
            if self.active_bits & (1 << i):
                self.ctm[i] = t

    def _d_ConcatTransform(self, s):
        self._apply(self._read_matrix(s))

    def _d_CoordinateSystem(self, s):
        name = unquote(s.next())
        self.named_coord_systems[name] = [tfm.Transform(self.ctm[0].m),
                                          tfm.Transform(self.ctm[1].m)]

    def _d_CoordSysTransform(self, s):
        name = unquote(s.next())
        if name in self.named_coord_systems:
            self.ctm = [tfm.Transform(t.m)
                        for t in self.named_coord_systems[name]]
        else:
            log.warning("unknown coordinate system %r", name)

    def _d_ActiveTransform(self, s):
        which = s.next()
        if which not in ("StartTime", "EndTime", "All"):
            raise ValueError(f"ActiveTransform {which!r}")
        self.active_bits = {"StartTime": 1, "EndTime": 2, "All": 3}[which]

    def _d_TransformTimes(self, s):
        self.transform_times = (float(s.next()), float(s.next()))
        if self.transform_times != (0.0, 1.0):
            # recorded and read nowhere, as in the JAX package
            log.warning("TransformTimes %g %g is ignored: motion is "
                        "interpolated over the shutter [0, 1], as in the "
                        "JAX package", *self.transform_times)

    def _d_TransformBegin(self, s):
        self.transform_stack.append(
            ([tfm.Transform(self.ctm[0].m), tfm.Transform(self.ctm[1].m)],
             self.active_bits))

    def _d_TransformEnd(self, s):
        self.ctm, self.active_bits = self.transform_stack.pop()

    # ------------------------------------------------------------ options
    def _d_Camera(self, s):
        self.camera_kind = unquote(s.next())
        if self.camera_kind not in CAMERA_KINDS:
            # the job keeps the name; the CLI's build_camera renders it
            log.warning('Camera "%s" renders as "perspective", as in the '
                        "JAX package", self.camera_kind)
        self.camera_params = parse_param_list(s, self.scene_dir)
        self.camera_to_world = self.ctm[0].inverse()
        self.camera_to_world1 = (None if np.allclose(self.ctm[1].m,
                                                     self.ctm[0].m)
                                 else self.ctm[1].inverse())
        self.named_coord_systems["camera"] = [self.ctm[0], self.ctm[1]]
        # the camera sits in the medium active here (api.cpp
        # RenderOptions::CameraMedium), resolved at WorldEnd, after the
        # MakeNamedMedium it may name
        self._camera_medium_name = self.graphics.inside_medium

    def _d_Film(self, s):
        name = unquote(s.next())
        if name != "image":
            log.warning('Film "%s" is read as Film "image" (its name '
                        "dropped), as in the JAX package", name)
        self.film_params = parse_param_list(s, self.scene_dir)

    def _d_PixelFilter(self, s):
        self.filter_name = unquote(s.next())
        if self.filter_name not in FILTER_KINDS:
            raise _unported(f'PixelFilter "{self.filter_name}"')
        self.filter_params = parse_param_list(s, self.scene_dir)

    def _d_Sampler(self, s):
        self.sampler_kind = unquote(s.next())
        self.sampler_params = parse_param_list(s, self.scene_dir)

    def _d_Integrator(self, s):
        self.integrator_kind = unquote(s.next())
        self.integrator_params = parse_param_list(s, self.scene_dir)

    def _d_Accelerator(self, s):
        # reference api.cpp:788-801 (bvh | kdtree).  A scene under the
        # dense cap takes K1 / K2 whatever it names; above the cap the kind
        # chooses the walk: "kdtree" the SAH kd-tree, any other the BVH
        # (an unknown kind warns, then takes the BVH as in pbrt_tpu)
        self.accel_kind = unquote(s.next())
        if self.accel_kind not in ("bvh", "kdtree"):
            log.warning("accelerator %r is not known: the BVH is used",
                        self.accel_kind)
        _check_unused(parse_param_list(s, self.scene_dir), "accelerator")

    def _d_Include(self, s):
        name = unquote(s.next())
        path = name if os.path.isabs(name) else os.path.join(
            self.scene_dir, name)
        s.include(tokenize_file(path))

    # -------------------------------------------------------- world block
    def _d_WorldBegin(self, s):
        self.ctm = [tfm.Transform(), tfm.Transform()]
        self.active_bits = 3
        self.named_coord_systems["world"] = [tfm.Transform(),
                                             tfm.Transform()]

    def _d_AttributeBegin(self, s):
        self.graphics_stack.append(self.graphics.clone())
        self._d_TransformBegin(s)

    def _d_AttributeEnd(self, s):
        self.graphics = self.graphics_stack.pop()
        self._d_TransformEnd(s)

    def _d_ReverseOrientation(self, s):
        self.graphics.reverse_orientation = \
            not self.graphics.reverse_orientation

    def _d_ObjectBegin(self, s):
        self._d_AttributeBegin(s)
        self.current_object = unquote(s.next())
        self.objects[self.current_object] = []

    def _d_ObjectEnd(self, s):
        self.current_object = None
        self._d_AttributeEnd(s)

    def _d_ObjectInstance(self, s):
        """The object's shapes under the CTM, as world-space primitives
        with one new instance id (the JAX package bakes instances; a
        mesh's ReverseOrientation at its definition is not kept, a
        quadric's is)."""
        name = unquote(s.next())
        shapes = self.objects.get(name)
        if shapes is None:
            log.warning("unknown object instance %r", name)
            return
        inst_id = self.next_instance_id
        self.next_instance_id += 1
        self.instance_names[inst_id] = name
        xf = self.ctm[0]
        for entry in shapes:
            if entry[0] == "mesh":
                _, verts, idx, norms, uvs, mat, light = entry
                self.builder.add_triangle_mesh(
                    verts, idx, mat, normals=norms, uvs=uvs,
                    light_id=light, instance_id=inst_id,
                    object_to_world=xf)
            else:
                _, qtype, o2w, params, mat, light, flip = entry
                self.builder.add_quadric(qtype, xf * o2w, params, mat,
                                         light_id=light, instance_id=inst_id,
                                         flip_normal=flip)

    # -------------------------------------------------------------- media
    def _d_MakeNamedMedium(self, s):
        name = unquote(s.next())
        ps = parse_param_list(s, self.scene_dir)
        # a grid takes the CTM at its creation (api.cpp MakeMedium passes
        # curTransform as medium2world)
        self.media[name] = {"name": name, "params": ps,
                            "type": ps.find_one_string("type",
                                                       "homogeneous"),
                            "m2w": tfm.Transform(self.ctm[0].m)}

    def _d_MediumInterface(self, s):
        # one name sets the inside medium only, as in the JAX package
        self.graphics.inside_medium = unquote(s.next())
        tok = s.peek()
        if tok is not None and tok.startswith('"'):
            self.graphics.outside_medium = unquote(s.next())

    def _medium_index(self, name):
        """A named medium's index in the builder's media table (added at
        its first use; -1 for vacuum and, with a warning, for a name no
        MakeNamedMedium made)."""
        if not name:
            return -1
        if name in self._medium_ids:
            return self._medium_ids[name]
        m = self.media.get(name)
        idx = -1
        if m is None:
            log.warning("MediumInterface names unknown medium %r", name)
        else:
            sig_a, sig_s, g = medium_coefficients(m["params"])
            grid = medium_grid(m)
            if grid is not None:
                # medium2world: the CTM at the medium's creation, then
                # the grid's data to unit-cube box (medium.cpp data2Medium)
                dens, d2m = grid
                m2w = np.asarray(m["m2w"].m, np.float64) @ d2m
                idx = self.builder.add_medium_record(
                    sig_a, sig_s, g, density=dens,
                    world_to_medium=np.linalg.inv(m2w).astype(np.float32))
            else:
                idx = self.builder.add_medium_record(sig_a, sig_s, g)
        self._medium_ids[name] = idx
        return idx

    # ----------------------------------------------------------- textures
    def _d_Texture(self, s):
        name = unquote(s.next())
        ttype = unquote(s.next())       # "float" | "color" / "spectrum"
        tclass = unquote(s.next())      # constant, scale, imagemap, ...
        ps = parse_param_list(s, self.scene_dir)
        value = self._make_texture(ttype, tclass, ps)
        if ttype == "float":
            self.graphics.float_textures[name] = value
        else:
            self.graphics.spectrum_textures[name] = value

    def _make_texture(self, ttype, tclass, ps):
        """Texture factory (reference: src/textures/*, api.cpp:627-697; the
        JAX package's folding).  Returns ("const", value) or ("tex", id),
        id indexing the builder's texture table."""
        reg = self.builder.textures
        half = 0.5 if ttype == "float" else np.full(31, 0.5, np.float32)
        uscale = ps.find_one_float("uscale", 1.0)
        vscale = ps.find_one_float("vscale", 1.0)
        udelta = ps.find_one_float("udelta", 0.0)
        vdelta = ps.find_one_float("vdelta", 0.0)
        wscale = ps.find_one_float("scale", 1.0)
        if tclass == "constant":
            if ttype == "float":
                return ("const", ps.find_one_float("value", 1.0))
            return ("const", ps.find_one_spectrum("value", 1.0,
                                                  "reflectance"))
        if tclass == "scale":
            return ("const", self._resolve_tex_value(ps, "tex1", 1.0, ttype)
                    * self._resolve_tex_value(ps, "tex2", 1.0, ttype))
        if tclass == "mix":
            t1 = self._resolve_tex_value(ps, "tex1", 0.0, ttype)
            t2 = self._resolve_tex_value(ps, "tex2", 1.0, ttype)
            amt = ps.find_one_float("amount", 0.5)
            return ("const", (1 - amt) * t1 + amt * t2)
        if tclass == "bilerp":
            # the mean of the four corners, as the JAX package folds it
            vals = [self._resolve_tex_value(ps, f"v{i}", 0.0, ttype)
                    for i in ("00", "01", "10", "11")]
            return ("const", sum(vals) / 4)
        if tclass == "imagemap":
            fname = self._filename(ps, "filename")
            try:
                return ("tex", reg.add(texmod.TEX_IMAGE, image=fname,
                                       uscale=uscale, vscale=vscale,
                                       udelta=udelta, vdelta=vdelta))
            except NotImplementedError:
                if os.path.exists(fname):
                    raise      # a file in a format the port does not read
                log.warning("imagemap %r load failed (no such file); "
                            "using 0.5", fname)
                return ("const", half)
            except Exception as e:
                log.warning("imagemap %r load failed (%s); using 0.5",
                            fname, e)
                return ("const", half)
        if tclass == "checkerboard":
            c1 = self._resolve_tex_value(ps, "tex1", 1.0, "color")
            c2 = self._resolve_tex_value(ps, "tex2", 0.0, "color")
            return ("tex", reg.add(texmod.TEX_CHECKER, uscale=uscale,
                                   vscale=vscale, udelta=udelta,
                                   vdelta=vdelta, c1=spec.to_rgb_np(c1),
                                   c2=spec.to_rgb_np(c2)))
        if tclass == "uv":
            return ("tex", reg.add(texmod.TEX_UV, uscale=uscale,
                                   vscale=vscale))
        if tclass == "dots":
            c1 = self._resolve_tex_value(ps, "inside", 1.0, "color")
            c2 = self._resolve_tex_value(ps, "outside", 0.0, "color")
            return ("tex", reg.add(texmod.TEX_DOTS, uscale=uscale,
                                   vscale=vscale, c1=spec.to_rgb_np(c1),
                                   c2=spec.to_rgb_np(c2)))
        if tclass in ("fbm", "wrinkled", "marble", "windy"):
            tt = {"fbm": texmod.TEX_FBM, "wrinkled": texmod.TEX_WRINKLED,
                  "marble": texmod.TEX_MARBLE,
                  "windy": texmod.TEX_WINDY}[tclass]
            return ("tex", reg.add(tt, wscale=wscale))
        if tclass == "ptex":
            # per-face textures baked to a tile atlas (textures/ptex.py;
            # reference textures/ptex.cpp reads faceIndex the same way)
            fname = self._filename(ps, "filename")
            try:
                pt = ptexmod.read_ptex(fname)
                atlas, tpr, tile = ptexmod.bake_atlas(pt["faces"])
                if len(pt["faces"]) > tpr * tpr:
                    log.warning("ptex %r: %d faces exceed the %dx%d "
                                "atlas; extra faces clamp to the last "
                                "tile", fname, len(pt["faces"]), tpr, tpr)
                gamma = ps.find_one_float("gamma", 1.0)
                scale = ps.find_one_float("scale", 1.0)
                if gamma != 1.0:
                    atlas = np.power(np.maximum(atlas, 0.0), gamma)
                return ("tex", reg.add(texmod.TEX_PTEX, image=atlas * scale,
                                       p5=float(tpr), p6=float(tile)))
            except Exception as e:
                log.warning("ptex file %r unusable (%s) -> 0.5", fname, e)
                return ("const", half)
        log.warning("texture class %r unsupported; using 0.5", tclass)
        return ("const", half)

    def _resolve_tex_value(self, ps, name, default, ttype):
        """The constant value of a parameter that may name a texture (for
        folding); a non-constant texture folds to 0.5 with a warning."""
        tex = ps.find_texture(name)
        if tex is not None:
            table = (self.graphics.float_textures if ttype == "float"
                     else self.graphics.spectrum_textures)
            entry = table.get(tex)
            if entry is not None and entry[0] == "const":
                return entry[1]
            log.warning("texture %r folded to 0.5 inside %s", tex, name)
            return 0.5 if ttype == "float" else np.full(31, 0.5, np.float32)
        if ttype == "float":
            return ps.find_one_float(name, default)
        return ps.find_one_spectrum(name, default)

    # ---------------------------------------------------------- materials
    def _d_Material(self, s):
        mname = unquote(s.next())
        ps = parse_param_list(s, self.scene_dir)
        self.graphics.material_id = self._make_material(mname, ps)

    def _d_MakeNamedMaterial(self, s):
        name = unquote(s.next())
        ps = parse_param_list(s, self.scene_dir)
        mtype = ps.find_one_string("type", "matte")
        self.graphics.named_materials[name] = self._make_material(
            mtype, ps, name=name)

    def _d_NamedMaterial(self, s):
        name = unquote(s.next())
        mid = self.graphics.named_materials.get(name)
        if mid is None:
            log.warning("unknown named material %r", name)
            return
        self.graphics.material_id = mid

    def _spectrum_or_texture(self, ps, name, default, kind="illuminant"):
        """(spectrum [31], texture id or -1).  rgb parameters convert as
        illuminants, reflectances too (paramset.cpp:116, spectrum.h:429).
        A texture-bound parameter keeps 0.5 as its constant."""
        tex = ps.find_texture(name)
        if tex is not None:
            entry = self.graphics.spectrum_textures.get(tex)
            if entry is None:
                fentry = self.graphics.float_textures.get(tex)
                if fentry is not None:
                    if fentry[0] == "const":
                        return (np.full(31, float(fentry[1]), np.float32),
                                -1)
                    return np.full(31, 0.5, np.float32), fentry[1]
                log.warning("unknown texture %r", tex)
                return np.full(31, 0.5, np.float32), -1
            if entry[0] == "const":
                return np.asarray(entry[1], np.float32), -1
            return np.full(31, 0.5, np.float32), entry[1]
        return ps.find_one_spectrum(name, default, kind), -1

    def _float_or_texture(self, ps, name, default):
        """A float parameter; a non-constant texture gives the default."""
        tex = ps.find_texture(name)
        if tex is not None:
            entry = self.graphics.float_textures.get(tex)
            if entry is not None and entry[0] == "const":
                return float(entry[1])
            return default
        return ps.find_one_float(name, default)

    def _make_material(self, mname, ps, name=""):
        """reference dispatch api.cpp:552-625 + materials/*.cpp defaults;
        the JAX package's _make_material.  Returns the builder's material
        id."""
        m = MaterialSpec(name=name or mname)
        # an extension parameter: the microfacet NDF (microfacet.h:80)
        m.distribution = ps.find_one_string("distribution", "ggx")
        spt, flt = self._spectrum_or_texture, self._float_or_texture
        if mname in ("", "none"):
            m.type = ir.MAT_NONE
        elif mname == "matte":
            m.type = ir.MAT_MATTE
            m.kd, m.kd_tex = spt(ps, "Kd", 0.5)
            m.sigma = flt(ps, "sigma", 0.0)
        elif mname == "plastic":
            m.type = ir.MAT_PLASTIC
            m.kd, m.kd_tex = spt(ps, "Kd", 0.25)
            m.ks, m.ks_tex = spt(ps, "Ks", 0.25)
            m.rough_u = m.rough_v = flt(ps, "roughness", 0.1)
            m.remap_roughness = ps.find_one_bool("remaproughness", True)
        elif mname == "mirror":
            m.type = ir.MAT_MIRROR
            m.kr = spt(ps, "Kr", 0.9)[0]
        elif mname == "glass":
            m.kr = spt(ps, "Kr", 1.0)[0]
            m.kt = spt(ps, "Kt", 1.0)[0]
            m.eta = flt(ps, "eta", flt(ps, "index", 1.5))
            m.rough_u = flt(ps, "uroughness", 0.0)
            m.rough_v = flt(ps, "vroughness", 0.0)
            m.type = (ir.MAT_ROUGHGLASS if m.rough_u > 0 or m.rough_v > 0
                      else ir.MAT_GLASS)
            m.remap_roughness = ps.find_one_bool("remaproughness", True)
        elif mname == "metal":
            m.type = ir.MAT_METAL
            eta_d, k_d = conductor_eta_k("Cu")
            m.eta_spec = ps.find_one_spectrum("eta", eta_d)
            m.k_spec = ps.find_one_spectrum("k", k_d)
            r = flt(ps, "roughness", 0.01)
            m.rough_u = flt(ps, "uroughness", r)
            m.rough_v = flt(ps, "vroughness", r)
            m.ks = np.ones(31, np.float32)
            m.remap_roughness = ps.find_one_bool("remaproughness", True)
        elif mname == "uber":
            m.type = ir.MAT_UBER
            m.kd, m.kd_tex = spt(ps, "Kd", 0.25)
            m.ks, m.ks_tex = spt(ps, "Ks", 0.25)
            m.kr = spt(ps, "Kr", 0.0)[0]
            m.kt = spt(ps, "Kt", 0.0)[0]
            r = flt(ps, "roughness", 0.1)
            m.rough_u = flt(ps, "uroughness", r)
            m.rough_v = flt(ps, "vroughness", r)
            m.eta = flt(ps, "eta", 1.5)
            m.opacity = ps.find_one_spectrum("opacity", 1.0)
            m.remap_roughness = ps.find_one_bool("remaproughness", True)
        elif mname == "substrate":
            m.type = ir.MAT_SUBSTRATE
            m.kd, m.kd_tex = spt(ps, "Kd", 0.5)
            m.ks, m.ks_tex = spt(ps, "Ks", 0.5)
            m.rough_u = flt(ps, "uroughness", 0.1)
            m.rough_v = flt(ps, "vroughness", 0.1)
            m.remap_roughness = ps.find_one_bool("remaproughness", True)
        elif mname == "translucent":
            m.type = ir.MAT_TRANSLUCENT
            m.kd, m.kd_tex = spt(ps, "Kd", 0.25)
            m.ks, m.ks_tex = spt(ps, "Ks", 0.25)
            m.kr = spt(ps, "reflect", 0.5)[0]
            m.kt = spt(ps, "transmit", 0.5)[0]
            m.rough_u = m.rough_v = flt(ps, "roughness", 0.1)
        elif mname == "retroreflective":
            # the fork's material (materials/retroreflective.cpp)
            m.type = ir.MAT_RETRO
            m.kd, m.kd_tex = spt(ps, "Kd", 0.5)
            m.ks, m.ks_tex = spt(ps, "Ks", 0.5)
            m.rough_u = m.rough_v = flt(ps, "roughness", 0.1)
        elif mname == "disney":
            # materials/disney.cpp: roughness and anisotropic folded into
            # the GGX alphas (its aspect remap); the lobe weights ride in
            # mat_disney
            m.type = ir.MAT_DISNEY
            m.kd = spt(ps, "color", 0.5)[0]
            rough = flt(ps, "roughness", 0.5)
            aniso = flt(ps, "anisotropic", 0.0)
            aspect = float(np.sqrt(max(1.0 - 0.9 * aniso, 1e-4)))
            m.rough_u = max(rough * rough / aspect, 1e-3)
            m.rough_v = max(rough * rough * aspect, 1e-3)
            m.remap_roughness = False
            m.eta = flt(ps, "eta", 1.5)
            m.disney = (flt(ps, "metallic", 0.0),
                        flt(ps, "speculartint", 0.0),
                        flt(ps, "sheen", 0.0),
                        flt(ps, "sheentint", 0.5),
                        flt(ps, "clearcoat", 0.0),
                        flt(ps, "clearcoatgloss", 1.0),
                        flt(ps, "spectrans", 0.0),
                        aniso)
            # specTrans transmits sqrt(baseColor) (disney.cpp, thin false)
            m.kt = np.sqrt(np.maximum(np.asarray(m.kd, np.float32), 0.0))
        elif mname == "mix":
            # materials/mixmat.cpp: two named materials blended by amount,
            # as a stochastic choice per lane
            m.type = ir.MAT_MIX
            n1 = ps.find_one_string("namedmaterial1", "").strip('"')
            n2 = ps.find_one_string("namedmaterial2", "").strip('"')
            m.mix_a = self.graphics.named_materials.get(n1, -1)
            m.mix_b = self.graphics.named_materials.get(n2, -1)
            m.mix_amt = float(np.asarray(
                ps.find_one_spectrum("amount", 0.5)).mean())
            if m.mix_a < 0 or m.mix_b < 0:
                log.warning("mix references unknown materials %r/%r -> "
                            "matte", n1, n2)
                m.type = ir.MAT_MATTE
                m.kd = np.full(31, 0.5, np.float32)
        elif mname == "hair":
            self._hair(m, ps)
        elif mname == "fourier":
            # materials/fourier.cpp: a SCATFUN measured BSDF, baked into a
            # (muI, muO, phi) lattice at parse time (materials/fourier.py)
            fname = self._filename(ps, "bsdffile")
            try:
                tab = fouriermod.read_bsdf(fname)
                grid = fouriermod.bake_grid(tab)
                m.type = ir.MAT_FOURIER
                m.eta = tab["eta"]
                m.fourier_id = self.builder.add_fourier_grid(grid)
            except Exception as e:
                log.warning("fourier bsdffile %r unusable (%s) -> matte",
                            fname, e)
                m.type = ir.MAT_MATTE
                m.kd = np.full(31, 0.5, np.float32)
        elif mname in ("subsurface", "kdsubsurface"):
            self._subsurface(m, mname, ps)
        else:
            log.warning("unknown material %r -> matte", mname)
            m.type = ir.MAT_MATTE
        # a bump map binds to any material (reference material.h Bump)
        btex = ps.find_texture("bumpmap")
        if btex is not None:
            entry = self.graphics.float_textures.get(btex)
            if entry is not None and entry[0] == "tex":
                m.bump_tex = entry[1]
        _check_unused(ps, f"material {mname}")
        return self.builder.add_material(m)

    def _hair(self, m, ps):
        """materials/hair.cpp CreateHairMaterial: sigma_a as given, or from
        a color (the inverse of Chiang's fit), or from the melanin
        concentrations; the record's slots hold the hair parameters (kd
        sigma_a, rough_u / rough_v beta_m / beta_n, sigma alpha in
        degrees, eta 1.55 for keratin)."""
        m.type = ir.MAT_HAIR
        bm = ps.find_one_float("beta_m", 0.3)
        bn = ps.find_one_float("beta_n", 0.3)
        sig = np.asarray(ps.find_one_spectrum("sigma_a", -1.0),
                         np.float32).reshape(-1)
        col = np.asarray(ps.find_one_spectrum("color", -1.0),
                         np.float32).reshape(-1)
        if (sig >= 0).all():
            sigma_a = sig
        elif (col >= 0).all():
            c = np.clip(col, 1e-4, 1.0)
            denom = (5.969 - 0.215 * bn + 2.532 * bn ** 2
                     - 10.73 * bn ** 3 + 5.574 * bn ** 4
                     + 0.245 * bn ** 5)
            sigma_a = (np.log(c) / denom) ** 2
        else:
            ce = ps.find_one_float("eumelanin", 1.3)
            cp = ps.find_one_float("pheomelanin", 0.0)
            rgb = (ce * np.array([0.419, 0.697, 1.37])
                   + cp * np.array([0.187, 0.4, 1.05]))
            s_max = max(float(rgb.max()), 1e-6)
            sigma_a = np.asarray(spec.from_rgb_np(rgb / s_max, "reflectance"),
                                 np.float32) * s_max
        m.kd = sigma_a
        m.rough_u, m.rough_v = bm, bn
        m.remap_roughness = False
        m.sigma = ps.find_one_float("alpha", 2.0)
        m.eta = ps.find_one_float("eta", 1.55)

    def _subsurface(self, m, mname, ps):
        """materials/subsurface.cpp:60-88 and kdsubsurface.cpp: the
        beam-diffusion profile table (shared by (g, eta)) and the
        per-channel medium ride the material record; the path integrator
        relocates transmitted lanes with probe rays.  kd keeps the table's
        effective albedo, which integrators without the probe pass
        (whitted, ao) render as the diffusion limit."""
        def mag_spectrum(rgb):
            rgb = np.asarray(rgb, np.float64)
            sc = max(float(rgb.max()), 1e-9)
            return np.asarray(spec.from_rgb_np(rgb / sc, "reflectance"),
                              np.float32) * sc

        g = ps.find_one_float("g", 0.0)
        eta = ps.find_one_float("eta", 1.33)
        scale = ps.find_one_float("scale", 1.0)
        table = bssrdfmod.compute_beam_diffusion_bssrdf(g, eta)
        if mname == "subsurface":
            default_a = mag_spectrum([0.0011, 0.0024, 0.014])
            default_s = mag_spectrum([2.55, 3.21, 3.77])
            pname = ps.find_one_string("name", "")
            if pname:
                got = get_medium_scattering_properties(pname)
                if got is not None:
                    default_a, default_s = got
                    g = 0.0  # the database stores reduced coefficients
            sig_a = ps.find_one_spectrum("sigma_a", default_a) * scale
            sig_s = ps.find_one_spectrum("sigma_s", default_s) * scale
        else:
            kd_t = ps.find_one_spectrum("Kd", 0.5)
            mfp = ps.find_one_spectrum("mfp", 1.0) * scale
            sig_a, sig_s = bssrdfmod.subsurface_from_diffuse(
                table, np.asarray(kd_t, np.float64),
                np.asarray(mfp, np.float64))
        sigp_s = sig_s * (1.0 - g)
        sigp_t = np.maximum(sig_a + sigp_s, 1e-9)
        rho_eff = np.interp(sigp_s / sigp_t, table["rho"], table["rho_eff"])
        m.type = ir.MAT_SUBSURFACE
        m.bssrdf_id = self.builder.add_bssrdf_table(table)
        sigma_t = np.maximum(np.asarray(sig_a + sig_s, np.float64), 0.0)
        m.sss_sigma_t = sigma_t.astype(np.float32)
        m.sss_rho = (np.asarray(sig_s, np.float64)
                     / np.maximum(sigma_t, 1e-12)).astype(np.float32)
        m.kd = np.clip(rho_eff, 0.0, 1.0).astype(np.float32)
        m.ks = (np.asarray(self._spectrum_or_texture(ps, "Kr", 1.0)[0],
                           np.float32) * np.float32(0.05))
        m.eta = eta
        # the reference's default is a smooth FresnelSpecular interface
        # (subsurface.cpp:127-129: uroughness / vroughness default 0)
        m.rough_u = ps.find_one_float("uroughness", 0.0)
        m.rough_v = ps.find_one_float("vroughness", m.rough_u)
        m.remap_roughness = ps.find_one_bool("remaproughness", True)

    # ------------------------------------------------------------- lights
    def _d_LightSource(self, s):
        lname = unquote(s.next())
        ps = parse_param_list(s, self.scene_dir)
        xf = self.ctm[0]
        sc = ps.find_one_spectrum("scale", 1.0)
        b = self.builder

        def from_to():
            return (xf.apply_point(ps.find_one_point("from", [0, 0, 0])),
                    xf.apply_point(ps.find_one_point("to", [0, 0, 1])))

        if lname == "point":
            I = ps.find_one_spectrum("I", 1.0) * sc
            b.add_point_light(xf.apply_point(ps.find_one_point("from",
                                                               [0, 0, 0])), I)
        elif lname == "spot":
            I = ps.find_one_spectrum("I", 1.0) * sc
            frm, to = from_to()
            cone = ps.find_one_float("coneangle", 30.0)
            delta = ps.find_one_float("conedeltaangle", 5.0)
            b.add_spot_light(frm, np.asarray(to) - np.asarray(frm), I,
                             float(np.cos(np.radians(cone))),
                             float(np.cos(np.radians(cone - delta))))
        elif lname == "distant":
            L = ps.find_one_spectrum("L", 1.0) * sc
            frm, to = from_to()
            b.add_distant_light(np.asarray(to) - np.asarray(frm), L)
        elif lname in ("infinite", "exinfinite"):
            L = ps.find_one_spectrum("L", 1.0) * sc
            mapname = self._filename(ps, "mapname")
            env = _load_env_map(mapname, L) if mapname else None
            b.add_infinite_light(L, env_map=env, light_to_world=xf)
        elif lname in ("goniometric", "projection"):
            I = ps.find_one_spectrum("I", 1.0) * sc
            p = xf.apply_point(np.zeros(3))
            d = xf.apply_normal(np.asarray([0.0, 0.0, 1.0]))
            d = d / max(np.linalg.norm(d), 1e-12)
            mapname = self._filename(ps, "mapname")
            tex_id = 0
            if mapname:
                try:
                    tex_id = b.textures.add(texmod.TEX_IMAGE, image=mapname)
                except NotImplementedError:
                    if os.path.exists(mapname):
                        raise  # a file in a format the port does not read
                    log.warning("light map %r failed (no such file)",
                                mapname)
                except Exception as e:
                    log.warning("light map %r failed (%s)", mapname, e)
            fov = ps.find_one_float("fov", 45.0)
            b.add_light(type=(ir.LIGHT_GONIO if lname == "goniometric"
                              else ir.LIGHT_PROJECTION),
                        pos=np.asarray(p, np.float32),
                        dir=d.astype(np.float32), L=np.asarray(I, np.float32),
                        params=np.array([0, 0, tex_id,
                                         np.cos(np.radians(fov) / 2)],
                                        np.float32))
        else:
            log.warning("unknown light %r; skipped", lname)
        _check_unused(ps, f"light {lname}")

    def _d_AreaLightSource(self, s):
        lname = unquote(s.next())
        if lname not in ("diffuse", "area"):
            log.warning('AreaLightSource "%s" is a diffuse area light, as '
                        "in the JAX package", lname)
        ps = parse_param_list(s, self.scene_dir)
        L = ps.find_one_spectrum("L", 1.0) * ps.find_one_spectrum("scale",
                                                                  1.0)
        self.graphics.area_light = {
            "L": L, "twosided": ps.find_one_bool("twosided", False)}
        _check_unused(ps, f"area light {lname}")

    # ------------------------------------------------------------- shapes
    def _d_Shape(self, s):
        sname = unquote(s.next())
        ps = parse_param_list(s, self.scene_dir)
        xf = self.ctm[0]
        # a second CTM keyframe that differs gives the shape motion blur
        xf1 = None if np.allclose(self.ctm[1].m, xf.m) else self.ctm[1]
        g = self.graphics
        light_id = -1
        if g.area_light is not None:
            light_id = self.builder.add_area_light(g.area_light["L"],
                                                   g.area_light["twosided"])
        mat = g.material_id
        flip = g.reverse_orientation
        inst = self.next_instance_id
        self.next_instance_id += 1
        self.instance_names[inst] = f"{sname}_{inst}"
        # MediumInterface (api.cpp pbrtMediumInterface): the active
        # inside / outside media, as table indices
        self.builder.current_medium = (self._medium_index(g.inside_medium),
                                       self._medium_index(g.outside_medium))

        def mesh(verts, idx, norms=None, uvs=None):
            """Inside ObjectBegin: recorded under the CTM for its
            instances; else added, with motion blur."""
            if self.current_object is not None:
                if xf1 is not None:
                    log.warning(
                        "mesh motion blur inside ObjectBegin/%s is not "
                        "propagated through instances; second keyframe "
                        "ignored", self.current_object)
                wn = (None if norms is None else
                      xf.apply_normal(np.asarray(norms, np.float64)))
                self.objects[self.current_object].append(
                    ("mesh", xf.apply_point(np.asarray(verts, np.float64)),
                     idx, wn, uvs, mat, light_id))
            else:
                self.builder.add_triangle_mesh(
                    verts, idx, mat, normals=norms, uvs=uvs,
                    light_id=light_id, instance_id=inst, flip_normal=flip,
                    object_to_world=xf, object_to_world1=xf1)

        def quadric(qtype, params):
            if self.current_object is not None:
                self.objects[self.current_object].append(
                    ("quadric", qtype, xf, params, mat, light_id, flip))
            else:
                self.builder.add_quadric(qtype, xf, params, mat,
                                         light_id=light_id, instance_id=inst,
                                         flip_normal=flip,
                                         object_to_world1=xf1)

        def phimax():
            return np.radians(ps.find_one_float("phimax", 360.0))

        if sname == "trianglemesh":
            verts = ps.find_points("P")
            idx = ps.find_ints("indices")
            if verts is None or idx is None:
                raise ValueError('Shape "trianglemesh" needs "point P" and '
                                 '"integer indices"')
            uvs = ps.find_point2s("uv")
            if uvs is None:
                uvs = ps.find_point2s("st")
            mesh(verts, idx.reshape(-1, 3), ps.find_points("N"), uvs)
        elif sname == "plymesh":
            mesh(*read_ply(self._filename(ps, "filename")))
        elif sname == "sphere":
            r = ps.find_one_float("radius", 1.0)
            quadric(ir.PRIM_SPHERE, (r, ps.find_one_float("zmin", -r),
                                     ps.find_one_float("zmax", r), phimax()))
        elif sname == "cylinder":
            quadric(ir.PRIM_CYLINDER, (ps.find_one_float("radius", 1.0),
                                       ps.find_one_float("zmin", -1.0),
                                       ps.find_one_float("zmax", 1.0),
                                       phimax()))
        elif sname == "disk":
            h = ps.find_one_float("height", 0.0)
            quadric(ir.PRIM_DISK, (ps.find_one_float("radius", 1.0), h,
                                   ps.find_one_float("innerradius", 0.0),
                                   phimax()))
        elif sname == "cone":
            r = ps.find_one_float("radius", 1.0)
            quadric(ir.PRIM_CONE, (r, 0.0, ps.find_one_float("height", 1.0),
                                   phimax()))
        elif sname == "paraboloid":
            quadric(ir.PRIM_PARABOLOID, (ps.find_one_float("radius", 1.0),
                                         ps.find_one_float("zmin", 0.0),
                                         ps.find_one_float("zmax", 1.0),
                                         phimax()))
        elif sname == "hyperboloid":
            # the segment p1 -> p2 swept phimax about z (hyperboloid.cpp),
            # tessellated as the JAX package does
            p1, p2 = ps.find_points("p1"), ps.find_points("p2")
            mesh(*tessellate_hyperboloid(
                np.zeros(3) if p1 is None else p1[0],
                np.ones(3) if p2 is None else p2[0], phimax()))
        elif sname == "loopsubdiv":
            levels = ps.find_one_int("levels", ps.find_one_int("nlevels", 3))
            verts, idx, norms = loop_subdivide(
                ps.find_points("P"), ps.find_ints("indices").reshape(-1, 3),
                levels)
            mesh(verts, idx, norms=norms)
        elif sname == "heightfield":
            nu = ps.find_one_int("nu", 2)
            nv = ps.find_one_int("nv", 2)
            z = ps.find_floats("Pz").reshape(nv, nu)
            xs, ys = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
            # two triangles a cell, rows of cells in order, as the JAX
            # package's loop emits them
            a = (np.arange(nv - 1)[:, None] * nu
                 + np.arange(nu - 1)[None, :]).reshape(-1, 1)
            idx = np.concatenate([a, a + 1, a + nu + 1, a, a + nu + 1,
                                  a + nu], 1).reshape(-1, 3)
            mesh(np.stack([xs, ys, z], -1).reshape(-1, 3), idx)
        elif sname == "curve":
            w = ps.find_one_float("width", 1.0)
            n0 = ps.find_points("N")
            verts, idx, uvs = curve_from_params(
                ps.find_points("P"), degree=ps.find_one_int("degree", 3),
                basis=ps.find_one_string("basis", "bezier"),
                width0=ps.find_one_float("width0", w),
                width1=ps.find_one_float("width1", w),
                curve_type=ps.find_one_string("type", "flat"),
                normal0=None if n0 is None else n0[0])
            mesh(verts, idx, None, uvs)
        elif sname == "nurbs":
            self._nurbs(ps, mesh)
        else:
            log.warning("unknown shape %r; skipped", sname)
        _check_unused(ps, f"shape {sname}")

    @staticmethod
    def _nurbs(ps, mesh):
        """nurbs.cpp tessellates at creation; so does the JAX package."""
        nu, nv = ps.find_one_int("nu", 0), ps.find_one_int("nv", 0)
        uk, vk = ps.find_floats("uknots"), ps.find_floats("vknots")
        Pw, P = ps.find_floats("Pw"), ps.find_points("P")
        if nu <= 0 or nv <= 0 or uk is None or vk is None or \
                (P is None and Pw is None):
            log.warning("nurbs missing required params; skipped")
            return
        uo, vo = ps.find_one_int("uorder", 3), ps.find_one_int("vorder", 3)
        verts, idx, uvs = tessellate_nurbs(
            nu, nv, uo, vo, uk, vk,
            ps.find_one_float("u0", float(uk[uo - 1])),
            ps.find_one_float("u1", float(uk[nu])),
            ps.find_one_float("v0", float(vk[vo - 1])),
            ps.find_one_float("v1", float(vk[nv])), P=P, Pw=Pw)
        mesh(verts, idx, None, uvs)

    # ------------------------------------------------------------ finish
    def _filename(self, ps, name):
        """A file parameter, relative to the scene file's directory."""
        f = ps.find_one_string(name, "")
        return os.path.join(self.scene_dir, f) if f and not \
            os.path.isabs(f) else f

    def _d_WorldEnd(self, s):
        fp = self.film_params
        crop = fp.find_floats("cropwindow")
        # every filter parameter the scene gives; each filter reads its own
        filt_params = {k: self.filter_params.find_one_float(k, None)
                       for k in ("alpha", "B", "C", "tau")
                       if k in self.filter_params.items}
        xw = self.filter_params.find_one_float("xwidth", -1.0)
        yw = self.filter_params.find_one_float("ywidth", -1.0)
        if xw > 0 or yw > 0:
            filt_params["radius"] = (xw if xw > 0 else 2.0,
                                     yw if yw > 0 else 2.0)
        ip = self.integrator_params
        cp = self.camera_params
        sw = cp.find_floats("screenwindow")
        self.builder.camera_medium = self._medium_index(
            self._camera_medium_name)
        return RenderJob(
            scene=self.builder.build(device=self.device,
                                     accel=self.accel_kind),
            camera_kind=self.camera_kind,
            camera_params={
                "fov": cp.find_one_float("fov", 90.0),
                "lensradius": cp.find_one_float("lensradius", 0.0),
                "focaldistance": cp.find_one_float("focaldistance", 1e6),
                "shutteropen": cp.find_one_float("shutteropen", 0.0),
                "shutterclose": cp.find_one_float("shutterclose", 1.0),
                "screenwindow": None if sw is None else tuple(sw),
                # the lens cameras' keys, exactly the JAX parser's
                "lensfile": self._filename(cp, "lensfile"),
                "aperturediameter": cp.find_one_float("aperturediameter",
                                                      1.0),
                "filmdistance": cp.find_one_float("filmdistance", 70.0),
                "filmdiag": cp.find_one_float("filmdiag", 35.0)},
            cam_to_world=self.camera_to_world,
            cam_to_world1=self.camera_to_world1,
            film_width=fp.find_one_int("xresolution", 1280),
            film_height=fp.find_one_int("yresolution", 720),
            film_filename=fp.find_one_string("filename", "pbrt.exr"),
            film_diagonal=fp.find_one_float("diagonal", 35.0),
            film_scale=fp.find_one_float("scale", 1.0),
            spectral_flag=fp.find_one_bool("spectralFlag", True),
            max_sample_luminance=fp.find_one_float("maxsampleluminance",
                                                   1e30),
            crop_window=(0.0, 1.0, 0.0, 1.0) if crop is None else tuple(crop),
            filter_name=self.filter_name, filter_params=filt_params,
            sampler_kind=_map_sampler(self.sampler_kind),
            spp=self.sampler_params.find_one_int("pixelsamples", 16),
            integrator_kind=self.integrator_kind,
            integrator_params={
                "maxdepth": ip.find_one_int("maxdepth", 5),
                "rrthreshold": ip.find_one_float("rrthreshold", 1.0),
                "lightsamplestrategy": ip.find_one_string(
                    "lightsamplestrategy", "spatial"),
                "numCABands": ip.find_one_int("numCABands", 4),
                "strategy": ip.find_one_string("strategy", "depth"),
                "cossample": ip.find_one_bool("cossample", True),
                "radius": ip.find_one_float("radius", 0.0) or None,
                "chains": ip.find_one_int("chains", 4096),
                "bootstrapsamples": ip.find_one_int("bootstrapsamples",
                                                    65536),
                "sigma": ip.find_one_float("sigma", 0.01),
                "largestepprobability": ip.find_one_float(
                    "largestepprobability", 0.3),
                "mutationsperpixel": ip.find_one_int("mutationsperpixel",
                                                     100),
                "iterations": ip.find_one_int(
                    "iterations", ip.find_one_int("numiterations", 64))},
            instance_names=self.instance_names,
            material_names=self.builder.material_names,
            media=self.media,
            prim_media_names=tuple(n for n, i in self._medium_ids.items()
                                   if i >= 0))


def _load_env_map(path, scale):
    """An env map image as [H,W,31] illuminant spectra times scale [31]."""
    from pbrt_tpu_torch.film.io import read_image
    return (spec.from_rgb_np(read_image(path), "illuminant")
            * scale[None, None, :])


def parse_scene(path, device=None):
    """Parse a .pbrt file into a RenderJob whose scene lies on `device`
    (None: the first CUDA card) (reference: pbrtParseFile, api.h:91)."""
    job = PbrtAPI(device).parse_file(path)
    if job is None:
        raise ValueError(f"{path}: no WorldEnd, nothing to render")
    return job
