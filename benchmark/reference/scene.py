"""A plain reader of the frozen benchmark scenes (pbrt-v3's scene format,
the directives those scenes use), independent of the program's parser.

It gives the camera, the materials, the diffuse area light, every
triangle in world space, the spheres, and the heterogeneous media with
the shapes' medium interfaces.  A directive or shape it does not know
raises, so a scene that needs more fails loudly instead of rendering
something else.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from benchmark.reference import spectrum

MATTE, PLASTIC, MIRROR, GLASS = 0, 1, 2, 3
_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


@dataclasses.dataclass
class Material:
    kind: int
    kd: np.ndarray = None          # [31]
    ks: np.ndarray = None
    kr: np.ndarray = None
    kt: np.ndarray = None
    alpha: float = 0.0             # microfacet alpha (plastic)
    eta: float = 1.5


@dataclasses.dataclass
class Medium:
    sigma_a: np.ndarray            # [31]
    sigma_s: np.ndarray
    g: float
    density: np.ndarray            # [nz, ny, nx]
    world_to_medium: np.ndarray    # [4, 4]: world -> the grid's [0,1]^3


@dataclasses.dataclass
class Scene:
    cam_to_world: np.ndarray
    fov: float
    max_depth: int
    spp: int
    tri_v: np.ndarray              # [T, 3, 3] world-space vertices
    tri_material: np.ndarray       # [T] material index
    tri_light: np.ndarray          # [T] bool: part of the area light
    tri_flip: np.ndarray           # [T] bool: normal reversed
    tri_medium: np.ndarray         # [T, 2] (inside, outside), -1 vacuum
    shape_sizes: list              # triangles of each Shape, in order
    spheres: list                  # dicts: o2w, radius, material, flip,
    #                                medium (inside, outside)
    materials: list
    light_L: np.ndarray            # [31]
    light_two_sided: bool
    media: list
    camera_medium: int = -1


def _tokens(text):
    text = re.sub(r"#[^\n]*", "", text)
    return _TOKEN.findall(text)


def _params(toks, i):
    """Parse "type name" value pairs from toks[i:]; returns (dict, i)."""
    out = {}
    while i < len(toks) and toks[i].startswith('"'):
        ptype, name = toks[i].strip('"').split()
        i += 1
        if toks[i] == "[":
            j = toks.index("]", i)
            vals = toks[i + 1:j]
            i = j + 1
        else:
            vals = [toks[i]]
            i += 1
        if ptype in ("string", "texture", "bool"):
            vals = [v.strip('"') for v in vals]
        elif ptype == "integer":
            vals = [int(v) for v in vals]
        else:
            vals = [float(v) for v in vals]
        out[name] = (ptype, vals)
    return out, i


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _look_at(eye, look, up):
    """Camera-to-world of pbrt-v3's LookAt."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = (look - eye) / np.linalg.norm(look - eye)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(d, right), d, eye
    return m


def _spec(params, name, default):
    if name not in params:
        return np.full(spectrum.N_BINS, float(default))
    ptype, vals = params[name]
    if ptype not in ("rgb", "color"):
        raise NotImplementedError(f"{ptype} {name}")
    return spectrum.from_rgb(vals[:3])


def _one(params, name, default):
    return params[name][1][0] if name in params else default


def parse(path):
    """The Scene of a frozen .pbrt file."""
    with open(path) as f:
        toks = _tokens(f.read())
    ctm = np.eye(4)
    stack = []
    gs = dict(material=None, light=None, medium=("", ""), flip=False)
    materials = [Material(MATTE, kd=np.full(31, 0.5))]
    gs["material"] = 0
    cam_to_world = fov = None
    max_depth, spp, cam_medium = 5, 16, ""
    tris, tri_mat, tri_light, tri_flip, tri_med = [], [], [], [], []
    spheres, media, media_index = [], [], {}
    light = None
    i = 0
    while i < len(toks):
        d = toks[i]
        i += 1
        if d == "LookAt":
            v = [float(x) for x in toks[i:i + 9]]
            i += 9
            ctm = ctm @ np.linalg.inv(_look_at(v[0:3], v[3:6], v[6:9]))
        elif d == "Translate":
            ctm = ctm @ _translate(*(float(x) for x in toks[i:i + 3]))
            i += 3
        elif d == "Scale":
            ctm = ctm @ np.diag([float(x) for x in toks[i:i + 3]] + [1.0])
            i += 3
        elif d in ("Camera", "Film", "Sampler", "Integrator", "Material",
                   "AreaLightSource", "Shape", "MakeNamedMedium"):
            name = toks[i].strip('"')
            p, i = _params(toks, i + 1)
            if d == "Camera":
                if name != "perspective":
                    raise NotImplementedError(f"Camera {name}")
                cam_to_world = np.linalg.inv(ctm)
                fov = float(_one(p, "fov", 90.0))
                cam_medium = gs["medium"][0]
            elif d == "Sampler":
                spp = int(_one(p, "pixelsamples", 16))
            elif d == "Integrator":
                max_depth = int(_one(p, "maxdepth", 5))
            elif d == "Material":
                materials.append(_material(name, p))
                gs["material"] = len(materials) - 1
            elif d == "AreaLightSource":
                gs["light"] = (_spec(p, "L", 1.0) * _spec(p, "scale", 1.0),
                               _one(p, "twosided", "false") == "true")
            elif d == "MakeNamedMedium":
                media_index[name] = len(media)
                media.append(_medium(p, ctm))
            elif d == "Shape":
                med = tuple(media_index[m] if m else -1
                            for m in gs["medium"])
                flip = bool(gs["flip"] ^ (np.linalg.det(ctm[:3, :3]) < 0))
                if gs["light"] is not None:
                    if light is not None and light is not gs["light"]:
                        raise NotImplementedError("more than one area light")
                    light = gs["light"]
                if name == "trianglemesh":
                    P = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                    idx = np.asarray(p["indices"][1], np.int64).reshape(-1, 3)
                    Pw = P @ ctm[:3, :3].T + ctm[:3, 3]
                    tris.append(Pw[idx])
                    n = len(idx)
                    tri_mat += [gs["material"]] * n
                    tri_light += [gs["light"] is not None] * n
                    tri_flip += [flip] * n
                    tri_med += [med] * n
                elif name == "sphere":
                    if gs["light"] is not None:
                        raise NotImplementedError("a sphere area light")
                    spheres.append(dict(
                        o2w=ctm.copy(), radius=float(_one(p, "radius", 1.0)),
                        material=gs["material"], flip=flip, medium=med))
                else:
                    raise NotImplementedError(f"Shape {name}")
        elif d == "MediumInterface":
            # one name sets the inside medium only
            inside = toks[i].strip('"')
            i += 1
            outside = gs["medium"][1]
            if i < len(toks) and toks[i].startswith('"'):
                outside = toks[i].strip('"')
                i += 1
            gs["medium"] = (inside, outside)
        elif d == "ReverseOrientation":
            gs["flip"] = not gs["flip"]
        elif d == "WorldBegin":
            ctm = np.eye(4)
        elif d == "AttributeBegin":
            stack.append((ctm.copy(), dict(gs)))
        elif d == "AttributeEnd":
            ctm, gs = stack.pop()
        elif d == "WorldEnd":
            break
        else:
            raise NotImplementedError(f"directive {d}")
    if light is None:
        raise NotImplementedError("a scene without an area light")
    return Scene(
        cam_to_world=cam_to_world, fov=fov, max_depth=max_depth, spp=spp,
        tri_v=np.concatenate(tris), tri_material=np.asarray(tri_mat),
        tri_light=np.asarray(tri_light), tri_flip=np.asarray(tri_flip),
        shape_sizes=[len(t) for t in tris],
        tri_medium=np.asarray(tri_med, np.int64).reshape(-1, 2),
        spheres=spheres, materials=materials, light_L=light[0],
        light_two_sided=light[1], media=media,
        camera_medium=media_index[cam_medium] if cam_medium else -1)


def _material(name, p):
    if name == "matte":
        return Material(MATTE, kd=_spec(p, "Kd", 0.5))
    if name == "plastic":
        rough = float(_one(p, "roughness", 0.1))
        if _one(p, "remaproughness", "true") != "false":
            x = np.log(max(rough, 1e-3))
            rough = (1.62142 + 0.819955 * x + 0.1734 * x * x
                     + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)
        return Material(PLASTIC, kd=_spec(p, "Kd", 0.25),
                        ks=_spec(p, "Ks", 0.25), alpha=max(rough, 1e-3))
    if name == "mirror":
        return Material(MIRROR, kr=_spec(p, "Kr", 0.9))
    if name == "glass":
        if float(_one(p, "uroughness", 0.0)) or float(_one(p, "vroughness",
                                                             0.0)):
            raise NotImplementedError("rough glass")
        return Material(GLASS, kr=_spec(p, "Kr", 1.0), kt=_spec(p, "Kt", 1.0),
                        eta=float(_one(p, "eta", _one(p, "index", 1.5))))
    raise NotImplementedError(f"Material {name}")


def _medium(p, ctm):
    kind = _one(p, "type", "")
    if kind != "heterogeneous":
        raise NotImplementedError(f"medium {kind}")
    nx, ny, nz = (int(_one(p, k, 1)) for k in ("nx", "ny", "nz"))
    p0 = np.asarray(p["p0"][1] if "p0" in p else [0, 0, 0], np.float64)
    p1 = np.asarray(p["p1"][1] if "p1" in p else [1, 1, 1], np.float64)
    # world -> medium space -> the grid's unit cube
    to_unit = np.diag(list(1.0 / (p1 - p0)) + [1.0]) @ _translate(*(-p0))
    return Medium(
        sigma_a=_spec(p, "sigma_a", 1.0) * float(_one(p, "scale", 1.0)),
        sigma_s=_spec(p, "sigma_s", 1.0) * float(_one(p, "scale", 1.0)),
        g=float(_one(p, "g", 0.0)),
        density=np.asarray(p["density"][1], np.float64).reshape(nz, ny, nx),
        world_to_medium=to_unit @ np.linalg.inv(ctm))
