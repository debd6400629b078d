"""Lens-system cameras: realistic, omni, realisticEye (port of
pbrt_tpu.cameras.lens; reference: src/cameras/realistic.cpp, omni.cpp and
realisticEye.cpp).

The element stack is a fixed-length loop over surfaces, unrolled in
Python: each step intersects the batch of rays with one rotationally
symmetric (bi)conic surface, culls by its aperture and refracts with a
per-ray, wavelength-dependent IoR.  Spheres solve the quadratic in
closed form; biconic and aspheric surfaces take 10 Newton steps with
forward differences, the JAX package's solver step for step.  Surface
kinds, the chromatic-aberration flag, diffraction and the microlens
layout are Python values on the camera, so the loops unroll on the host
and no branch waits on the card.

Conventions follow the reference: camera space looks down +z, the film
at z = 0 on the -z side of the rear element; surfaces are listed
front-to-back in lens files and traced film->scene (rear->front).

f32 arithmetic follows the JAX package's expressions term for term
(integer powers as its repeated products), so on the CPU the two agree
to the last bit or nearly; on the card a division by a Python scalar
becomes a product with its reciprocal, and a ray that grazes an aperture
edge may go either way.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import rng as prng
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import transform as tfm

MAX_IOR_SPECTRA = 8
N_PUPIL_ZONES = 32
EYE_KINDS = ("realisticEye", "humaneye")

#: per-surface and scalar tensors of every lens camera
TENSOR_FIELDS = (
    "cam_to_world", "curv_x", "curv_y", "conic_x", "conic_y", "z_pos",
    "aperture", "is_stop", "eta_const", "eta_idx", "asph", "ior_spectra",
    "pupil_bounds", "pupil_valid", "film_distance", "film_diag",
    "retina_radius", "retina_semi_diam", "shutter_open", "shutter_close",
    "weight_scale")
#: the microlens array's tensors (None without an array)
ML_FIELDS = ("ml_curv_x", "ml_curv_y", "ml_conic_x", "ml_conic_y", "ml_z",
             "ml_aperture", "ml_eta", "ml_asph", "ml_offsets",
             "ml_offset_sensor")
#: the JAX camera's static (pytree_node=False) fields
STATIC_FIELDS = ("n_surfaces", "surface_kinds", "ca_enabled",
                 "simple_weighting", "diffraction", "kind", "ml_n_surfaces",
                 "ml_surface_kinds", "ml_dims", "ml_sim_radius",
                 "ml_has_offsets")


@dataclass
class LensCamera:
    """A lens camera: tensors on one device and host-side statics."""
    cam_to_world: torch.Tensor      # [4,4]
    # per-surface arrays, ordered REAR (nearest film) -> FRONT
    curv_x: torch.Tensor            # [S] 1/radiusX (0 => flat / aperture)
    curv_y: torch.Tensor            # [S]
    conic_x: torch.Tensor           # [S]
    conic_y: torch.Tensor           # [S]
    z_pos: torch.Tensor             # [S] vertex z (film at z = 0)
    aperture: torch.Tensor          # [S] semi-aperture radius
    is_stop: torch.Tensor           # [S] bool: aperture stop surface
    eta_const: torch.Tensor         # [S] medium IoR on the FILM side
    eta_idx: torch.Tensor           # [S] int32 row of ior_spectra (-1: const)
    asph: torch.Tensor              # [S,4] aspheric coefficients r^4..r^10
    ior_spectra: torch.Tensor       # [MAX_IOR_SPECTRA, 31]
    # exit pupil: per radial zone (x0, y0, x1, y1) on the rear plane for a
    # film point on the +x axis, rotated to the film azimuth at ray gen
    pupil_bounds: torch.Tensor      # [NZ,4]
    pupil_valid: torch.Tensor       # [NZ] bool
    # film / retina geometry and shutter: 0-d f32 tensors
    film_distance: torch.Tensor
    film_diag: torch.Tensor
    retina_radius: torch.Tensor     # 0 => flat film
    retina_semi_diam: torch.Tensor
    shutter_open: torch.Tensor
    shutter_close: torch.Tensor
    weight_scale: torch.Tensor      # A_rear / z^2 importance factor
    # microlens array (omni.cpp:963-1140), stored rear-first with z from
    # the film plane; ml_n_surfaces == 0: no array
    ml_curv_x: torch.Tensor = None      # [MS]
    ml_curv_y: torch.Tensor = None
    ml_conic_x: torch.Tensor = None
    ml_conic_y: torch.Tensor = None
    ml_z: torch.Tensor = None           # [MS] vertex z
    ml_aperture: torch.Tensor = None    # [MS] circular semi-aperture
    ml_eta: torch.Tensor = None         # [MS] film-side IoR
    ml_asph: torch.Tensor = None        # [MS,4]
    ml_offsets: torch.Tensor = None     # [ny*nx,2] per-lens centre jitter
    ml_offset_sensor: torch.Tensor = None   # 0-d: the microlens plane's z
    # statics: they pick the unrolled branches on the host
    n_surfaces: int = 0
    surface_kinds: tuple = ()           # "flat" | "sphere" | "biconic"
    ca_enabled: bool = False
    simple_weighting: bool = True
    diffraction: bool = False
    kind: str = "realistic"
    ml_n_surfaces: int = 0
    ml_surface_kinds: tuple = ()
    ml_dims: tuple = (0, 0)
    ml_sim_radius: int = 0
    ml_has_offsets: bool = False        # all-zero offsets: exact cells
    # host copies of eta_idx and is_stop, so that a surface with a
    # constant IoR, or that is not the stop, takes no device work for
    # them (the JAX package computes both sides of the `where`)
    eta_idx_host: tuple = ()
    is_stop_host: tuple = ()

    @property
    def device(self):
        return self.cam_to_world.device

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


# ---------------------------------------------------------------------------
# lens file IO (host, numpy; copies of the JAX package's readers)
# ---------------------------------------------------------------------------

def _read_numbers(path):
    vals = []
    with open(path) as f:
        for line in f:
            vals += [float(x) for x in line.split("#")[0].split()]
    return vals


def read_dat_lens(path, aperture_diameter=1.0):
    """pbrt .dat lens format: rows of [curvature_radius thickness eta
    aperture_diameter] in mm (realistic.cpp:946-980).  Returns surfaces
    front-to-back in meters (x0.001, as the reference)."""
    vals = _read_numbers(path)
    if len(vals) % 4 == 1:
        vals = vals[1:]   # a leading focal length (the fork tolerates it)
    surfs = []
    for i in range(0, len(vals), 4):
        r, thick, eta, ap = vals[i:i + 4]
        ap = ap if r != 0 else (aperture_diameter if aperture_diameter > 0
                                else ap)
        surfs.append(dict(radius_x=r * 1e-3, radius_y=r * 1e-3,
                          thickness=thick * 1e-3, eta=eta,
                          semi_aperture=ap * 1e-3 / 2,
                          conic_x=0.0, conic_y=0.0, asph=[0, 0, 0, 0],
                          eta_spectrum=None))
    return surfs


def _vec2(v, default=0.0):
    if v is None:
        return (default, default)
    if isinstance(v, (int, float)):
        return (float(v), float(v))
    return (float(v[0]), float(v[1]))


def _json_surface(s, spectral_ior):
    """One JSON lens surface (mm) as a surface dict (m).  The
    dimensionless conic constant is scaled by 1e-3 as the JAX package
    scales it (read_json_lens, _attach_microlens)."""
    rx, ry = _vec2(s.get("radius"))
    ax, _ = _vec2(s.get("semi_aperture"))
    cx, cy = _vec2(s.get("conic_constant"))
    ior = s.get("ior", 1.0)
    out = {}
    if spectral_ior:
        out["eta_spectrum"] = None
        if isinstance(ior, list):
            out["eta_spectrum"] = spec.from_sampled(ior[0], ior[1])
            ior = float(np.mean(ior[1]))
    asph = s.get("aspheric_coefficients") or [0, 0, 0, 0]
    asph = (list(asph) + [0, 0, 0, 0])[:4]
    return dict(radius_x=rx * 1e-3, radius_y=ry * 1e-3,
                thickness=float(s.get("thickness", 0)) * 1e-3,
                eta=float(ior), semi_aperture=ax * 1e-3,
                conic_x=cx * 1e-3, conic_y=cy * 1e-3,
                asph=[float(a) for a in asph], **out)


def read_json_lens(path, aperture_diameter=1.0):
    """omni JSON lens (omni.cpp:1220-1360), mm -> x0.001.  Returns
    (surfaces front-to-back, the microlens block or None)."""
    with open(path) as f:
        j = json.load(f)
    surfs = [_json_surface(s, True) for s in j.get("surfaces", [])]
    return surfs, j.get("microlens")


def read_eye_spec(path, scaling=1.0):
    """realisticEye spec: focal length + rows of [radiusX radiusY thickness
    mediumIndex semiDiameter conicX conicY] (realisticEye.cpp:206-240),
    Zemax sign convention (positive radius centre toward the scene),
    flipped here to pbrt's."""
    vals = _read_numbers(path)
    focal = vals[0] * scaling
    surfs = []
    for i in range(1, len(vals), 7):
        rx, ry, thick, med, semi, cx, cy = vals[i:i + 7]
        surfs.append(dict(radius_x=-rx * scaling, radius_y=-ry * scaling,
                          thickness=thick * scaling, eta=1.0,
                          semi_aperture=semi * scaling,
                          conic_x=cx, conic_y=cy, asph=[0, 0, 0, 0],
                          eta_spectrum=None, medium_index=int(med)))
    return focal, surfs


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _paraxial_focus(surfs, focus_distance):
    """Thick-lens film distance by a paraxial ABCD sweep (float64 host),
    in place of the reference's FocusThickLens (realistic.cpp:366+): a
    paraxial ray from an object at -focus_distance goes through the
    system front->back; the film sits where it crosses the axis."""
    y, u = 1.0, 1.0 / max(focus_distance, 1e-6)  # height, angle
    eta_in = 1.0
    for s in surfs:  # front to back
        r = s["radius_x"]
        eta_out = s["eta"] if s["eta"] > 0 else 1.0
        if r != 0:
            # refraction at a spherical surface: n'u' = nu - y(n'-n)/R
            u = (eta_in * u - y * (eta_out - eta_in) / r) / eta_out
        y = y + u * s["thickness"]
        eta_in = eta_out
    if abs(u) < 1e-12:
        return 0.05
    return max(y / -u, 1e-4) if (y / -u) > 0 else 0.05


def _kind(s):
    if s["radius_x"] == 0 and s["radius_y"] == 0:
        return "flat"
    if (s["radius_x"] == s["radius_y"] and s["conic_x"] == 0
            and s["conic_y"] == 0 and not any(s["asph"])):
        return "sphere"
    return "biconic"


def _curvatures(surfs, key):
    # lens files measure radii along the light (scene->film); the camera
    # frame traces film->scene (+z), so a file radius R puts the centre of
    # curvature at vertex_z - R
    return np.asarray([0.0 if s[key] == 0 else -1.0 / s[key]
                       for s in surfs], np.float32)


def build_lens_camera(kind, cam_to_world: tfm.Transform, surfs,
                      film_distance=0.0, focus_distance=10.0,
                      film_diag=0.035, ca_enabled=False,
                      simple_weighting=True, diffraction=False,
                      retina_radius=0.0, retina_semi_diam=0.0,
                      ior_spectra=None, shutter_open=0.0, shutter_close=1.0,
                      pupil_diameter=None, microlens=None,
                      microlens_sensor_offset=0.001,
                      microlens_sim_radius=0, device=None):
    """surfs: front-to-back (file order).  The camera's arrays run
    rear-to-front with absolute z (film at z = 0), on `device` (None: the
    first CUDA card); its exit pupil is traced there."""
    device = devmod.resolve(device)
    S = len(surfs)
    if S == 0:
        raise ValueError("lens camera needs at least one surface")
    if film_distance <= 0:
        film_distance = _paraxial_focus(surfs, focus_distance)
    # vertex z from the film plane: the rear vertex at film_distance; a
    # surface's thickness (front-to-back) is the gap behind it, so walking
    # rear->front adds the next surface's
    rear_first = list(reversed(surfs))
    z_list, z = [], film_distance
    for i in range(S):
        z_list.append(z)
        if i + 1 < S:
            z += rear_first[i + 1]["thickness"]

    iors = np.ones((MAX_IOR_SPECTRA, spec.N_SPECTRAL_SAMPLES), np.float32)
    for i, sp in enumerate((ior_spectra or [])[:MAX_IOR_SPECTRA]):
        if sp is not None:
            iors[i] = sp
    eta_idx = np.full(S, -1, np.int32)
    eta_const = np.ones(S, np.float32)
    for i, s in enumerate(rear_first):
        eta_const[i] = s["eta"] if s["eta"] > 0 else 1.0
        if s.get("medium_index", 0) > 0:
            eta_idx[i] = s["medium_index"] - 1

    ap = np.array([s["semi_aperture"] for s in rear_first], np.float32)
    if pupil_diameter is not None:
        # the stop (radius 0) takes the pupil diameter (the eye model)
        for i, s in enumerate(rear_first):
            if s["radius_x"] == 0:
                ap[i] = pupil_diameter / 2
    rear_ap = ap[0]
    is_stop = np.asarray([s["radius_x"] == 0 for s in rear_first])

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def f32(x):
        return t(np.float32(x))
    cam = LensCamera(
        cam_to_world=t(np.asarray(cam_to_world.m, np.float32)),
        curv_x=t(_curvatures(rear_first, "radius_x")),
        curv_y=t(_curvatures(rear_first, "radius_y")),
        conic_x=t(np.asarray([s["conic_x"] for s in rear_first],
                             np.float32)),
        conic_y=t(np.asarray([s["conic_y"] for s in rear_first],
                             np.float32)),
        z_pos=t(np.asarray(z_list, np.float32)),
        aperture=t(ap), is_stop=t(is_stop, torch.bool),
        eta_const=t(eta_const), eta_idx=t(eta_idx, torch.int32),
        asph=t(np.asarray([s["asph"] for s in rear_first], np.float32)),
        ior_spectra=t(iors),
        pupil_bounds=torch.zeros((N_PUPIL_ZONES, 4), device=device),
        pupil_valid=torch.zeros(N_PUPIL_ZONES, dtype=torch.bool,
                                device=device),
        film_distance=f32(film_distance), film_diag=f32(film_diag),
        retina_radius=f32(retina_radius),
        retina_semi_diam=f32(retina_semi_diam),
        shutter_open=f32(shutter_open), shutter_close=f32(shutter_close),
        weight_scale=f32(np.pi * rear_ap ** 2
                         / max(film_distance ** 2, 1e-12)),
        n_surfaces=S, surface_kinds=tuple(_kind(s) for s in rear_first),
        ca_enabled=ca_enabled, simple_weighting=simple_weighting,
        diffraction=diffraction, kind=kind,
        eta_idx_host=tuple(int(i) for i in eta_idx),
        is_stop_host=tuple(bool(b) for b in is_stop))
    if microlens:
        cam = _attach_microlens(cam, microlens, microlens_sensor_offset,
                                microlens_sim_radius)
    # the exit pupil's host inputs: the f32 values the camera holds
    return compute_exit_pupil(
        cam, float(np.float32(film_diag)), float(rear_ap),
        float(np.float32(z_list[0])), float(np.float32(retina_radius)))


def _attach_microlens(cam: LensCamera, ml: dict, sensor_offset, sim_radius):
    """The microlens-array block (omni.cpp:1330+ JSON) baked into the
    camera.  Surfaces (mm, as the main stack's) are stored rear-first; the
    reference walks them with elementZ -= thickness from 0 in its
    z-flipped lens space (omni.cpp TraceLensesFromFilm:397-410), so here
    surface k sits at z = sum(thickness[0..k])."""
    msurfs = [_json_surface(s, False) for s in ml.get("surfaces", [])]
    if not msurfs:
        return cam
    dims = ml.get("dimensions") or [16, 16]
    nx, ny = int(dims[0]), int(dims[1])
    offsets = np.zeros((ny * nx, 2), np.float32)
    if ml.get("offsets"):
        offs = np.asarray(ml["offsets"], np.float32).reshape(-1, 2)
        offsets[:min(len(offs), ny * nx)] = offs[:ny * nx]
    rear_first = list(reversed(msurfs))
    z, z_list = 0.0, []
    for s in rear_first:
        z += s["thickness"]
        z_list.append(z)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=cam.device)
    return dataclasses.replace(
        cam,
        ml_curv_x=t(_curvatures(rear_first, "radius_x")),
        ml_curv_y=t(_curvatures(rear_first, "radius_y")),
        ml_conic_x=t([s["conic_x"] for s in rear_first]),
        ml_conic_y=t([s["conic_y"] for s in rear_first]),
        ml_z=t(z_list), ml_aperture=t([s["semi_aperture"]
                                       for s in rear_first]),
        ml_eta=t([s["eta"] for s in rear_first]),
        ml_asph=t([s["asph"] for s in rear_first]),
        ml_offsets=t(offsets), ml_offset_sensor=t(np.float32(sensor_offset)),
        ml_n_surfaces=len(rear_first),
        ml_surface_kinds=tuple(_kind(s) for s in rear_first),
        ml_dims=(nx, ny), ml_sim_radius=int(sim_radius),
        ml_has_offsets=bool(np.any(offsets != 0)))


def compute_exit_pupil(cam: LensCamera, film_diag, rear_r, rear_z,
                       retina_radius=0.0, n_zones=N_PUPIL_ZONES,
                       samples=2048):
    """Per-radial-zone exit-pupil bounds on the rear plane (in place of
    the reference's per-zone projection sampling, realistic.cpp:787+):
    rays from each zone's film point at rear-disk samples, the survivors
    bounded and padded by one sample spacing.

    film_diag, rear_r (the rear element's semi-aperture), rear_z and
    retina_radius are the camera's f32 values as host floats, so that the
    build reads nothing back from the card but the survivors.  The
    samples are numpy.random.RandomState(42)'s, drawn as the JAX package
    draws them (for each zone, px then py); all zones are traced as one
    batch."""
    rs = np.random.RandomState(42)
    r_max = 0.5 * film_diag
    pad = 2.0 * rear_r / np.sqrt(samples)
    o_np = np.zeros((n_zones, 3))
    pxy = np.zeros((2, n_zones, samples))
    for z in range(n_zones):
        rf = (z + 0.5) / n_zones * r_max
        if cam.kind in EYE_KINDS:
            rr = retina_radius
            zs = rr - np.sqrt(max(rr * rr - min(rf * rf, rr * rr * .99),
                                  1e-12))
            o_np[z] = [rf, 0.0, zs]
        else:
            o_np[z] = [rf, 0.0, 0.0]
        pxy[0, z] = (rs.rand(samples) * 2 - 1) * rear_r
        pxy[1, z] = (rs.rand(samples) * 2 - 1) * rear_r
    dev = cam.device
    o = torch.as_tensor(np.repeat(o_np.astype(np.float32), samples, 0),
                        device=dev)
    rear = torch.as_tensor(np.stack(
        [pxy[0].ravel(), pxy[1].ravel(),
         np.full(n_zones * samples, rear_z)], -1).astype(np.float32),
        device=dev)
    d = rear - o
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True))
    _, _, ok = trace_lenses_from_film(
        cam, o, d, torch.full((n_zones * samples,), 550.0, device=dev))
    ok = ok.cpu().numpy().reshape(n_zones, samples)
    bounds = np.zeros((n_zones, 4), np.float32)
    valid = ok.any(1)
    for z in np.nonzero(valid)[0]:
        px, py = pxy[0, z][ok[z]], pxy[1, z][ok[z]]
        bounds[z] = [px.min() - pad, py.min() - pad,
                     px.max() + pad, py.max() + pad]
    # zones with no survivors inherit a neighbour's (vignetted edge zones)
    for z in range(n_zones):
        if not valid[z]:
            for w in list(range(z - 1, -1, -1)) + list(range(z + 1,
                                                              n_zones)):
                if valid[w]:
                    bounds[z] = bounds[w]
                    break
    return dataclasses.replace(
        cam, pupil_bounds=torch.as_tensor(bounds, device=dev),
        pupil_valid=torch.as_tensor(valid, device=dev))


def lens_camera_from_jax(arrays: dict, static: dict, device) -> LensCamera:
    """The port's camera for a pbrt_tpu lens camera, given
    {name: np.asarray(getattr(jax_camera, name))} for its array fields
    (TENSOR_FIELDS, and ML_FIELDS or None for them) and {name: value}
    for its static ones (STATIC_FIELDS).  The exit pupil is the JAX
    camera's, not traced again."""
    device = devmod.resolve(device)

    def t(k):
        return torch.as_tensor(np.array(arrays[k]), device=device)
    fields = {k: t(k) for k in TENSOR_FIELDS}
    fields.update({k: (None if arrays.get(k) is None else t(k))
                   for k in ML_FIELDS})
    fields.update({k: static[k] for k in STATIC_FIELDS})
    return LensCamera(
        **fields,
        eta_idx_host=tuple(int(i) for i in np.asarray(arrays["eta_idx"])),
        is_stop_host=tuple(bool(b) for b in np.asarray(arrays["is_stop"])))


# ---------------------------------------------------------------------------
# surface intersection + refraction (batched, per unrolled surface)
# ---------------------------------------------------------------------------

def _ipow(x, n):
    """x ** n for a small positive int n by the JAX package's
    square-and-multiply (lax.integer_pow), so the roundings match."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _sag(cx, cy, kx, ky, asph, x, y):
    """Biconic + even-aspheric sag z(x, y) (omni.cpp IntersectResult /
    realisticEye BiconicSag)."""
    x2, y2 = x * x, y * y
    num = cx * x2 + cy * y2
    arg = 1.0 - (1.0 + kx) * cx * cx * x2 - (1.0 + ky) * cy * cy * y2
    den = 1.0 + torch.sqrt(torch.clamp(arg, min=1e-12))
    r2 = x2 + y2
    a = (asph[0] * _ipow(r2, 2) + asph[1] * _ipow(r2, 3)
         + asph[2] * _ipow(r2, 4) + asph[3] * _ipow(r2, 5))
    return num / den + a


def _sag_slopes(cx, cy, kx, ky, asph, p, eps=1e-6):
    """The sag at p and its forward-difference slopes in x and y."""
    s0 = _sag(cx, cy, kx, ky, asph, p[:, 0], p[:, 1])
    sx = (_sag(cx, cy, kx, ky, asph, p[:, 0] + eps, p[:, 1]) - s0) / eps
    sy = (_sag(cx, cy, kx, ky, asph, p[:, 0], p[:, 1] + eps) - s0) / eps
    return s0, sx, sy


def _intersect_surface(o, d, z_vertex, cx, cy, kx, ky, asph, kind):
    """Ray against one surface with its vertex at z_vertex; kind is
    "flat", "sphere" or "biconic".  Returns (t, n, ok), n the unit
    normal facing against the ray.  The JAX package forms the flat and
    the sphere answers for every kind and picks one with a static
    `where`; only the picked one is formed here."""
    dz = d[:, 2]
    t_flat = (z_vertex - o[:, 2]) / torch.where(torch.abs(dz) > 1e-12, dz,
                                                1e-12)
    if kind == "flat":
        t_surf, ok = t_flat, t_flat > 1e-9
        n = torch.tensor([0.0, 0.0, 1.0], device=o.device).expand_as(o)
    elif kind == "sphere":
        radius = 1.0 / torch.where(torch.abs(cx) > 1e-12, cx, 1e-12)
        zc = z_vertex + radius
        oc = torch.stack([o[:, 0], o[:, 1], o[:, 2] - zc], -1)
        A = geom.dot(d, d)
        Bq = 2 * geom.dot(oc, d)
        Cq = geom.dot(oc, oc) - radius * radius
        disc = Bq * Bq - 4 * A * Cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(Bq < 0, -0.5 * (Bq - sq), -0.5 * (Bq + sq))
        t0 = q / torch.where(A == 0, 1.0, A)
        t1 = Cq / torch.where(q == 0, 1.0, q)
        # the root on the vertex's side of the centre (the reference's
        # IntersectSphericalElement: useCloserT = (d.z > 0) ^ (radius < 0))
        closer = (dz > 0) ^ (radius < 0)
        t_surf = torch.where(closer, torch.minimum(t0, t1),
                             torch.maximum(t0, t1))
        ok = (disc >= 0) & (t_surf > 1e-9)
        p = o + t_surf[:, None] * d
        n = geom.normalize(torch.stack([p[:, 0], p[:, 1], p[:, 2] - zc],
                                       -1))
    else:
        # Newton steps on g(t) = p_z - (z_vertex + sag(p_x, p_y)) from the
        # plane, a fixed 10 of them (no early exit, as in JAX)
        t_surf = t_flat
        for _ in range(10):
            p = o + t_surf[:, None] * d
            s0, sx, sy = _sag_slopes(cx, cy, kx, ky, asph, p)
            g = p[:, 2] - (z_vertex + s0)
            dg = dz - (sx * d[:, 0] + sy * d[:, 1])
            t_surf = t_surf - g / torch.where(torch.abs(dg) > 1e-9, dg,
                                              1e-9)
        p = o + t_surf[:, None] * d
        _, sx, sy = _sag_slopes(cx, cy, kx, ky, asph, p)
        n = geom.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], -1))
        ok = torch.isfinite(t_surf) & (t_surf > 1e-9)
    # orient the normal against the incoming ray (faceforward)
    n = torch.where((geom.dot(n, d) > 0)[:, None], -n, n)
    return t_surf, n, ok


def _ca_shift(eta, wavelength):
    """The linear dispersion of realistic.cpp:352-357 on an IoR above 1."""
    shift = (wavelength - 550.0) * (-0.04 / 300.0)
    return torch.where(eta > 1.0001, eta + shift, eta)


def _eta_at(cam: LensCamera, si, wavelength):
    """Per-ray IoR on the film side of surface si (spectral or CA model)."""
    eta = cam.eta_const[si]
    idx = cam.eta_idx_host[si]
    if idx >= 0:
        eta_sp = spec.value_at_wavelength(cam.ior_spectra[idx], wavelength)
        eta = torch.where(eta_sp > 1e-3, eta_sp, eta)
    if cam.ca_enabled:
        eta = _ca_shift(eta, wavelength)
    return eta


def _gauss_from_bits(key_bits, salt):
    u1 = prng.uniform_float(key_bits, salt)
    u2 = prng.uniform_float(key_bits, salt + 977)
    return (torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-9)))
            * torch.cos(2 * math.pi * u2))


def trace_lenses_from_film(cam: LensCamera, o, d, wavelength, key_bits=None):
    """Trace rays (camera space, from the film side) through the stack
    rear->front.  Returns (o', d', valid).

    A surface's eta is the IoR of the medium on its FILM side, so crossing
    surface i film->scene refracts eta[i] -> eta[i+1] (1 beyond the front
    element; realistic.cpp TraceLensesFromFilm:302+).  With diffraction
    and key_bits, the stop bends each live ray by HURB
    (realisticEye.cpp:828-850)."""
    valid = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for si in range(cam.n_surfaces):
        kind = cam.surface_kinds[si]
        t, n, ok = _intersect_surface(
            o, d, cam.z_pos[si], cam.curv_x[si], cam.curv_y[si],
            cam.conic_x[si], cam.conic_y[si], cam.asph[si], kind)
        p = o + t[:, None] * d
        # aperture cull
        r2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        ok = ok & (r2 <= cam.aperture[si] * cam.aperture[si])
        if cam.diffraction and key_bits is not None and cam.is_stop_host[si]:
            # Heisenberg-uncertainty ray bending: a Gaussian tilt of
            # standard deviation ~ lambda / distance to the stop's edge
            dist_edge = torch.clamp(cam.aperture[si] - torch.sqrt(r2),
                                    min=1e-9)
            sigma = (wavelength * 1e-9) / (2 * math.pi * dist_edge)
            g1 = _gauss_from_bits(key_bits, si * 2)
            g2 = _gauss_from_bits(key_bits, si * 2 + 1)
            d = torch.where(valid[:, None], geom.normalize(d + torch.stack(
                [g1 * sigma, g2 * sigma, torch.zeros_like(g1)], -1)), d)
        if kind == "flat":
            new_d = d      # the stop refracts nothing
        else:
            # beyond the front element the medium is air: eta_i / 1
            ratio = _eta_at(cam, si, wavelength)
            if si + 1 < cam.n_surfaces:
                ratio = ratio / torch.clamp(_eta_at(cam, si + 1, wavelength),
                                            min=1e-6)
            can, wt = geom.refract(-d, n, ratio)
            new_d = torch.where(can[:, None], geom.normalize(wt), d)
            ok = ok & can
        d = torch.where(valid[:, None], new_d, d)
        o = torch.where(valid[:, None], p, o)
        valid = valid & ok
    return o, d, valid


# ---------------------------------------------------------------------------
# microlens array (omni.cpp:963-1140)
# ---------------------------------------------------------------------------

def _ml_extent(cam, width, height):
    """Physical film half-sizes (film.cpp GetPhysicalExtent)."""
    aspect = height / width
    fw = torch.sqrt(cam.film_diag * cam.film_diag / (1 + aspect * aspect))
    return fw, fw * aspect


def _ml_index(cam, px, py, fw, fh):
    """Microlens cell of a film point (omni.cpp MicrolensIndex:963)."""
    nx, ny = cam.ml_dims
    ix = torch.floor((px / fw + 0.5) * nx).to(torch.int32)
    iy = torch.floor((py / fh + 0.5) * ny).to(torch.int32)
    return ix, iy


def _ml_center(cam, ix, iy, fw, fh):
    """Lens centre of a cell, plus its offset when the cell is in range
    (omni.cpp MicrolensCenterFromIndex:1037)."""
    nx, ny = cam.ml_dims
    cx = ((ix + 0.5) / nx - 0.5) * fw
    cy = ((iy + 0.5) / ny - 0.5) * fh
    if cam.ml_has_offsets:
        inside = (ix >= 0) & (iy >= 0) & (ix < nx) & (iy < ny)
        flat = (torch.clamp(iy, 0, ny - 1) * nx
                + torch.clamp(ix, 0, nx - 1)).to(torch.int64)
        off = cam.ml_offsets[flat]          # [B,2]
        cx = cx + torch.where(inside, off[:, 0], 0.0)
        cy = cy + torch.where(inside, off[:, 1], 0.0)
    return cx, cy


def _ml_cell_corners(cam, ix, iy, fw, fh):
    """A cell's corners, counter-clockwise from (-,-): each the average of
    its 4 adjacent lens centres (omni.cpp MicrolensElementFromIndex:
    1048-1066); exact rectangles when every offset is zero."""
    nx, ny = cam.ml_dims
    if not cam.ml_has_offsets:
        cx = ((ix + 0.5) / nx - 0.5) * fw
        cy = ((iy + 0.5) / ny - 0.5) * fh
        hw, hh = 0.5 * fw / nx, 0.5 * fh / ny
        return [(cx - hw, cy - hh), (cx + hw, cy - hh),
                (cx + hw, cy + hh), (cx - hw, cy + hh)]
    corners = []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        ax0 = 0 if sx > 0 else -1
        ay0 = 0 if sy > 0 else -1
        xx = yy = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                ccx, ccy = _ml_center(cam, ix + ax0 + dx, iy + ay0 + dy,
                                      fw, fh)
                xx = xx + ccx
                yy = yy + ccy
        corners.append((xx * 0.25, yy * 0.25))
    return corners


def _in_quad(px, py, corners):
    """Point in a convex quad by consistent edge cross signs (CCW)."""
    inside = None
    for i in range(4):
        x0, y0 = corners[i]
        x1, y1 = corners[(i + 1) % 4]
        s = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        inside = (s >= 0) if inside is None else inside & (s >= 0)
    return inside


def _ml_trace_stack(cam, o, d, wavelength, cx, cy, corners, rear_only=False):
    """Trace the microlens stack under the lens centred at (cx, cy)
    (omni.cpp TraceLensesFromFilm with ComputeCameraToMicrolens:1033:
    the lateral shift per ray; the reference's z flip is folded into the
    +z convention).  corners: the CELL's bounds in film space; the
    aperture test is the circle AND the cell's quad.  rear_only: (t, ok)
    of the rear surface alone (TToBackLens:450)."""
    zero = torch.zeros_like(cx)
    ol = o - torch.stack([cx, cy, zero], -1)
    cc = [(qx - cx, qy - cy) for qx, qy in corners]   # centred bounds
    valid = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for k in range(1 if rear_only else cam.ml_n_surfaces):
        kind = cam.ml_surface_kinds[k]
        t, n, ok = _intersect_surface(
            ol, d, cam.ml_z[k], cam.ml_curv_x[k], cam.ml_curv_y[k],
            cam.ml_conic_x[k], cam.ml_conic_y[k], cam.ml_asph[k], kind)
        p = ol + t[:, None] * d
        r2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        ok = ok & (r2 <= cam.ml_aperture[k] * cam.ml_aperture[k])
        ok = ok & _in_quad(p[:, 0], p[:, 1], cc)
        if rear_only:
            return t, valid & ok
        if kind != "flat":
            eta_i = cam.ml_eta[k]
            eta_t = (cam.ml_eta[k + 1] if k + 1 < cam.ml_n_surfaces
                     else torch.ones_like(eta_i))
            if cam.ca_enabled:
                eta_i = _ca_shift(eta_i, wavelength)
                eta_t = _ca_shift(eta_t, wavelength)
            ratio = eta_i / torch.clamp(eta_t, min=1e-6)
            can, wt = geom.refract(-d, n, ratio.expand(o.shape[0]))
            new_d = torch.where(can[:, None], geom.normalize(wt), d)
            ok = ok & can
        else:
            new_d = d
        d = torch.where(valid[:, None], new_d, d)
        ol = torch.where(valid[:, None], p, ol)
        valid = valid & ok
    return ol + torch.stack([cx, cy, zero], -1), d, valid


def _ml_sample_pupil(cam, px, py, u_lens, fw, fh):
    """A point of the (2R+1)^2-cell neighbourhood on the microlens plane
    (omni.cpp SampleMicrolensPupil:972), and the neighbourhood's area."""
    nx, ny = cam.ml_dims
    R = cam.ml_sim_radius
    ix, iy = _ml_index(cam, px, py, fw, fh)
    diam = 2.0 * R + 1.0
    sx = ((ix - R + u_lens[:, 0] * diam) / nx - 0.5) * fw
    sy = ((iy - R + u_lens[:, 1] * diam) / ny - 0.5) * fh
    area = fw * fh * diam * diam / (nx * ny)
    return torch.stack([sx, sy, (0.0 + cam.ml_offset_sensor).expand_as(sx)],
                       -1), area


def _ml_full_trace(cam, o, d, wavelength, fw, fh):
    """Of the (2R+1)^2 neighbourhood, the microlens whose rear surface the
    ray meets first; its stack, then the main stack
    (omni.cpp TraceFullLensSystemFromFilm:1074-1110)."""
    # the cell under the ray's crossing of the microlens plane
    dz = d[:, 2]
    tz = cam.ml_offset_sensor / torch.where(torch.abs(dz) > 1e-12, dz,
                                            1e-12)
    cix, ciy = _ml_index(cam, o[:, 0] + tz * d[:, 0],
                         o[:, 1] + tz * d[:, 1], fw, fh)
    R = cam.ml_sim_radius
    best_t = torch.full((o.shape[0],), math.inf, device=o.device)
    best = None
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ix, iy = cix + dx, ciy + dy
            cx, cy = _ml_center(cam, ix, iy, fw, fh)
            corners = _ml_cell_corners(cam, ix, iy, fw, fh)
            t, ok = _ml_trace_stack(cam, o, d, wavelength, cx, cy,
                                    corners, rear_only=True)
            t = torch.where(ok, t, math.inf)
            cand = (cx, cy) + tuple(c for q in corners for c in q)
            if best is None:
                best = cand
            else:
                take = t < best_t
                best = tuple(torch.where(take, new, old)
                             for new, old in zip(cand, best))
            best_t = torch.minimum(best_t, t)
    bcorners = [(best[2 + 2 * i], best[3 + 2 * i]) for i in range(4)]
    o1, d1, ok1 = _ml_trace_stack(cam, o, d, wavelength, best[0], best[1],
                                  bcorners)
    ok1 = ok1 & torch.isfinite(best_t)
    o2, d2, ok2 = trace_lenses_from_film(cam, o1, d1, wavelength)
    return o2, d2, ok1 & ok2


# ---------------------------------------------------------------------------
# ray generation
# ---------------------------------------------------------------------------

def _finish(cam, o2, d2, ok, weight, u_time, wavelength):
    """World-space rays; rays that died in the lens get tmax = -1."""
    B = o2.shape[0]
    wo = tfm.xform_point(cam.cam_to_world, o2)
    wd = geom.normalize(tfm.xform_vector(cam.cam_to_world, d2))
    if u_time is None:
        time = cam.shutter_open.expand(B)
    else:
        time = cam.shutter_open + u_time * (cam.shutter_close
                                            - cam.shutter_open)
    ray = geom.Ray.make(wo, wd, wavelength=wavelength, time=time)
    return ray.replace(tmax=torch.where(ok, ray.tmax, -1.0)), weight


def generate_rays(cam: LensCamera, pfilm, u_lens, u_time=None,
                  width=None, height=None, wavelength=None):
    """Camera rays through the lens stack (GenerateRay, realistic.cpp:
    899-935 / omni.cpp:1121-1172 / realisticEye.cpp:471+).

    pfilm [B,2] raster coords, u_lens [B,2], u_time [B] or None (the
    shutter's opening), width/height the film's size, wavelength (nm; a
    number or [B]; default 550).  Returns (Ray in world space, weight
    [B]); rays that die in the lens get weight 0 and tmax = -1."""
    B = pfilm.shape[0]
    dev = pfilm.device
    aspect = height / width
    diag = cam.film_diag
    fw = torch.sqrt(diag * diag / (1 + aspect * aspect))
    fh = fw * aspect
    # the film sample in camera space (film at z = 0; x flipped as pbrt)
    sx = (0.5 - pfilm[:, 0] / width) * fw
    sy = (pfilm[:, 1] / height - 0.5) * fh
    if cam.kind in EYE_KINDS:
        # the curved retina (realisticEye.cpp:499-544): apex at z = 0,
        # off-axis points bulge toward the lens (+z)
        rr, semi = cam.retina_radius, cam.retina_semi_diam
        x = sx / torch.clamp(fw, min=1e-9) * 2 * semi
        y = sy / torch.clamp(fh, min=1e-9) * 2 * semi
        r2 = torch.minimum(x * x + y * y, semi * semi * 0.999)
        zs = rr - torch.sqrt(torch.clamp(rr * rr - r2, min=1e-12))
        o = torch.stack([x, y, zs], -1)
    else:
        o = torch.stack([sx, sy, torch.zeros_like(sx)], -1)
    wavelength = (torch.full((B,), 550.0, device=dev) if wavelength is None
                  else torch.as_tensor(wavelength, dtype=torch.float32,
                                       device=dev).expand(B))
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
    if cam.ml_n_surfaces > 0:
        # the microlens path (omni.cpp GenerateRay:1135-1186): sample the
        # cell neighbourhood on the microlens plane, not the exit pupil;
        # trace the microlens stack, then the main stack
        fw_e, fh_e = _ml_extent(cam, width, height)
        p_rear, bounds_area = _ml_sample_pupil(cam, o[:, 0], o[:, 1],
                                               u_lens, fw_e, fh_e)
        d = geom.normalize(p_rear - o)
        o2, d2, ok = _ml_full_trace(cam, o, d, wavelength, fw_e, fh_e)
        cos_t = geom.absdot(geom.normalize(p_rear - o), z_axis)
        cos4 = _ipow(cos_t, 4)
        if cam.simple_weighting:
            R = cam.ml_sim_radius
            weight = torch.where(ok, cos4 * float((2 * R + 1) ** 2), 0.0)
        else:
            rear_z = cam.z_pos[0]
            weight = torch.where(
                ok, (cam.shutter_close - cam.shutter_open) * cos4
                * bounds_area / torch.clamp(rear_z * rear_z, min=1e-12),
                0.0)
        return _finish(cam, o2, d2, ok, weight, u_time, wavelength)
    # sample the exit pupil of this film radius (SampleExitPupil,
    # realistic.cpp:855+), rotated to the film point's azimuth
    nz = cam.pupil_bounds.shape[0]
    r_film = torch.sqrt(o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1])
    r_max = 0.5 * cam.film_diag
    zone = torch.clamp((r_film / torch.clamp(r_max, min=1e-9) * nz).to(
        torch.int32), 0, nz - 1)
    pb = cam.pupil_bounds[zone.to(torch.int64)]        # [B,4]
    px = pb[:, 0] + u_lens[:, 0] * (pb[:, 2] - pb[:, 0])
    py = pb[:, 1] + u_lens[:, 1] * (pb[:, 3] - pb[:, 1])
    safe_r = torch.clamp(r_film, min=1e-12)
    far = r_film > 1e-9
    cphi = torch.where(far, o[:, 0] / safe_r, 1.0)
    sphi = torch.where(far, o[:, 1] / safe_r, 0.0)
    p_rear = torch.stack([cphi * px - sphi * py, sphi * px + cphi * py,
                          (0.0 + cam.z_pos[0]).expand(B)], -1)
    d = geom.normalize(p_rear - o)
    key_bits = prng.hash_combine(
        (pfilm[:, 0] * 4096).to(torch.int64) & prng.M32,
        (pfilm[:, 1] * 4096).to(torch.int64) & prng.M32)
    o2, d2, ok = trace_lenses_from_film(cam, o, d, wavelength, key_bits)
    if cam.simple_weighting:
        weight = torch.where(ok, 1.0, 0.0)
    else:
        cos_t = geom.absdot(geom.normalize(p_rear - o), z_axis)
        weight = torch.where(ok, _ipow(cos_t, 4) * cam.weight_scale, 0.0)
    return _finish(cam, o2, d2, ok, weight, u_time, wavelength)


# ---------------------------------------------------------------------------
# scene-level construction (the CLI)
# ---------------------------------------------------------------------------

LENS_KINDS = ("realistic", "omni", "realisticEye", "realisticeye",
              "humaneye")


def make_lens_camera(job, width, height, device=None):
    """The job's lens camera, from the keys job.camera_params carries (the
    JAX parser's: lensfile, aperturediameter, filmdistance, focaldistance,
    shutteropen, shutterclose and the projective ones); a key it does not
    carry takes its default here, as in the JAX package."""
    cp = job.camera_params
    kind = job.camera_kind
    lensfile = cp.get("lensfile", "")
    common = dict(shutter_open=cp.get("shutteropen", 0.0),
                  shutter_close=cp.get("shutterclose", 1.0), device=device)
    if kind == "realistic":
        if not lensfile:
            raise ValueError("realistic camera requires lensfile")
        surfs = read_dat_lens(lensfile, cp.get("aperturediameter", 1.0))
        return build_lens_camera(
            "realistic", job.cam_to_world, surfs,
            film_distance=cp.get("filmdistance", 0.0) * 1e-3,
            focus_distance=cp.get("focaldistance", 10.0),
            film_diag=job.film_diagonal * 1e-3,
            ca_enabled=bool(cp.get("chromaticAberrationEnabled", False)),
            **common)
    if kind == "omni":
        if not lensfile:
            raise ValueError("omni camera requires lensfile (json)")
        surfs, microlens = read_json_lens(lensfile,
                                          cp.get("aperturediameter", 1.0))
        return build_lens_camera(
            "omni", job.cam_to_world, surfs,
            film_distance=cp.get("filmdistance", 0.0) * 1e-3,
            focus_distance=cp.get("focaldistance", 10.0),
            film_diag=job.film_diagonal * 1e-3,
            ca_enabled=bool(cp.get("chromaticAberrationEnabled", False)),
            microlens=microlens,
            microlens_sensor_offset=cp.get("microlenssensoroffset", 0.001),
            microlens_sim_radius=int(cp.get("microlenssimulationradius",
                                            0)),
            **common)
    if kind in ("realisticEye", "realisticeye", "humaneye"):
        specfile = cp.get("specfile", "") or lensfile
        if not specfile:
            raise ValueError("realisticEye camera requires specfile")
        scaling = 1.0 if bool(cp.get("mmUnits", True)) else 1e-3
        _, surfs = read_eye_spec(specfile, scaling)
        return build_lens_camera(
            "realisticEye", job.cam_to_world, surfs,
            film_distance=cp.get("retinaDistance", 16.32) * scaling,
            film_diag=2 * cp.get("retinaSemiDiam", 4.0) * scaling,
            retina_radius=cp.get("retinaRadius", 12.0) * scaling,
            retina_semi_diam=cp.get("retinaSemiDiam", 4.0) * scaling,
            ior_spectra=[cp.get(f"ior{i}") for i in range(1, 7)],
            diffraction=bool(cp.get("diffractionEnabled", False)),
            pupil_diameter=cp.get("pupilDiameter", 4.0) * scaling,
            **common)
    raise ValueError(f"unknown lens camera {kind}")
