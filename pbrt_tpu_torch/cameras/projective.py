"""Projective cameras: perspective, orthographic, environment (port of
pbrt_tpu.cameras.projective; reference: src/cameras/{perspective,
orthographic,environment}.cpp).

The raster->camera chain is built on the host exactly as the reference's
ProjectiveCamera constructor does (camera.h:86+); ray generation is a
batched closed form, with thin-lens depth of field (perspective.cpp:69)
and the equirectangular map of environment.cpp.  A perspective camera
given a second cam_to_world keyframe interpolates its decomposed
transform at each ray's time (camera motion blur).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import transform as tfm

ANIM_FIELDS = ("anim_t", "anim_q", "anim_s")


@dataclass
class ProjectiveCamera:
    cam_to_world: torch.Tensor       # [4,4]
    raster_to_camera: torch.Tensor   # [4,4]
    camera_to_raster: torch.Tensor   # [4,4]
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    kind: str = "perspective"        # "orthographic" | "environment"
    # camera motion blur: the decomposed two-keyframe cam_to_world
    # (transform.animated_pair); None for a static camera
    anim_t: torch.Tensor = None      # [2,3]
    anim_q: torch.Tensor = None      # [2,4]
    anim_s: torch.Tensor = None      # [2,3,3]

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _screen_window(width, height, screen=None):
    if screen is not None:
        return tuple(screen)
    aspect = width / height
    if aspect > 1:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def _raster_to_screen(width, height, screen):
    x0, x1, y0, y1 = _screen_window(width, height, screen)
    return (tfm.scale(width, height, 1.0)
            * tfm.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
            * tfm.translate(-x0, -y1, 0.0)).inverse()


def _f32(m, device):
    return torch.as_tensor(np.asarray(m, np.float32), device=device)


def make_perspective(cam_to_world: tfm.Transform, fov_deg, width, height,
                     lens_radius=0.0, focal_distance=1e6, screen=None,
                     shutter_open=0.0, shutter_close=1.0,
                     cam_to_world1: tfm.Transform = None, device=None):
    """Perspective camera on `device` (None: the first CUDA card), with an
    optional thin lens and an optional second keyframe cam_to_world1."""
    device = devmod.resolve(device)
    raster_to_camera = (tfm.perspective(fov_deg, 1e-2, 1000.0).inverse()
                        * _raster_to_screen(width, height, screen))

    def f32(m):
        return _f32(m, device)
    anim = {}
    if cam_to_world1 is not None and not np.allclose(cam_to_world1.m,
                                                     cam_to_world.m):
        anim = dict(zip(ANIM_FIELDS, map(f32, tfm.animated_pair(
            cam_to_world.m, cam_to_world1.m))))
    return ProjectiveCamera(
        cam_to_world=f32(cam_to_world.m),
        raster_to_camera=f32(raster_to_camera.m),
        camera_to_raster=f32(raster_to_camera.m_inv),
        lens_radius=float(lens_radius), focal_distance=float(focal_distance),
        shutter_open=float(shutter_open), shutter_close=float(shutter_close),
        **anim)


def make_orthographic(cam_to_world: tfm.Transform, width, height,
                      lens_radius=0.0, focal_distance=1e6, screen=None,
                      shutter_open=0.0, shutter_close=1.0, device=None):
    """Orthographic camera on `device` (None: the first CUDA card)."""
    device = devmod.resolve(device)
    raster_to_camera = (tfm.orthographic(0.0, 1.0).inverse()
                        * _raster_to_screen(width, height, screen))
    return ProjectiveCamera(
        cam_to_world=_f32(cam_to_world.m, device),
        raster_to_camera=_f32(raster_to_camera.m, device),
        camera_to_raster=_f32(raster_to_camera.m_inv, device),
        lens_radius=float(lens_radius), focal_distance=float(focal_distance),
        shutter_open=float(shutter_open), shutter_close=float(shutter_close),
        kind="orthographic")


def make_environment(cam_to_world: tfm.Transform, width, height,
                     shutter_open=0.0, shutter_close=1.0, device=None):
    """Equirectangular environment camera on `device` (None: the first
    CUDA card)."""
    device = devmod.resolve(device)
    eye = torch.eye(4, device=device)
    return ProjectiveCamera(
        cam_to_world=_f32(cam_to_world.m, device), raster_to_camera=eye,
        camera_to_raster=eye.clone(), shutter_open=float(shutter_open),
        shutter_close=float(shutter_close), kind="environment")


def camera_from_jax(arrays: dict, device) -> ProjectiveCamera:
    """The port's camera for a pbrt_tpu projective camera, given
    {name: np.asarray(getattr(jax_camera, name))} for its fields and
    "kind" for its kind (default perspective; the anim_* fields may be
    absent or None for a static camera)."""
    device = devmod.resolve(device)

    def f32(k):
        return torch.as_tensor(np.array(arrays[k], np.float32),
                               device=device)
    return ProjectiveCamera(
        **{k: f32(k) for k in ("cam_to_world", "raster_to_camera",
                               "camera_to_raster")},
        **{k: float(arrays[k]) for k in ("lens_radius", "focal_distance",
                                         "shutter_open", "shutter_close")},
        kind=str(arrays.get("kind", "perspective")),
        **{k: f32(k) for k in ANIM_FIELDS if arrays.get(k) is not None})


def generate_rays(camera: ProjectiveCamera, pfilm, u_lens, u_time=None,
                  width=None, height=None, wavelength=None):
    """pfilm [B,2] raster coords, u_lens [B,2] -> (Ray world, weight [B]).

    width, height: the film's size (the environment camera maps raster
    coordinates to angles by it); wavelength: nm, a tag every ray carries
    (default 550)."""
    B = pfilm.shape[0]
    dev = pfilm.device
    if camera.kind == "environment":
        # equirect (environment.cpp): theta over height, phi over width
        theta = torch.pi * pfilm[:, 1] / height
        phi = 2 * torch.pi * pfilm[:, 0] / width
        d = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                         torch.sin(theta) * torch.sin(phi)], -1)
        o = torch.zeros((B, 3), device=dev)
    else:
        pras = torch.cat([pfilm, torch.zeros((B, 1), device=dev)], -1)
        pcam = tfm.xform_point(camera.raster_to_camera, pras)
        if camera.kind == "perspective":
            o = torch.zeros((B, 3), device=dev)
            d = geom.normalize(pcam)
        else:
            o = pcam
            d = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(B, 3)
        if camera.lens_radius > 0:
            # depth of field (perspective.cpp:114-127, orthographic.cpp)
            lens = camera.lens_radius * sampling.concentric_sample_disk(
                u_lens[:, 0], u_lens[:, 1])
            ft = camera.focal_distance / torch.clamp(d[:, 2], min=1e-9)
            pfocus = o + ft[:, None] * d
            o = torch.cat([lens, torch.zeros((B, 1), device=dev)], -1)
            d = geom.normalize(pfocus - o)
    if u_time is None:
        time = torch.full((B,), camera.shutter_open, device=dev)
    else:
        time = camera.shutter_open + u_time * (camera.shutter_close
                                               - camera.shutter_open)
    if camera.anim_t is not None:
        # camera motion blur: cam_to_world interpolated at each ray's time
        m34 = tfm.interp_matrix(camera.anim_t, camera.anim_q,
                                camera.anim_s, time)
        wo = torch.einsum("bij,bj->bi", m34[..., :3], o) + m34[..., 3]
        wd = geom.normalize(torch.einsum("bij,bj->bi", m34[..., :3], d))
    else:
        wo = tfm.xform_point(camera.cam_to_world, o)
        wd = geom.normalize(tfm.xform_vector(camera.cam_to_world, d))
    return (geom.Ray.make(wo, wd, wavelength=wavelength, time=time),
            torch.ones(B, device=dev))
