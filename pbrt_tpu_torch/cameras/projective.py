"""Perspective camera (port of the perspective part of
pbrt_tpu.cameras.projective).

The raster->camera chain is built on the host exactly as the reference's
ProjectiveCamera constructor does (camera.h:86+); ray generation is a
batched closed form, with thin-lens depth of field (perspective.cpp:69).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import transform as tfm


@dataclass
class ProjectiveCamera:
    cam_to_world: torch.Tensor       # [4,4]
    raster_to_camera: torch.Tensor   # [4,4]
    camera_to_raster: torch.Tensor   # [4,4]
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    shutter_open: float = 0.0
    shutter_close: float = 1.0

    def to(self, device):
        return dataclasses.replace(
            self, cam_to_world=self.cam_to_world.to(device),
            raster_to_camera=self.raster_to_camera.to(device),
            camera_to_raster=self.camera_to_raster.to(device))


def _screen_window(width, height):
    aspect = width / height
    if aspect > 1:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def make_perspective(cam_to_world: tfm.Transform, fov_deg, width, height,
                     device="cpu"):
    """Pinhole perspective camera (lens radius 0, shutter [0, 1]); cameras
    with a thin lens come from camera_from_jax."""
    x0, x1, y0, y1 = _screen_window(width, height)
    raster_to_screen = (tfm.scale(width, height, 1.0)
                        * tfm.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
                        * tfm.translate(-x0, -y1, 0.0)).inverse()
    raster_to_camera = (tfm.perspective(fov_deg, 1e-2, 1000.0).inverse()
                        * raster_to_screen)

    def f32(m):
        return torch.as_tensor(np.asarray(m, np.float32), device=device)
    return ProjectiveCamera(
        cam_to_world=f32(cam_to_world.m),
        raster_to_camera=f32(raster_to_camera.m),
        camera_to_raster=f32(raster_to_camera.m_inv))


def camera_from_jax(arrays: dict, device) -> ProjectiveCamera:
    """The port's camera for a pbrt_tpu perspective camera, given
    {name: np.asarray(getattr(jax_camera, name))} for its fields."""
    return ProjectiveCamera(
        **{k: torch.as_tensor(np.array(arrays[k], np.float32),
                              device=device)
           for k in ("cam_to_world", "raster_to_camera", "camera_to_raster")},
        **{k: float(arrays[k]) for k in ("lens_radius", "focal_distance",
                                         "shutter_open", "shutter_close")})


def generate_rays(camera: ProjectiveCamera, pfilm, u_lens, u_time=None):
    """pfilm [B,2] raster coords, u_lens [B,2] -> (Ray world, weight [B])."""
    B = pfilm.shape[0]
    dev = pfilm.device
    pras = torch.cat([pfilm, torch.zeros((B, 1), device=dev)], -1)
    pcam = tfm.xform_point(camera.raster_to_camera, pras)
    o = torch.zeros((B, 3), device=dev)
    d = geom.normalize(pcam)
    if camera.lens_radius > 0:
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
    wo = tfm.xform_point(camera.cam_to_world, o)
    wd = geom.normalize(tfm.xform_vector(camera.cam_to_world, d))
    return geom.Ray.make(wo, wd, time=time), torch.ones(B, device=dev)
