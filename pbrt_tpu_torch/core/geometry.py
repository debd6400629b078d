"""SoA vector geometry for batched ray tracing (port of pbrt_tpu.core.geometry).

Vectors are tensors with a trailing xyz axis; `Ray` is a dataclass of
tensors carrying the fork's per-ray wavelength tag.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

INF = float("inf")


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(length_sq(a))


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp(length_sq(a), min=eps))[..., None]


def coordinate_system(v1):
    """Orthonormal frame around unit v1 (branchless Duff et al.);
    returns (v2, v3).  Reference: geometry.h CoordinateSystem."""
    sign = torch.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack([1.0 + sign * v1[..., 0] ** 2 * a, sign * b,
                      -sign * v1[..., 0]], dim=-1)
    v3 = torch.stack([b, sign + v1[..., 1] ** 2 * a, -v1[..., 1]], dim=-1)
    return v2, v3


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction; returns (valid_mask, wt), eta = eta_i / eta_t."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-14))
    wt = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return valid, wt


def frame_to_world(u, v, w, local):
    return local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * w


def world_to_frame(u, v, w, world):
    return torch.stack([dot(world, u), dot(world, v), dot(world, w)], dim=-1)


@dataclass
class Ray:
    """A batch of rays: o, d [B,3]; tmax, wavelength (nm), time [B]."""
    o: torch.Tensor
    d: torch.Tensor
    tmax: torch.Tensor
    wavelength: torch.Tensor
    time: torch.Tensor

    @classmethod
    def make(cls, o, d, tmax=None, wavelength=None, time=None):
        batch = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1])

        def full(v, default):
            if v is None:
                v = default
            if not torch.is_tensor(v):
                return torch.full(batch, float(v), device=o.device)
            return v.expand(batch)
        return cls(o=o, d=d, tmax=full(tmax, INF),
                   wavelength=full(wavelength, 550.0), time=full(time, 0.0))

    def at(self, t):
        return self.o + t[..., None] * self.d

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return Ray(*(getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)))
