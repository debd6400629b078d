"""4x4 transforms (port of pbrt_tpu.core.transform).

`Transform` is a host-side numpy pair (m, m_inv) used while building
scenes and cameras; `xform_point` / `xform_vector` apply a [4,4] tensor.
"""

from __future__ import annotations

import numpy as np


class Transform:
    """Host-side transform used by the scene builder and cameras."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        self.m = np.eye(4) if m is None else np.asarray(m, dtype=np.float64)
        self.m_inv = (np.linalg.inv(self.m) if m_inv is None
                      else np.asarray(m_inv, dtype=np.float64))

    def inverse(self):
        return Transform(self.m_inv, self.m)

    def __mul__(self, other):
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def swaps_handedness(self):
        return np.linalg.det(self.m[:3, :3]) < 0.0

    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        ph = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return ph / w[..., None] if np.any(w != 1.0) else ph


def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    mi = np.eye(4)
    mi[:3, 3] = [-x, -y, -z]
    return Transform(m, mi)


def scale(x, y, z):
    return Transform(np.diag([x, y, z, 1.0]),
                     np.diag([1.0 / x, 1.0 / y, 1.0 / z, 1.0]))


def look_at(eye, look, up):
    """Camera-to-world (reference: transform.cpp LookAt)."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        raise ValueError("LookAt: up parallel to view direction")
    right /= nr
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return Transform(m)


def perspective(fov_deg, znear, zfar):
    """Projective perspective transform (reference: transform.cpp Perspective)."""
    p = np.array([[1, 0, 0, 0],
                  [0, 1, 0, 0],
                  [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
                  [0, 0, 1, 0]], dtype=np.float64)
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return Transform(np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ p)


def xform_point(m, p):
    """[..., 3] points through a [4,4] tensor (with the projective divide)."""
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return ph / w[..., None]


def xform_vector(m, v):
    return v @ m[:3, :3].T
