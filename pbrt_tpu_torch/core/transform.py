"""4x4 transforms (port of pbrt_tpu.core.transform).

`Transform` is a host-side numpy pair (m, m_inv) used while building
scenes and cameras; `xform_point` / `xform_vector` apply a [4,4] tensor.
Two-keyframe motion: `animated_pair` decomposes both keyframes into
translation, rotation quaternion and scale on the host, and
`interp_matrix` / `affine_inverse` interpolate them per ray in torch
(the reference's AnimatedTransform, transform.cpp:98-151 and :255+).
"""

from __future__ import annotations

import numpy as np
import torch


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

    def apply_vector(self, v):
        return np.asarray(v, dtype=np.float64) @ self.m[:3, :3].T

    def apply_normal(self, n):
        return np.asarray(n, dtype=np.float64) @ self.m_inv[:3, :3]

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


def rotate(angle_deg, x, y, z):
    a = np.array([x, y, z], dtype=np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(angle_deg)), np.cos(np.radians(angle_deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return Transform(m, m.T)


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


def orthographic(znear, zfar):
    """Orthographic projection (reference: transform.cpp Orthographic)."""
    m = np.eye(4)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return Transform(m)


def xform_point(m, p):
    """[..., 3] points through a [4,4] tensor (with the projective divide)."""
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return ph / w[..., None]


def xform_vector(m, v):
    return v @ m[:3, :3].T


# ---------------------------------------------------------------------------
# two-keyframe animated transforms
# ---------------------------------------------------------------------------

def decompose_trs(m):
    """Host-side M = T R S decomposition (polar iteration, numpy).

    Returns (t [3], q [4] wxyz, s [3,3]), each f32 (the reference's
    AnimatedTransform::Decompose)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        Rn = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rn - R).max() < 1e-10:
            R = Rn
            break
        R = Rn
    S = np.linalg.inv(R) @ M
    return (t.astype(np.float32), quat_from_matrix(R).astype(np.float32),
            S.astype(np.float32))


def quat_from_matrix(R):
    """Rotation matrix -> quaternion (w, x, y, z) (quaternion.cpp)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0)
        w = 0.5 * s
        s = 0.5 / s
        return np.array([w, (R[2, 1] - R[1, 2]) * s,
                         (R[0, 2] - R[2, 0]) * s,
                         (R[1, 0] - R[0, 1]) * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0))
    qi = 0.5 * s
    s = 0.5 / max(s, 1e-12)
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) * s
    q[1 + i] = qi
    q[1 + j] = (R[j, i] + R[i, j]) * s
    q[1 + k] = (R[k, i] + R[i, k]) * s
    return q


def animated_pair(m0, m1):
    """Host precompute for a two-keyframe transform: stacked decomposed
    pieces (t [2,3], q [2,4] with q1 sign-aligned to q0, s [2,3,3])."""
    t0, q0, s0 = decompose_trs(m0)
    t1, q1, s1 = decompose_trs(m1)
    if float(np.dot(q0, q1)) < 0.0:
        q1 = -q1
    return (np.stack([t0, t1]), np.stack([q0, q1]), np.stack([s0, s1]))


def quat_to_matrix(q):
    """Quaternion [...,4] (wxyz) -> rotation matrix [...,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def slerp(q0, q1, u):
    """Slerp with a lerp fallback near parallel (quaternion.cpp:63)."""
    d = torch.clamp(torch.sum(q0 * q1, -1), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(d, -1.0 + 1e-7, 1.0 - 1e-7))
    sin_t = torch.clamp(torch.sin(theta), min=1e-9)
    near = d > 0.9995
    w0 = torch.where(near, 1.0 - u, torch.sin((1.0 - u) * theta) / sin_t)
    w1 = torch.where(near, u, torch.sin(u * theta) / sin_t)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q * torch.rsqrt(torch.clamp(torch.sum(q * q, -1), min=1e-20)
                           )[..., None]


def interp_matrix(anim_t, anim_q, anim_s, u):
    """Per-sample interpolated affine [..., 3, 4] from the stacked pieces
    of animated_pair (tensors [...,2,3], [...,2,4], [...,2,3,3]); u in
    [0,1], broadcastable to the leading dims."""
    uu = u[..., None]
    t = (1 - uu) * anim_t[..., 0, :] + uu * anim_t[..., 1, :]
    s = ((1 - uu[..., None]) * anim_s[..., 0, :, :]
         + uu[..., None] * anim_s[..., 1, :, :])
    q = slerp(anim_q[..., 0, :].expand(u.shape + (4,)),
              anim_q[..., 1, :].expand(u.shape + (4,)), u)
    RS = torch.einsum("...ij,...jk->...ik", quat_to_matrix(q), s)
    return torch.cat([RS, t[..., None]], -1)


def affine_inverse(m34):
    """Inverse of an affine [...,3,4] (adjugate 3x3 + translation)."""
    A = m34[..., :3]
    t = m34[..., 3]
    c0 = torch.linalg.cross(A[..., :, 1], A[..., :, 2], dim=-1)
    det = torch.sum(A[..., :, 0] * c0, -1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
    adj = torch.stack([c0,
                       torch.linalg.cross(A[..., :, 2], A[..., :, 0], dim=-1),
                       torch.linalg.cross(A[..., :, 0], A[..., :, 1], dim=-1)],
                      -2)
    Ainv = adj * inv_det[..., None, None]
    tinv = -torch.einsum("...ij,...j->...i", Ainv, t)
    return torch.cat([Ainv, tinv[..., None]], -1)
