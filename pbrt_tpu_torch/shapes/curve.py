"""Curve shapes (port of pbrt_tpu.shapes.curve; reference:
src/shapes/curve.cpp).

The reference intersects Bezier ribbons by recursive splitting at render
time; pbrt_tpu, and this port, tessellate curves into triangle ribbons
at scene compile (like loopsubdiv/nurbs, which the reference also
tessellates), so hair/fur geometry flows through the same dense/BVH
intersectors with no divergent specialized kernel.  Supports bezier and
bspline bases, degree 2/3, flat/ribbon/cylinder types (cylinder gets a
camera-independent tube tessellation).
"""

from __future__ import annotations

import numpy as np


def bezier_eval(cp, u):
    """cp [4,3], u [...] -> points [...,3] (de Casteljau, cubic)."""
    u = np.asarray(u)[..., None]
    a = cp[0] * (1 - u) + cp[1] * u
    b = cp[1] * (1 - u) + cp[2] * u
    c = cp[2] * (1 - u) + cp[3] * u
    d = a * (1 - u) + b * u
    e = b * (1 - u) + c * u
    return d * (1 - u) + e * u


def bezier_deriv(cp, u):
    u = np.asarray(u)[..., None]
    d0 = 3 * (cp[1] - cp[0])
    d1 = 3 * (cp[2] - cp[1])
    d2 = 3 * (cp[3] - cp[2])
    a = d0 * (1 - u) + d1 * u
    b = d1 * (1 - u) + d2 * u
    return a * (1 - u) + b * u


def bspline_to_bezier(cp):
    """Cubic uniform b-spline segment -> bezier control points."""
    cp = np.asarray(cp, np.float64)
    b0 = (cp[0] + 4 * cp[1] + cp[2]) / 6
    b1 = (4 * cp[1] + 2 * cp[2]) / 6
    b2 = (2 * cp[1] + 4 * cp[2]) / 6
    b3 = (cp[1] + 4 * cp[2] + cp[3]) / 6
    return np.stack([b0, b1, b2, b3])


def tessellate_curve(cp, width0, width1, curve_type="flat", n_segments=8,
                     n_sides=4, normal0=None):
    """Tessellate one cubic bezier segment into a triangle ribbon/tube.

    Returns (vertices [V,3], indices [F,3]).  Flat/ribbon: camera-facing
    is approximated by a fixed frame along the curve (exact for thin
    hair); cylinder: an n_sides tube.
    """
    cp = np.asarray(cp, np.float64).reshape(4, 3)
    u = np.linspace(0.0, 1.0, n_segments + 1)
    pts = bezier_eval(cp, u)              # [S+1,3]
    tang = bezier_deriv(cp, u)
    tang = tang / np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True),
                             1e-12)
    widths = (width0 * (1 - u) + width1 * u)[:, None]

    # frame transport: pick a stable normal and sweep it along the tangent
    if normal0 is None:
        ref = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(tang[0], ref)) > 0.95:
            ref = np.array([1.0, 0.0, 0.0])
    else:
        ref = np.asarray(normal0, np.float64)
    normals = []
    n = ref - np.dot(ref, tang[0]) * tang[0]
    n /= max(np.linalg.norm(n), 1e-12)
    for t in tang:
        n = n - np.dot(n, t) * t
        ln = np.linalg.norm(n)
        if ln < 1e-9:
            n = np.array([0.0, 0.0, 1.0]) - t[2] * t
            ln = max(np.linalg.norm(n), 1e-12)
        n = n / ln
        normals.append(n.copy())
    normals = np.asarray(normals)

    if curve_type in ("flat", "ribbon"):
        side = np.cross(tang, normals)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True),
                           1e-12)
        v0 = pts - 0.5 * widths * side
        v1 = pts + 0.5 * widths * side
        verts = np.concatenate([v0, v1], 0)
        # curve.cpp parameterization: u along the curve, v across the
        # width (v in [0,1]; hair shading maps h = -1 + 2v)
        uvs = np.concatenate(
            [np.stack([u, np.zeros_like(u)], -1),
             np.stack([u, np.ones_like(u)], -1)], 0)
        S = n_segments
        idx = []
        for i in range(S):
            a, b = i, i + 1
            c, d = i + S + 1, i + S + 2
            idx += [[a, b, c], [c, b, d]]
        return verts, np.asarray(idx, np.int64), uvs

    # cylinder tube
    binorm = np.cross(tang, normals)
    ring_angles = np.linspace(0, 2 * np.pi, n_sides, endpoint=False)
    verts = []
    for i, p in enumerate(pts):
        r = widths[i, 0] * 0.5
        for a in ring_angles:
            verts.append(p + r * (np.cos(a) * normals[i]
                                  + np.sin(a) * binorm[i]))
    verts = np.asarray(verts)
    uvs = np.stack([np.repeat(u, n_sides),
                    np.tile(ring_angles / (2 * np.pi), len(pts))], -1)
    idx = []
    for i in range(n_segments):
        for j in range(n_sides):
            a = i * n_sides + j
            b = i * n_sides + (j + 1) % n_sides
            c = a + n_sides
            d = b + n_sides
            idx += [[a, b, d], [a, d, c]]
    return verts, np.asarray(idx, np.int64), uvs


def curve_from_params(P, degree=3, basis="bezier", width0=1.0, width1=1.0,
                      curve_type="flat", n_segments=8, normal0=None):
    """Full curve directive -> (vertices, indices): handles multi-segment
    control polygons in bezier (4 + 3k cps) or bspline (sliding window)."""
    P = np.asarray(P, np.float64).reshape(-1, 3)
    if degree == 2:
        # elevate quadratic to cubic
        segs = []
        for s in range(0, len(P) - 2, 2):
            q = P[s:s + 3]
            segs.append(np.stack([q[0], (q[0] + 2 * q[1]) / 3,
                                  (2 * q[1] + q[2]) / 3, q[2]]))
    elif basis == "bspline":
        segs = [bspline_to_bezier(P[s:s + 4])
                for s in range(0, len(P) - 3)]
    else:
        segs = [P[s:s + 4] for s in range(0, len(P) - 3, 3)]
    all_v, all_i, all_uv = [], [], []
    off = 0
    n = max(len(segs), 1)
    for k, cp in enumerate(segs):
        w0 = width0 + (width1 - width0) * (k / n)
        w1 = width0 + (width1 - width0) * ((k + 1) / n)
        v, i, uv = tessellate_curve(cp, w0, w1, curve_type, n_segments,
                                    normal0=normal0)
        # global u spans the whole control polygon across segments
        uv = uv.copy()
        uv[:, 0] = (k + uv[:, 0]) / n
        all_v.append(v)
        all_i.append(i + off)
        all_uv.append(uv)
        off += len(v)
    return (np.concatenate(all_v, 0), np.concatenate(all_i, 0),
            np.concatenate(all_uv, 0))
