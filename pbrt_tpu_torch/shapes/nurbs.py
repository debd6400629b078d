"""NURBS surface tessellation (port of pbrt_tpu.shapes.nurbs;
reference: src/shapes/nurbs.cpp).

The reference tessellates NURBS at creation into a triangle mesh
(nurbs.cpp `CreateNURBS`, evaluated on a (nu*5)x(nv*5)-ish grid of the
knot domain).  We do the same at scene-compile time with a Cox-de Boor
basis evaluation in numpy; the resulting mesh rides the normal
triangle path, so the accelerator never sees a special shape type.
"""
from __future__ import annotations

import numpy as np


def _basis_functions(u, order, knots):
    """Cox-de Boor: value of every order-`order` B-spline basis at
    scalar parameters `u` [M].  Returns [M, n_ctrl] with
    n_ctrl = len(knots) - order."""
    knots = np.asarray(knots, np.float64)
    u = np.asarray(u, np.float64)
    n_ctrl = len(knots) - order
    # degree-0 (piecewise-constant) seed: u in [k_i, k_{i+1})
    n0 = len(knots) - 1
    B = ((u[:, None] >= knots[None, :-1])
         & (u[:, None] < knots[None, 1:])).astype(np.float64)
    # make the domain end inclusive so u == u1 lands in the last span
    last = np.searchsorted(knots, u, side="left") - 1
    at_end = u >= knots[-order - 1]
    if at_end.any():
        B[at_end] = 0.0
        # last non-empty span index
        spans = np.nonzero(np.diff(knots) > 0)[0]
        B[at_end, spans[-1]] = 1.0
    for deg in range(1, order):
        nb = n0 - deg
        newB = np.zeros((len(u), nb))
        for i in range(nb):
            d1 = knots[i + deg] - knots[i]
            d2 = knots[i + deg + 1] - knots[i + 1]
            t1 = ((u - knots[i]) / d1)[:, None] if d1 > 0 else 0.0
            t2 = ((knots[i + deg + 1] - u) / d2)[:, None] if d2 > 0 else 0.0
            acc = np.zeros((len(u), 1))
            if d1 > 0:
                acc = acc + t1 * B[:, i:i + 1]
            if d2 > 0:
                acc = acc + t2 * B[:, i + 1:i + 2]
            newB[:, i:i + 1] = acc
        B = newB
    return B[:, :n_ctrl]


def evaluate_nurbs(uu, vv, nu, nv, uorder, vorder, uknots, vknots, Pw):
    """Evaluate surface points at the (uu x vv) parameter grid.
    Pw: [nv, nu, 4] homogeneous control points (w=1 for plain P)."""
    Bu = _basis_functions(uu, uorder, uknots)          # [U, nu]
    Bv = _basis_functions(vv, vorder, vknots)          # [V, nv]
    # S(u,v) = sum_ij Bu_i Bv_j Pw_ji  -> [V, U, 4]
    S = np.einsum("vj,ui,jik->vuk", Bv, Bu, Pw)
    w = np.where(np.abs(S[..., 3:]) > 1e-12, S[..., 3:], 1.0)
    return S[..., :3] / w


def tessellate_nurbs(nu, nv, uorder, vorder, uknots, vknots,
                     u0, u1, v0, v1, P=None, Pw=None, dice=5):
    """nurbs.cpp-style dicing: evaluate on a regular (dice*nu x dice*nv)
    grid over [u0,u1]x[v0,v1]; return (verts [N,3], tris [T,3],
    uvs [N,2])."""
    if Pw is None:
        P = np.asarray(P, np.float64).reshape(nv, nu, 3)
        Pw = np.concatenate([P, np.ones_like(P[..., :1])], -1)
    else:
        Pw = np.asarray(Pw, np.float64).reshape(nv, nu, 4)
        # pbrt stores rational points as (wx, wy, wz, w) already
    U = max(2, dice * nu)
    V = max(2, dice * nv)
    uu = np.linspace(u0, u1, U)
    vv = np.linspace(v0, v1, V)
    pts = evaluate_nurbs(uu, vv, nu, nv, uorder, vorder, uknots, vknots,
                         Pw)                            # [V, U, 3]
    verts = pts.reshape(-1, 3).astype(np.float32)
    us, vs = np.meshgrid((uu - u0) / max(u1 - u0, 1e-12),
                         (vv - v0) / max(v1 - v0, 1e-12))
    uvs = np.stack([us, vs], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(V - 1):
        for i in range(U - 1):
            a = j * U + i
            idx.append([a, a + 1, a + U + 1])
            idx.append([a, a + U + 1, a + U])
    return verts, np.asarray(idx, np.int32), uvs


def tessellate_hyperboloid(p1, p2, phimax, nu=64, nv=16):
    """Hyperboloid of revolution swept by the segment p1->p2 rotated
    phimax around z (shapes/hyperboloid.cpp parameterization:
    pr = lerp(p1, p2, v) rotated by phi = u*phimax)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    u = np.linspace(0.0, 1.0, nu)
    v = np.linspace(0.0, 1.0, nv)
    phi = u * phimax
    pr = p1[None, :] * (1 - v[:, None]) + p2[None, :] * v[:, None]  # [nv,3]
    x = pr[:, None, 0] * np.cos(phi)[None, :] \
        - pr[:, None, 1] * np.sin(phi)[None, :]
    y = pr[:, None, 0] * np.sin(phi)[None, :] \
        + pr[:, None, 1] * np.cos(phi)[None, :]
    z = np.broadcast_to(pr[:, None, 2], x.shape)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    idx = []
    for j in range(nv - 1):
        for i in range(nu - 1):
            a = j * nu + i
            idx.append([a, a + 1, a + nu + 1])
            idx.append([a, a + nu + 1, a + nu])
    return verts, np.asarray(idx, np.int32)
