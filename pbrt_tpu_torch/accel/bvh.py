"""Host-side BVH construction (port of pbrt_tpu.accel.bvh).

The port intersects through the dense chunked kernels, so it needs only
the BVH's primitive order: triangles in leaf order make each chunk
spatially tight.  The order must equal `pbrt_tpu`'s so that scene arrays
and prim ids compare one to one, so the same two builders are used: the
native SAH builder (a copy of `pbrt_tpu/native/bvh_builder.cc`) for 512
or more primitives, the numpy binned SAH below it.
"""

from __future__ import annotations

import numpy as np

N_BUCKETS = 12
TRAVERSAL_COST = 0.125
MAX_LEAF_SIZE = 4


def build_bvh_order(prim_lo, prim_hi):
    """[P] new->old primitive permutation of the SAH BVH over [P,3] bounds
    (leaves of at most MAX_LEAF_SIZE prims)."""
    prim_lo = np.asarray(prim_lo, dtype=np.float64)
    prim_hi = np.asarray(prim_hi, dtype=np.float64)
    n = prim_lo.shape[0]
    if n >= 512:
        from pbrt_tpu_torch.native.build import build_bvh_native
        return build_bvh_native(prim_lo, prim_hi, MAX_LEAF_SIZE)
    centroids = 0.5 * (prim_lo + prim_hi)
    order = np.arange(n)
    ordered = np.empty(n, dtype=np.int64)
    out_pos = 0
    stack = [(0, n)]
    while stack:
        lo_i, hi_i = stack.pop()
        idx = order[lo_i:hi_i]
        count = hi_i - lo_i
        mid = None
        if count > MAX_LEAF_SIZE:
            c = centroids[idx]
            c_lo, c_hi = c.min(0), c.max(0)
            dim = int(np.argmax(c_hi - c_lo))
            if c_hi[dim] - c_lo[dim] >= 1e-12:
                mid = _sah_split(idx, c, dim, c_lo, c_hi, prim_lo, prim_hi)
            elif count > 4 * MAX_LEAF_SIZE:
                mid = count // 2
        if mid is None:
            ordered[out_pos:out_pos + count] = idx
            out_pos += count
            continue
        key = np.argsort(c[:, dim], kind="stable")
        order[lo_i:hi_i] = idx[key]
        stack.append((lo_i + mid, hi_i))
        stack.append((lo_i, lo_i + mid))
    return ordered.astype(np.int32)


def _sah_split(idx, c, dim, c_lo, c_hi, prim_lo, prim_hi):
    """Split position along the sorted centroids by binned SAH (reference
    bvh.cpp:236+), for a node above MAX_LEAF_SIZE prims."""
    count = len(idx)
    rel = (c[:, dim] - c_lo[dim]) / (c_hi[dim] - c_lo[dim])
    b = np.minimum((rel * N_BUCKETS).astype(np.int64), N_BUCKETS - 1)
    bucket_count = np.bincount(b, minlength=N_BUCKETS)
    b_lo = np.full((N_BUCKETS, 3), np.inf)
    b_hi = np.full((N_BUCKETS, 3), -np.inf)
    pl, ph = prim_lo[idx], prim_hi[idx]
    for k in range(3):
        np.minimum.at(b_lo[:, k], b, pl[:, k])
        np.maximum.at(b_hi[:, k], b, ph[:, k])

    def area(lo, hi):
        d = np.maximum(hi - lo, 0)
        return 2 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                    + d[..., 1] * d[..., 2])

    cost = np.empty(N_BUCKETS - 1)
    for k in range(N_BUCKETS - 1):
        n0 = bucket_count[:k + 1].sum()
        n1 = bucket_count[k + 1:].sum()
        if n0 == 0 or n1 == 0:
            cost[k] = np.inf
            continue
        lo0, hi0 = b_lo[:k + 1].min(0), b_hi[:k + 1].max(0)
        lo1, hi1 = b_lo[k + 1:].min(0), b_hi[k + 1:].max(0)
        cost[k] = TRAVERSAL_COST + (n0 * area(lo0, hi0)
                                    + n1 * area(lo1, hi1)) / max(
            area(np.minimum(lo0, lo1), np.maximum(hi0, hi1)), 1e-30)
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        return count // 2
    mid = int((b <= best).sum())
    return count // 2 if mid in (0, count) else mid
