"""Host-side BVH construction (port of pbrt_tpu.accel.bvh; reference:
src/accelerators/bvh.cpp).

The tree is flattened to a *threaded* BVH with eight per-octant link
tables: for each ray-direction sign octant the children of every interior
node are ordered near-to-far (the reference's dirIsNeg trick,
bvh.cpp:676), so a walk needs no stack:

    if box-hit:  leaf ? intersect prims, goto miss[oct,i] : goto hit[oct,i]
    else:        goto miss[oct,i]

from node 0 until the sentinel N.  ops/accel_walk.py walks it, one CUDA
thread per ray on the card.  Node geometry is packed into one [N, 8]
float32 row (lo, hi, leaf-bits, axis).

The dense route takes only the order of the leaves (triangles in leaf
order make each dense chunk spatially tight).  Everything here must equal
pbrt_tpu's bit for bit, so that scene arrays and prim ids compare one to
one: the same native SAH builder (a copy of pbrt_tpu/native/
bvh_builder.cc) for 512 or more primitives, the same numpy SAH builder
below it.  pbrt_tpu's "middle" and "equal" splits are not copied: its
scene build, as the port's, always asks for SAH.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BUCKETS = 12
#: traversal:intersection cost ratio used by the SAH (reference bvh.cpp:19)
TRAVERSAL_COST = 0.125
MAX_LEAF_SIZE = 4


@dataclass
class FlatBVH:
    """Octant-threaded flattened BVH (numpy).

    packed: [N, 8] float32: lo.xyz, hi.xyz, bitcast(leaf_bits), axis.
      leaf_bits = (prim_offset << 5) | prim_count for leaves, -1 interior.
    hit_links / miss_links: [8, N] int32 per-octant threading (sentinel N).
    prim_order: [P] new->old primitive permutation.
    """
    packed: np.ndarray
    hit_links: np.ndarray
    miss_links: np.ndarray
    prim_order: np.ndarray
    n_nodes: int
    max_leaf_size: int
    # unpacked views (bounds queries, tests)
    lo: np.ndarray = None
    hi: np.ndarray = None
    prim_offset: np.ndarray = None
    prim_count: np.ndarray = None


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "first", "count", "axis")

    def __init__(self):
        self.left = self.right = None
        self.first = self.count = 0
        self.axis = 0


def _from_packed(packed, hit, miss, order, max_leaf_size):
    leaf_bits = packed[:, 6].view(np.int32)
    return FlatBVH(
        packed=packed, hit_links=hit, miss_links=miss, prim_order=order,
        n_nodes=packed.shape[0], max_leaf_size=max_leaf_size,
        lo=packed[:, :3], hi=packed[:, 3:6],
        prim_offset=np.where(leaf_bits >= 0, leaf_bits >> 5, -1)
        .astype(np.int32),
        prim_count=np.where(leaf_bits >= 0, leaf_bits & 31, 0)
        .astype(np.int32))


def build_bvh(prim_lo, prim_hi, max_leaf_size=MAX_LEAF_SIZE):
    """Build a SAH BVH over primitive AABBs prim_lo / prim_hi [P,3].

    512 or more primitives take the native builder (native/bvh_builder.cc);
    a failed native build raises."""
    prim_lo = np.asarray(prim_lo, dtype=np.float64)
    prim_hi = np.asarray(prim_hi, dtype=np.float64)
    n = prim_lo.shape[0]
    if n >= 512:
        from pbrt_tpu_torch.native.build import build_bvh_native
        return _from_packed(*build_bvh_native(prim_lo, prim_hi,
                                              max_leaf_size), max_leaf_size)
    if n == 0:
        packed = np.zeros((1, 8), np.float32)
        packed[0, 3:6] = -np.inf
        packed[0, 6] = np.int32(0).view(np.float32)     # leaf, 0 prims
        return _from_packed(packed, np.full((8, 1), 1, np.int32),
                            np.full((8, 1), 1, np.int32),
                            np.zeros((0,), np.int32), max_leaf_size)
    centroids = 0.5 * (prim_lo + prim_hi)
    order = np.arange(n)

    root = _Node()
    stack = [(root, 0, n)]
    ordered = np.empty(n, dtype=np.int64)
    out_pos = 0

    while stack:
        node, lo_i, hi_i = stack.pop()
        idx = order[lo_i:hi_i]
        node.lo = prim_lo[idx].min(0)
        node.hi = prim_hi[idx].max(0)
        count = hi_i - lo_i
        if count <= max_leaf_size:
            node.first, node.count = out_pos, count
            ordered[out_pos:out_pos + count] = idx
            out_pos += count
            continue
        c = centroids[idx]
        c_lo, c_hi = c.min(0), c.max(0)
        dim = int(np.argmax(c_hi - c_lo))
        node.axis = dim
        if c_hi[dim] - c_lo[dim] < 1e-12:
            # every centre coincides: a leaf of up to 4 * max_leaf_size
            # prims, of which a walk tests the first max_leaf_size (as in
            # pbrt_tpu; ROADMAP Queue 3 (v))
            if count <= 4 * max_leaf_size:
                node.first, node.count = out_pos, count
                ordered[out_pos:out_pos + count] = idx
                out_pos += count
                continue
            mid = count // 2
        else:
            mid = _split(idx, c, dim, c_lo, c_hi, prim_lo, prim_hi, count,
                         max_leaf_size)
            if mid is None:
                node.first, node.count = out_pos, count
                ordered[out_pos:out_pos + count] = idx
                out_pos += count
                continue
        key = np.argsort(c[:, dim], kind="stable")
        order[lo_i:hi_i] = idx[key]
        node.left, node.right = _Node(), _Node()
        stack.append((node.right, lo_i + mid, hi_i))
        stack.append((node.left, lo_i, lo_i + mid))

    return _flatten(root, ordered, max_leaf_size)


def _flatten(root, ordered, max_leaf_size):
    """Number the nodes depth first (left first), pack them and thread
    each octant's links."""
    flat = []
    st = [root]
    while st:
        nd = st.pop()
        flat.append(nd)
        if nd.left is not None:
            st.append(nd.right)
            st.append(nd.left)
    index_of = {id(nd): i for i, nd in enumerate(flat)}
    N = len(flat)

    lo = np.stack([nd.lo for nd in flat]).astype(np.float32)
    hi = np.stack([nd.hi for nd in flat]).astype(np.float32)
    axis = np.array([nd.axis for nd in flat], np.int32)
    prim_offset = np.array(
        [nd.first if nd.left is None else -1 for nd in flat], np.int32)
    prim_count = np.array(
        [nd.count if nd.left is None else 0 for nd in flat], np.int32)
    leaf_bits = np.where(prim_offset >= 0,
                         (prim_offset << 5) | prim_count,
                         -1).astype(np.int32)

    packed = np.zeros((N, 8), np.float32)
    packed[:, :3] = lo
    packed[:, 3:6] = hi
    packed[:, 6] = leaf_bits.view(np.float32)
    packed[:, 7] = axis.astype(np.float32)

    # per-octant threading: order children near-first by dir sign on axis
    hit_links = np.full((8, N), N, np.int32)
    miss_links = np.full((8, N), N, np.int32)
    for octant in range(8):
        neg = [(octant >> k) & 1 for k in range(3)]  # dir sign per axis
        st = [(root, N)]
        while st:
            nd, after = st.pop()
            i = index_of[id(nd)]
            miss_links[octant, i] = after
            if nd.left is None:
                continue
            if neg[nd.axis]:
                first, second = nd.right, nd.left
            else:
                first, second = nd.left, nd.right
            hit_links[octant, i] = index_of[id(first)]
            st.append((second, after))
            st.append((first, index_of[id(second)]))

    return FlatBVH(packed=packed, hit_links=hit_links,
                   miss_links=miss_links,
                   prim_order=ordered.astype(np.int32),
                   n_nodes=N, max_leaf_size=max_leaf_size,
                   lo=lo, hi=hi, prim_offset=prim_offset,
                   prim_count=prim_count)


def _split(idx, c, dim, c_lo, c_hi, prim_lo, prim_hi, count, max_leaf_size):
    """Split position along the sorted-centroid order; None: a leaf."""
    if count <= 2:
        # the midpoint of the centroids' extent
        key = np.argsort(c[:, dim], kind="stable")
        mid_val = 0.5 * (c_lo[dim] + c_hi[dim])
        mid = int(np.searchsorted(c[key, dim], mid_val))
        if mid == 0 or mid == count:
            mid = count // 2
        return mid
    # binned SAH (reference bvh.cpp:236+)
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
    if count > max_leaf_size or cost[best] < float(count):
        if not np.isfinite(cost[best]):
            return count // 2
        mid = int((b <= best).sum())
        if mid == 0 or mid == count:
            return count // 2
        return mid
    return None
