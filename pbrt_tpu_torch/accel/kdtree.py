"""SAH kd-tree accelerator (port of pbrt_tpu.accel.kdtree; reference:
src/accelerators/kdtreeaccel.cpp).

Host-side build with pbrt's exact split policy: exhaustive SAH over
sorted bound edges, empty-space bonus, axis retries, badRefines budget,
primitive DUPLICATION across straddled splits, max depth 8 + 1.3*log2(N),
flattened to arrays; built in C++ (native/kdtree_builder.cc).  The
walk (ops/accel_walk.py `kd_walk`, one CUDA thread per ray on the card)
is KD-RESTART: instead of the reference's per-ray KdToDo stack
(kdtreeaccel.cpp:415) each ray keeps its current (t_entry, cell t_exit)
and restarts the descent from the root after each leaf, advancing
t_entry past the cell.

Selected by `Accelerator "kdtree"` for a scene over the dense cap; its
hits equal the BVH's but where the BVH's large leaves skip primitives
(ROADMAP Queue 3 (v)).  The build equals pbrt_tpu's array for array.
"""

from __future__ import annotations

import numpy as np

# node int row layout: [flags(axis or 3=leaf), above_child|prim_offset,
#                       n_prims]; float row: split position
KD_LEAF = 3


def build_kdtree(lo, hi, isect_cost=80, traversal_cost=1,
                 empty_bonus=0.5, max_prims=1, max_depth=0):
    """lo/hi [P,3] primitive bounds -> flattened kd arrays.

    Returns dict(nodes_f [N] f32 split, nodes_i [N,3] int32,
    prim_idx [M] int32 (duplicated), bounds [2,3], max_leaf).  The build
    runs in C++ (native/kdtree_builder.cc; a failed native build raises),
    pbrt_tpu's numpy build repeated in its order, equal to it array for
    array (the tests hold it to pbrt_tpu's).
    """
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    P = lo.shape[0]
    if P == 0:
        return dict(nodes_f=np.zeros(1, np.float32),
                    nodes_i=np.asarray([[KD_LEAF, 0, 0]], np.int32),
                    prim_idx=np.zeros(0, np.int32),
                    bounds=np.zeros((2, 3), np.float32))
    if max_depth <= 0:
        max_depth = int(round(8 + 1.3 * np.log2(max(P, 1))))
    from pbrt_tpu_torch.native.build import build_kdtree_native
    nodes_f, ni, prim_idx = build_kdtree_native(
        lo, hi, max_depth, max_prims, isect_cost, traversal_cost,
        empty_bonus)
    return dict(nodes_f=nodes_f, nodes_i=ni, prim_idx=prim_idx,
                bounds=np.stack([lo.min(0), hi.max(0)]).astype(np.float32),
                max_leaf=int(ni[ni[:, 0] == KD_LEAF, 2].max(initial=1)))
