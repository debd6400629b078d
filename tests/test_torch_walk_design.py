"""The walks' design, proven on the CPU against the plain walks
(csrc/accel_walk.cu; ops/accel_walk.py).

A kd-restart that replays its cached last descent: each descent restarts
from the root but reads a level's row from the lane's last descent while
it takes the same turns, and from the tree only past the first level
where it leaves that path.  The kd kernel does not keep such a cache (it
measured slower on the card: PERF.md section 6), but the design's claim
is proven here, as the count of rows it saves: a per-lane emulation of
kd-restart, in numpy f32 scalars with the cache's bookkeeping (the turn
bits, the cached depth, the level cap), is held to `kd_walk_plain` on
small trees: the same leaf sequence as the plain version's (read from its
leaf tests), the same t_entry / t_cell at every restart with the cache as
without, and (t, prim) equal to the plain version's bit for bit; its rows
read from the tree are those of each descent past its common prefix with
the one before, fewer than the node visits.  The rays are the edge cases
of `kernel_workloads.walk_edge_rays`: along split planes (the d_ax <= 0
tie), axis-parallel, from inside the root box, leaving a face (t_cell <=
0) and any-hit lanes with a quadric pre-hit.  The BVH's link table
decodes to the flat BVH's links for every node and octant, and the BVH
walk refuses an empty tree.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core.transform import translate
from pbrt_tpu_torch.ops import accel_walk
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.tools import kernel_workloads as kw
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

F = np.float32
CENTRE = (0.5, -0.5, 0.3)      # the scene's sphere, aimed at by any-hit rays


def _scene(moving, accel="kdtree", n=400, seed=11):
    """n random triangles in [-5, 5]^3 (a quarter of them moving) and a
    sphere, with both trees."""
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 3) * 10 - 5
    verts = base[:, None, :] + np.concatenate(
        [np.zeros((n, 1, 3)), rs.randn(n, 2, 3) * 0.5], 1)
    b = ir.SceneBuilder()
    m = b.add_material(ir.MaterialSpec())
    k = n // 4 if moving else 0
    b.add_triangle_mesh(verts[:n - k].reshape(-1, 3),
                        np.arange(3 * (n - k)).reshape(-1, 3), m)
    if k:
        b.add_triangle_mesh(verts[n - k:].reshape(-1, 3),
                            np.arange(3 * k).reshape(-1, 3), m,
                            object_to_world1=translate(0.3, -0.2, 0.1))
    b.add_sphere(translate(*CENTRE), 0.8, m)
    return b.build(device="cpu", accel=accel)


def _kd_args(s):
    """kd_walk's arguments for the edge-case rays on scene s."""
    o, d, tmax, time, anyhit = kw.walk_edge_rays(s, seed=4, n_random=160,
                                                 aim=[CENTRE])
    ray = geom.Ray.make(o, d, tmax=tmax, time=time)
    args = isect._walk_args(s, ray, anyhit)
    args.update(tmax=tmax, kd_packed=s.kd_packed, kd_prim_idx=s.kd_prim_idx,
                kd_bounds=s.kd_bounds, tri_packed=s.tri_packed,
                kd_max_leaf=s.kd_max_leaf)
    return args


def _leaf_lists(args):
    """The plain walk's leaf sequence: per lane, the list of each leaf it
    tested (read from its leaf tests), in order."""
    key = lambda o, d: o.numpy().tobytes() + d.numpy().tobytes()
    lane_of = {key(o, d): i for i, (o, d) in enumerate(zip(args["o"],
                                                          args["d"]))}
    seqs = [[] for _ in range(args["o"].shape[0])]
    inner = accel_walk._tests

    def record(o, d, pid, valid, *rest):
        for oo, dd, p, v in zip(o, d, pid, valid):
            seqs[lane_of[key(oo, dd)]].append(tuple(p[v].tolist()))
        return inner(o, d, pid, valid, *rest)

    accel_walk._tests = record
    try:
        t, p, counts = accel_walk.kd_walk_plain(counts=True, **args)
    finally:
        accel_walk._tests = inner
    return t, p, counts, seqs


def _emulate(args, start, lane, levels, cache=True):
    """One lane of kd_walk by a kd-restart that keeps `levels` levels of
    its last descent (the turn taken at each, and its row), level by level
    in numpy f32 scalars: (t, prim, trace), trace holding the leaf lists,
    (t_entry, t_cell) of each leaf, each descent's nodes, node visits,
    rows read from the tree and split-plane ties met.  cache=False reads
    every row from the tree (plain kd-restart, as the kernel does).
    start: the plain version's (t0g, t1g, live) of every lane."""
    kp = args["kd_packed"].numpy()
    ints = kp[:, 1:4].view(np.int32)
    Nk, M = kp.shape[0], args["kd_prim_idx"].shape[0]
    o, d = args["o"][lane].numpy(), args["d"][lane].numpy()
    inv = accel_walk.inv_direction(args["d"][lane:lane + 1])[0].numpy()
    t, prim = F(args["t_init"][lane]), int(args["prim_init"][lane])
    tr = dict(leaves=[], cells=[], descents=[], visits=0, loads=0,
              ties=0)
    t0g, t1g, live = (x[lane].item() for x in start)
    if not live:
        return t, prim, tr
    t0g, t1g = F(t0g), F(t1g)
    any_ = args["anyhit"] is not None and bool(args["anyhit"][lane])
    time = args.get("time")
    u = None if time is None else time[lane:lane + 1].clamp(0.0, 1.0)
    kk = torch.arange(args["kd_max_leaf"])
    path, turns, depth = [None] * levels, [False] * levels, 0
    t_entry, t_cell = t0g, t1g
    while True:
        node, level = 0, 0
        cached = cache and depth > 0

        def read(n):
            tr["loads"] += 1
            return (F(kp[n, 0]), *ints[n].tolist())

        row = path[0] if cached else read(0)
        path[0] = row
        nodes = [0]
        tr["visits"] += 1
        while row[1] != accel_walk.KD_LEAF:
            split, axis, above = row[0], row[1], row[2]
            p_at = o[axis] + t_entry * d[axis]
            tr["ties"] += int(p_at == split)
            below = bool(p_at < split or (p_at == split and d[axis] <= 0))
            t_split = (split - o[axis]) * inv[axis]
            if t_split > t_entry and t_split < t_cell:
                t_cell = min(t_cell, t_split)
            node = min(node + 1 if below else above, Nk - 1)
            if level < levels:
                cached = (cached and level + 1 < depth
                          and turns[level] == below)
                turns[level] = below
            level += 1
            row = path[level] if cached else read(node)
            if level < levels:
                path[level] = row
            nodes.append(node)
            tr["visits"] += 1
        tr["descents"].append(nodes)
        depth = min(level + 1, levels)
        off, cnt = row[2], row[3]
        entry = torch.clamp(off + kk, 0, M - 1)
        pid = args["kd_prim_idx"][entry].to(torch.int64)[None]
        valid = (kk < cnt)[None]
        tr["leaves"].append(tuple(pid[valid].tolist()))
        tr["cells"].append((t_entry, t_cell))
        upd, t_new, p_new = accel_walk._tests(
            args["o"][lane:lane + 1], args["d"][lane:lane + 1], pid, valid,
            torch.tensor([t]), args["tri_packed"], u, args.get("tri_motion"))
        if bool(upd[0]):
            t, prim = F(t_new[0]), int(p_new[0])
        adv = np.array([max(t_cell, F(0))], np.float32).view(np.int32) + 4
        adv = F(1e-30) if t_cell <= 0 else adv.view(np.float32)[0]
        if adv >= min(t, t1g) or (any_ and prim >= 0):
            return t, prim, tr
        t_entry, t_cell = adv, t1g


def _start(args):
    """The plain version's root segment (t0g, t1g, live) of every lane."""
    o, inv = args["o"], accel_walk.inv_direction(args["d"])
    ta = (args["kd_bounds"][0][None, :] - o) * inv
    tb = (args["kd_bounds"][1][None, :] - o) * inv
    t0g = torch.clamp(torch.amax(torch.minimum(ta, tb), -1), min=0.0)
    t1g = torch.amin(torch.maximum(ta, tb), -1)
    return t0g, t1g, (t0g <= t1g * 1.0001 + 1e-5) & (args["tmax"] > 0)


def _rows_read(descents, levels):
    """Rows a cached-path kd-restart keeping `levels` levels reads from the
    tree over these descents (node lists from the root): each descent's
    nodes past its common prefix with the one before (the same node at a
    level means the same turns above it), or past the kept levels."""
    n, prev = 0, []
    for nodes in descents:
        common = 0
        while (common < min(len(prev), len(nodes))
               and prev[common] == nodes[common]):
            common += 1
        n += len(nodes) - min(common, levels)
        prev = nodes
    return n


@pytest.mark.parametrize("levels", [36, 3], ids=["36_levels", "3_levels"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "motion"])
def test_cached_kd_restart_replays_the_plain_walk(moving, levels):
    """The cached-path replay visits the plain walk's leaves in its order
    with the same cell bounds and ends on its (t, prim) bit for bit; its
    rows read from the tree are each descent's past its common prefix with
    the last, fewer than the visits.  36 levels hold every descent of pbrt's
    depth limit round(8 + 1.3 log2 P) up to ~4M primitives; at 3 kept
    levels every deeper level is read from the tree."""
    s = _scene(moving)
    args = _kd_args(s)
    t_p, p_p, counts, seqs = _leaf_lists(args)
    start = _start(args)
    B = t_p.shape[0]
    loads = visits = ties = cell_le0 = 0
    for lane in range(B):
        t, prim, tr = _emulate(args, start, lane, levels)
        t0, prim0, tr0 = _emulate(args, start, lane, levels, cache=False)
        assert tr["leaves"] == seqs[lane] == tr0["leaves"], lane
        assert tr["cells"] == tr0["cells"], lane
        assert tr["descents"] == tr0["descents"], lane
        assert (t, prim) == (t0, prim0)
        assert np.float32(t).view(np.int32) == t_p[lane:lane + 1].numpy(
        ).view(np.int32)[0] and prim == int(p_p[lane]), lane
        assert tr["visits"] == int(counts.visits[lane]) == tr0["visits"]
        assert tr["loads"] == _rows_read(tr0["descents"], levels), lane
        assert tr0["loads"] == tr0["visits"]
        # at most `levels` rows of a descent come from the cache
        assert tr["loads"] >= tr["visits"] - levels * len(tr["leaves"])
        loads, visits = loads + tr["loads"], visits + tr["visits"]
        ties += tr["ties"]
        cell_le0 += sum(c <= 0 for _, c in tr["cells"])
    # every edge case was met
    assert ties > 0 and cell_le0 > 0
    anyhit, prim_init = args["anyhit"], args["prim_init"]
    pre = anyhit & (prim_init >= 0)
    assert bool(pre.any()) and (counts.tests[pre] <= s.kd_max_leaf).all()
    assert 0 < loads < visits


def test_rows_read_count_each_new_row_once():
    """_rows_read on hand-made descents 0-1-2, 0-1-5, 0-9 and 0-9-4-7:
    3 rows, then 1, 1 and 2; with 1 kept level every row below the root
    is read; with none, every row."""
    descents = [[0, 1, 2], [0, 1, 5], [0, 9], [0, 9, 4, 7]]
    assert _rows_read(descents, 36) == 3 + 1 + 1 + 2
    assert _rows_read(descents, 1) == 3 + 2 + 1 + 3
    assert _rows_read(descents, 0) == 3 + 3 + 2 + 4


@pytest.mark.parametrize("moving", [False, True], ids=["static", "motion"])
def test_bvh_links_decode_to_the_flat_bvh(moving):
    """scene.bvh_links (the BVH walk's table) holds, for every node and
    octant, the flat BVH's hit and miss links, and the plain walk reads
    them as pbrt_tpu's walk reads its two tables."""
    from pbrt_tpu_torch.accel.bvh import build_bvh
    s = _scene(moving, accel="bvh")
    L = s.bvh_links
    N = s.bvh_packed.shape[0]
    assert L.shape == (8, N, 2) and L.dtype == torch.int32
    assert L.is_contiguous()
    # a leaf's hit link is the sentinel; an interior node's is a child
    leaf = s.bvh_packed[:, 6].contiguous().view(torch.int32) >= 0
    assert bool((L[:, leaf, 0] == N).all())
    assert bool(((L[:, ~leaf, 0] > 0) & (L[:, ~leaf, 0] < N)).all())
    # the node after the root's subtree is the sentinel in every octant
    assert bool((L[:, 0, 1] == N).all())
    # a FlatBVH of random boxes, node by node and octant by octant
    rs = np.random.RandomState(2)
    lo = rs.uniform(-5, 5, (700, 3)).astype(np.float32)
    fb = build_bvh(lo, lo + rs.uniform(0, 1, (700, 3)).astype(np.float32))
    L = accel_walk.bvh_links(torch.as_tensor(fb.hit_links),
                             torch.as_tensor(fb.miss_links)).numpy()
    for octant in range(8):
        for n in range(fb.n_nodes):
            assert tuple(L[octant, n]) == (fb.hit_links[octant, n],
                                           fb.miss_links[octant, n])


def test_bvh_walk_refuses_an_empty_bvh():
    """A BVH of no nodes has no root row to read: bvh_walk raises on the
    CPU as it does on the card."""
    s = _scene(False, accel="bvh")
    o, d, tmax, _, _ = kw.walk_edge_rays(s, seed=4, n_random=8)
    ray = geom.Ray.make(o, d, tmax=tmax)
    args = isect._walk_args(s, ray, None)
    with pytest.raises(ValueError, match="empty"):
        accel_walk.bvh_walk(packed=s.bvh_packed[:0],
                            links=s.bvh_links[:, :0].contiguous(),
                            tri_packed=s.tri_packed, max_leaf=s.max_leaf,
                            **args)
