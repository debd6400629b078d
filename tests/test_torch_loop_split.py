"""What K2's redesign rests on, on the CPU: a tile's chunk list split into
slices of G listed chunks, walked by S blocks (block b takes slices b,
b + S, ...), each block's lanes merged by the kernel's two key rules,
gives the unsplit result bit for bit; and the count of the ray-triangle
tests K2 needs, split by static and moving chunks.

The CUDA kernel (csrc/dense_loop.cu) merges the blocks of one tile by the
least key per lane: ((t bits) << 32 | prim) for closest-hit lanes (t > 0,
so its bits order as the float does) and (rank of the chunk in the
tile's list << 32 | prim) for any-hit lanes.  Here the plain version runs
once per block and the keys are merged the same way; the result must
equal the unsplit plain version exactly (no tolerance: both are minima
of orders that do not depend on the split).
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import dense_intersect as tdense
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

T = tdense.TILE
BIG = 3.0e38


def _soup(n_tris, seed, moving):
    """Triangles, 40 of them copied into the last chunk (exact ties on t),
    and, if `moving`, every third triangle of the first half moving.
    Returns v0, e1, e2, dmotion and the copied triangles' indices."""
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 4 - 2
    e1, e2 = rs.randn(2, n_tris, 3) * 0.8
    dup = rs.choice(n_tris // 2, 40, replace=False)
    for i, k in enumerate(dup):
        j = n_tris - 1 - i
        v0[j], e1[j], e2[j] = v0[k], e1[k], e2[k]
    dm = np.zeros((n_tris, 12))
    if moving:
        dm[:n_tris // 2:3, 0:3] = rs.randn(len(dm[:n_tris // 2:3]), 3) * 0.5
        dm[dup] = 0.0
    return v0, e1, e2, dm, dup


def _case(moving, seed=0, n_tris=1100, n_rays=1024):
    v0, e1, e2, dm, dup = _soup(n_tris, seed, moving)
    rs = np.random.RandomState(seed + 1)
    o = (rs.rand(n_rays, 3) * 10 - 5).astype(np.float32)
    d = (rs.rand(n_rays, 3) * 2 - 1 - o / 5).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tab = (tdense.build_dense_tables_motion(v0, e1, e2, dm) if moving
           else tdense.build_dense_tables(v0, e1, e2))
    anyhit = torch.zeros(n_rays, dtype=torch.bool)
    anyhit[1::2] = True
    r16 = tdense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tab["center"]), anyhit=anyhit)
    tmax = torch.full((n_rays,), BIG)
    tmax[::11] = -1.0
    W = torch.from_numpy(tab["W"])
    cl, na = tdense.tile_chunk_lists(r16, tmax,
                                     torch.from_numpy(tab["chunk_bounds"]))
    time = torch.from_numpy(rs.rand(n_rays).astype(np.float32)) \
        if moving else None
    return r16, tmax, time, W, cl, na, dict(tab, dup=dup)


def _merged(r16, tmax, time, W, cl, na, G, S=None):
    """_loop_plain per block of S (default: one per slice), each walking
    the tile's slices of G listed chunks b, b + S, ..., merged by the
    keys."""
    B = r16.shape[0]
    n_tiles, C = cl.shape
    chunk = W.shape[2] // (4 * (1 if time is None else tdense.N_COEF))
    anyhit = r16[:, 12] > 0.5
    rank_of = torch.empty((n_tiles, C), dtype=torch.int64)
    rank_of.scatter_(1, cl.long(), torch.arange(C).expand(n_tiles, C)
                     .contiguous())
    tile = torch.arange(B) // T
    none = torch.iinfo(torch.int64).max
    key = torch.full((B,), none, dtype=torch.int64)
    n_slices = -(-C // G)
    S = n_slices if S is None else S
    ranks = torch.arange(C)
    for b in range(S):
        # the block's ranks in walking order, then the rest
        mine = ((ranks // G) % S == b)
        order = torch.cat([ranks[mine], ranks[~mine]])
        cl_b = cl[:, order].contiguous()
        na_b = (mine[None, :] & (ranks[None, :] < na[:, None])).sum(
            1, dtype=torch.int32)
        t, p = tdense._loop_plain(r16, tmax, time, W, cl_b, na_b)
        hit = p >= 0
        pl = p.long().clamp(min=0)
        rank = rank_of[tile, pl // chunk]
        assert bool(((rank[hit] // G) % S == b).all())
        hi = torch.where(anyhit, rank,
                         t.view(torch.int32).long() & 0xffffffff)
        k = torch.where(hit, (hi << 32) | pl, none)
        key = torch.minimum(key, k)
    found = key != none
    prim = torch.where(found, key & 0xffffffff, -1).to(torch.int32)
    t_bits = (key >> 32).to(torch.int32)
    t = torch.where(found, torch.where(anyhit, -1.0, t_bits.view(
        torch.float32)), tmax)
    return t, prim, key


@pytest.mark.parametrize("moving", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("G", [1, 3, "C"])
def test_split_and_merge_equals_unsplit(moving, G):
    r16, tmax, time, W, cl, na, tab = _case(moving)
    C = cl.shape[1]
    G = C if G == "C" else G
    if time is None:
        ref = tdense.loop_hits_plain(r16, tmax, W, cl, na)
    else:
        ref = tdense.loop_hits_motion_plain(r16, tmax, time, W, cl, na)
    # one block per slice, and two blocks taking every other slice
    for S in (None, 2):
        t, p, key = _merged(r16, tmax, time, W, cl, na, G, S)
        assert torch.equal(p, ref[1]) and torch.equal(t, ref[0]), S
    # the case exercises what the merge must get right: any-hit lanes
    # that accept in several slices, closest-hit lanes whose best t ties
    anyhit = r16[:, 12] > 0.5
    n_slices_hit = torch.zeros_like(p, dtype=torch.int64)
    for s in range(-(-C // G)):
        na_s = (na - s * G).clamp(0, G).to(torch.int32)
        _, ps = tdense._loop_plain(r16, tmax, time, W,
                                   torch.roll(cl, -s * G, 1).contiguous(),
                                   na_s)
        n_slices_hit += ps >= 0
    if G < C:
        assert int((anyhit & (n_slices_hit > 1)).sum()) > 20
    closest = ~anyhit & (ref[1] >= 0)
    assert int(closest.sum()) > 100
    # ties: lanes whose winner has a copy in the last chunk, at the same
    # t bit for bit, report the original (the lower prim)
    tied = closest & torch.isin(ref[1], torch.from_numpy(tab["dup"]))
    assert int(tied.sum()) > 5


def _brute_counts(r16, tmax, prim, cl, na, chunk, static):
    n_st = n_mv = 0
    for lane in range(r16.shape[0]):
        if not tmax[lane] > 0:
            continue
        tile = lane // T
        hit_any = r16[lane, 12] > 0.5 and prim[lane] >= 0
        for k in range(int(na[tile])):
            c = int(cl[tile, k])
            if hit_any and c == int(prim[lane]) // chunk:
                n = int(prim[lane]) % chunk + 1
            else:
                n = chunk
            if static[c]:
                n_st += n
            else:
                n_mv += n
            if hit_any and c == int(prim[lane]) // chunk:
                break
    return n_st, n_mv


@pytest.mark.parametrize("moving", [False, True], ids=["static", "motion"])
def test_loop_test_counts_match_brute_force(moving):
    r16, tmax, time, W, cl, na, tab = _case(moving, seed=4, n_rays=512)
    if time is None:
        _, prim = tdense.loop_hits_plain(r16, tmax, W, cl, na)
        static = np.ones(W.shape[0], bool)
    else:
        _, prim = tdense.loop_hits_motion_plain(r16, tmax, time, W, cl, na)
        static = tab["chunk_static"]
        assert 0 < static.sum() < static.size
    got = tdense.loop_test_counts(r16, tmax, prim, cl, na, tab["chunk"],
                                  torch.from_numpy(static))
    want = _brute_counts(r16, tmax, prim, cl, na, tab["chunk"], static)
    assert got == want
    assert (got[1] > 0) == moving and got[0] > 0
