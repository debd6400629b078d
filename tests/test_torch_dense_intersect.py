"""The port's dense intersector (K1 and K2, plain versions on the CPU)
against pbrt_tpu's Pallas kernels in interpret mode and a numpy brute
force, on the triangle soup and rays of tests/test_dense_kernel.py.

Tolerances (those of test_dense_kernel.py): found agrees exactly except
at grazing hits (<= 0.1% of rays); relative t error < 5e-3, set by the
JAX kernel's bf16x2 split and lane bits in t's mantissa (the port's f32
t is held to 1e-4 against the f64 brute force); prim agrees on > 0.99 of
rays (near-equal t ties).  K1's chunk sets agree exactly; its near bound
within 1e-4 relative, the JAX list packing chunk ids into near's low
mantissa bits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.ops import pallas_intersect as jdense
from pbrt_tpu_torch.ops import dense_intersect as tdense
from test_dense_kernel import _brute, _rays, _run_dense, _soup
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

BIG = 3.0e38


def _port_inputs(v0, e1, e2, o, d, anyhit=None):
    tab = tdense.build_dense_tables(v0, e1, e2)
    r16 = tdense.ray_vectors(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tab["center"]),
        anyhit=None if anyhit is None else torch.from_numpy(anyhit))
    return tab, r16


def _port_run(v0, e1, e2, o, d, tmax, anyhit=None):
    tab, r16 = _port_inputs(v0, e1, e2, o, d, anyhit)
    t, prim = tdense.dense_intersect_loop(
        r16, torch.from_numpy(tmax), torch.from_numpy(tab["W"]),
        torch.from_numpy(tab["chunk_bounds"]),
        torch.ones(tab["W"].shape[0], dtype=torch.bool))
    return t.numpy(), prim.numpy()


@pytest.mark.parametrize("coherent,seeds", [(True, (0, 1)), (False, (3, 4))])
def test_k1_plain_matches_jax_queue(coherent, seeds):
    v0, e1, e2 = _soup(seed=seeds[0])
    o, d = _rays(seed=seeds[1], coherent=coherent)
    tmax = np.full(o.shape[0], BIG, np.float32)
    tmax[5::7] = -1.0                                  # some dead lanes
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    hits, near = tdense.tile_queue(r16, torch.from_numpy(tmax),
                                   torch.from_numpy(tab["chunk_bounds"]))
    jr16 = jdense.ray_vectors(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tab["center"]))
    T = jdense.RAY_TILE
    cl, na, nl = jdense._tile_chunk_lists(
        jr16.reshape(-1, T, 16), jnp.asarray(tmax).reshape(-1, T),
        jnp.asarray(tab["chunk_bounds"]), interpret=True)
    cl, na, nl = np.asarray(cl), np.asarray(na), np.asarray(nl)
    # a JAX tile is T // TILE port tiles: its chunk set is their union
    k = T // tdense.TILE
    h = hits.numpy().reshape(-1, k, hits.shape[1]).any(1)
    nr = near.numpy().reshape(-1, k, near.shape[1]).min(1)
    assert np.array_equal(h.sum(1), na)
    for b in range(na.shape[0]):
        act = cl[b, :na[b]]
        assert set(act.tolist()) == set(np.nonzero(h[b])[0].tolist())
        np.testing.assert_allclose(nl[b, :na[b]], nr[b, act], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("jax_tile", ["port", "ray_tile"])
@pytest.mark.parametrize("coherent,seeds", [(True, (0, 1)), (False, (3, 4))])
def test_chunk_lists_plain_match_jax_lists(coherent, seeds, jax_tile):
    """tile_chunk_lists_plain against the JAX package's _tile_chunk_lists
    in interpret mode: on JAX tiles of the port's TILE rays directly, and
    on its RAY_TILE rays against the union of RAY_TILE // TILE port tiles
    (chunk_lists_from_cull of the port cull's any and least near).  Equal
    n_active, the same active chunks, and the JAX order: the JAX sort
    keys each chunk by its near's bits with the chunk id in their low
    bits, so it orders exactly as the port's (near, id) order once the
    port's near is cut to the same bits; the JAX list's near equals the
    port's near so cut.  (Past n_active the JAX list repeats its last
    active chunk, the port's lists the missed chunks: not compared.)"""
    v0, e1, e2 = _soup(seed=seeds[0])
    o, d = _rays(seed=seeds[1], coherent=coherent)
    tmax = np.full(o.shape[0], BIG, np.float32)
    tmax[5::7] = -1.0                                  # some dead lanes
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    tm, cb = torch.from_numpy(tmax), torch.from_numpy(tab["chunk_bounds"])
    T = tdense.TILE if jax_tile == "port" else jdense.RAY_TILE
    jr16 = jdense.ray_vectors(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tab["center"]))
    cl_j, na_j, nl_j = (np.asarray(x) for x in jdense._tile_chunk_lists(
        jr16.reshape(-1, T, 16), jnp.asarray(tmax).reshape(-1, T),
        jnp.asarray(tab["chunk_bounds"]), interpret=True))
    hits, near = tdense.tile_queue_plain(r16, tm, cb)
    if jax_tile == "port":
        cl, na = tdense.tile_chunk_lists_plain(r16, tm, cb)
    else:
        k = T // tdense.TILE
        hits = hits.reshape(-1, k, hits.shape[1]).any(1)
        near = near.reshape(-1, k, near.shape[1]).amin(1)
        cl, na = tdense.chunk_lists_from_cull(hits, near)
    C = cb.shape[0]
    mask = ~((1 << ((C - 1).bit_length() or 1)) - 1)
    cut = ((near + 0.0).view(torch.int32) & mask).numpy()
    cl, na = cl.numpy(), na.numpy()
    assert np.array_equal(na, na_j) and na.sum() > 0
    for b in range(na.shape[0]):
        act = cl[b, :na[b]]
        assert np.array_equal(np.sort(act), np.nonzero(hits[b].numpy())[0])
        by_cut = act[np.lexsort((act, cut[b, act]))]
        assert np.array_equal(by_cut, cl_j[b, :na[b]])
        assert np.array_equal(nl_j[b, :na[b]].view(np.int32),
                              cut[b, by_cut])


def test_tile_chunk_lists_front_to_back():
    v0, e1, e2 = _soup(seed=0)
    o, d = _rays(seed=1, coherent=True)
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    tmax = torch.full((o.shape[0],), BIG)
    cb = torch.from_numpy(tab["chunk_bounds"])
    hits, near = tdense.tile_queue(r16, tmax, cb)
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    assert cl.dtype == torch.int32 and na.dtype == torch.int32
    for b in range(cl.shape[0]):
        act = cl[b, :na[b]].long()
        assert hits[b, act].all() and int(na[b]) == int(hits[b].sum())
        assert (near[b, act].diff() >= 0).all()


def _check_closest(t, prim, ref_t, ref_prim, tol):
    found = prim >= 0
    ref_found = ref_prim >= 0
    assert (found != ref_found).mean() <= 1e-3       # grazing hits only
    both = found & ref_found
    rel = np.abs(t[both] - ref_t[both]) / np.maximum(ref_t[both], 1e-6)
    assert rel.max() < tol, rel.max()
    assert (prim == ref_prim).mean() > 0.99


@pytest.mark.parametrize("coherent,seeds", [(True, (0, 1)), (False, (3, 4))])
def test_k2_closest_hit_matches_jax_and_brute(coherent, seeds):
    v0, e1, e2 = _soup(seed=seeds[0])
    o, d = _rays(seed=seeds[1], coherent=coherent)
    tmax = np.full(o.shape[0], BIG, np.float32)
    tb, pb = _brute(v0, e1, e2, o.astype(np.float64), d.astype(np.float64),
                    tmax)
    tj, pj = _run_dense(v0, e1, e2, o, d, tmax)
    t, prim = _port_run(v0, e1, e2, o, d, tmax)
    _check_closest(t, prim, tj, pj, 5e-3)
    _check_closest(t, prim, tb, pb, 1e-4)


def test_k2_anyhit_matches_jax_and_brute():
    """Any-hit lanes: found agrees, t parks at -1, and the reported prim
    is the first accept in the tile's chunk order (triangle order within
    a chunk).  The JAX kernel picks the nearest hit of its first group,
    so prims are not compared with it."""
    v0, e1, e2 = _soup(seed=5)
    o, d = _rays(n_rays=1024, seed=6, coherent=True)
    tmax = np.full(o.shape[0], BIG, np.float32)
    anyhit = np.ones(o.shape[0], bool)
    anyhit[::3] = False                                  # mixed lanes
    tb, pb = _brute(v0, e1, e2, o.astype(np.float64), d.astype(np.float64),
                    tmax)
    tj, pj = _run_dense(v0, e1, e2, o, d, tmax, anyhit=anyhit)
    t, prim = _port_run(v0, e1, e2, o, d, tmax, anyhit=anyhit)
    found = prim >= 0
    assert np.array_equal(found, pb >= 0)
    assert np.array_equal(found, pj >= 0)
    assert (t[found & anyhit] == -1.0).all()
    assert (prim[~anyhit] == pb[~anyhit]).mean() > 0.99
    # first accept in chunk-list order
    tab, r16 = _port_inputs(v0, e1, e2, o, d, anyhit)
    cl, na = tdense.tile_chunk_lists(r16, torch.from_numpy(tmax),
                                     torch.from_numpy(tab["chunk_bounds"]))
    chunk = tab["chunk"]
    rank = np.full((cl.shape[0], tab["W"].shape[0]), 10 ** 9)
    for b in range(cl.shape[0]):
        rank[b, cl[b, :na[b]].numpy()] = np.arange(int(na[b]))
    hit_any = _hit_matrix(v0, e1, e2, o, d)
    for i in np.nonzero(found & anyhit)[0]:
        tile = i // tdense.TILE
        cand = np.nonzero(hit_any[i])[0]
        key = rank[tile, cand // chunk] * chunk + cand % chunk
        assert prim[i] == cand[np.argmin(key)]


@pytest.mark.parametrize("coherent,seeds", [(True, (0, 1)), (False, (3, 4))])
def test_k2_t_within_f32_rounding_bound(coherent, seeds):
    """Every closest-hit lane's f32 t lies within the rounding bound of
    loop_t_reference (the bound chip_smoke.py and the card-only tests hold
    the CUDA kernel to), and a bf16 table would break it."""
    v0, e1, e2 = _soup(seed=seeds[0])
    o, d = _rays(seed=seeds[1], coherent=coherent)
    tmax = torch.full((o.shape[0],), BIG)
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    W = torch.from_numpy(tab["W"])
    cb = torch.from_numpy(tab["chunk_bounds"])
    t, prim = tdense.dense_intersect_loop(
        r16, tmax, W, cb, torch.ones(W.shape[0], dtype=torch.bool))
    hit = prim >= 0
    assert hit.float().mean() > 0.1
    t64, bound = tdense.loop_t_reference(r16[hit], W, prim[hit])
    assert torch.isfinite(bound).all() and (bound < 1e-3).all()
    assert ((t[hit].double() - t64).abs() <= bound * t64.abs()).all()
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    t16, p16 = tdense.loop_hits_plain(
        r16, tmax, W.bfloat16().float(), cl, na)
    same = hit & (p16 == prim)
    t64, bound = tdense.loop_t_reference(r16[same], W, prim[same])
    beyond = (t16[same].double() - t64).abs() > bound * t64.abs()
    assert beyond.double().mean() > 0.5


def _hit_matrix(v0, e1, e2, o, d):
    """[B,P] bool: ray i hits triangle p at t > 1e-4 (f64 Moller-Trumbore)."""
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    pvec = np.cross(d, e2[None])
    det = (e1[None] * pvec).sum(-1)
    inv = 1.0 / np.where(det == 0, 1, det)
    tvec = o - v0[None]
    b1 = (tvec * pvec).sum(-1) * inv
    qvec = np.cross(tvec, e1[None])
    b2 = (d * qvec).sum(-1) * inv
    t = (e2[None] * qvec).sum(-1) * inv
    return ((np.abs(det) > 1e-9) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
            & (t > 1e-4))


def test_k2_tmax_respected():
    """Hits beyond a lane's tmax are not reported; dead lanes never hit."""
    v0, e1, e2 = _soup(seed=7)
    o, d = _rays(n_rays=1024, seed=8, coherent=True)
    big = np.full(o.shape[0], BIG, np.float32)
    tb, pb = _brute(v0, e1, e2, o.astype(np.float64), d.astype(np.float64),
                    big)
    tmax = np.where(pb >= 0, tb * 0.5, 1e30).astype(np.float32)
    tmax[::4] = -1.0
    t, prim = _port_run(v0, e1, e2, o, d, tmax)
    assert (prim == -1).all()
    assert np.array_equal(t, tmax)


def test_dense_intersect_loop_pads_partial_tiles():
    v0, e1, e2 = _soup(seed=0)
    o, d = _rays(seed=1, coherent=True)
    tmax = np.full(o.shape[0], BIG, np.float32)
    t_full, p_full = _port_run(v0, e1, e2, o, d, tmax)
    n = 1000                                       # not a multiple of TILE
    t, p = _port_run(v0, e1, e2, o[:n], d[:n], tmax[:n])
    assert np.array_equal(p, p_full[:n]) and np.array_equal(t, t_full[:n])


def test_wrappers_take_plain_path_on_cpu_only():
    v0, e1, e2 = _soup(seed=0)
    o, d = _rays(n_rays=256, seed=1, coherent=True)
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    tmax = torch.full((256,), BIG)
    cb = torch.from_numpy(tab["chunk_bounds"])
    before = dict(tdense.LAUNCHES)
    tdense.tile_queue(r16, tmax, cb)
    assert tdense.LAUNCHES == before              # plain versions never count
    with pytest.raises(ValueError):
        tdense.tile_queue(r16.to("meta"), tmax, cb)


def test_loop_prim_tie_and_marginal_hits():
    """loop_prim_tie on a unit quad split along its diagonal (triangles 0
    and 1) and a copy of it one unit lower (2 and 3): a ray down through
    the diagonal is a tie of 0 and 1; one through the middle of 0 is not
    (1 is outside), nor is 0 against 2 under it (another t).
    loop_hit_marginal: a hit on the diagonal or at tmax may round either
    way, one well inside may not."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    tv = np.concatenate([v[tris], v[tris] - [0, 0, 1]])
    tab = tdense.build_dense_tables(tv[:, 0], tv[:, 1] - tv[:, 0],
                                    tv[:, 2] - tv[:, 0])
    o = torch.tensor([[0.5, 0.5, 1.0], [0.8, 0.2, 1.0], [0.8, 0.2, 1.0],
                      [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    r16 = tdense.ray_vectors(o, d, torch.from_numpy(tab["center"]))
    W = torch.from_numpy(tab["W"])
    tie = tdense.loop_prim_tie(r16, W, torch.tensor([0, 0, 0, 1]),
                               torch.tensor([1, 1, 2, 0]))
    assert tie.tolist() == [True, False, False, True]
    # marginal hits: through the diagonal, or at t = tmax (1 for the quad
    # from z = 1); not through the middle of triangle 0 well inside tmax
    marginal = tdense.loop_hit_marginal(
        r16, torch.tensor([5.0, 5.0, 1.0, 5.0]), W,
        torch.tensor([0, 0, 0, 2]))
    assert marginal.tolist() == [True, False, True, True]


def test_loop_prim_skipped_tells_a_graze_from_a_crack():
    """loop_prim_skipped: a unit quad at z = 0 (triangles 0, 1, split
    along x = y) over a larger quad at z = -1 (2, 3, split along
    x + y = 1), rays straight down.  A ray through x = 1, an edge of 0
    that no other triangle shares (a silhouette), may hit 0 or pass it
    and hit 3 below: explained either way round, no crack.  Through the
    diagonal both 0 and 1 are marginal at one t: returning 2 below
    passes between them, explained as a crack.  Through the middle of 0,
    or of 1 with 0 returned as the nearer answer, it is not explained:
    the triangle is hit whatever the rounding."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    big = np.array([[-1, -1, -1], [2, -1, -1], [2, 2, -1], [-1, 2, -1]],
                   np.float32)
    tv = np.concatenate([v[[[0, 1, 2], [0, 2, 3]]],
                         big[[[0, 1, 3], [1, 2, 3]]]])
    tab = tdense.build_dense_tables(tv[:, 0], tv[:, 1] - tv[:, 0],
                                    tv[:, 2] - tv[:, 0])
    o = torch.tensor([[1.0, 0.2, 1.0], [1.0, 0.2, 1.0], [0.3, 0.3, 1.0],
                      [0.8, 0.3, 1.0], [0.3, 0.6, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(5, 3)
    r16 = tdense.ray_vectors(o, d, torch.from_numpy(tab["center"]))
    W = torch.from_numpy(tab["W"])
    tmax = torch.full((5,), 5.0)
    a, b = torch.tensor([0, 3, 0, 0, 0]), torch.tensor([3, 0, 2, 3, 2])
    assert not tdense.loop_prim_tie(r16, W, a, b).any()
    explained, crack = tdense.loop_prim_skipped(r16, tmax, W, a, b, lanes=2)
    assert explained.tolist() == [True, True, True, False, False]
    assert crack.tolist() == [False, False, True, False, False]


def test_shared_edges_are_not_watertight_in_the_reference_either():
    """The dense formulation evaluates each triangle's sides on their own
    (per-triangle Pluecker columns, each at its own scale), so the two
    faces of a shared edge do not split a ray between them exactly: a ray
    through the edge may miss both.  Pinned here on 2,048 rays from one
    origin through points of the edge two tilted triangles share, a
    floor below: pbrt_tpu's K2 (interpret mode) and the port's plain K2
    each pass between the faces to the floor on some lanes, and
    loop_prim_skipped explains each of the port's such lanes, against
    either face, as a crack (ROADMAP Queue 3)."""
    rs = np.random.RandomState(7)
    p, q = np.array([-0.7, 0.1, 0.3]), np.array([0.8, -0.2, -0.1])
    a, b = np.array([0.1, 0.9, 0.2]), np.array([-0.2, -0.8, 0.4])
    floor = np.array([[-9, -9, -4], [9, -9, -4], [0, 9, -4]], np.float64)
    tv = np.stack([[p, q, a], [q, p, b], floor]).astype(np.float32)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    n = 2048
    s = rs.rand(n, 1) * 0.8 + 0.1
    tgt = p + s * (q - p)
    o = np.tile(np.array([[0.3, 0.4, 5.0]]), (n, 1))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    tmax = np.full(n, BIG, np.float32)
    _, jprim = _run_dense(v0, e1, e2, o, d, tmax)
    t, prim = _port_run(v0, e1, e2, o, d, tmax)
    assert set(np.unique(jprim)) <= {0, 1, 2} and (jprim == 2).any()
    assert set(np.unique(prim)) <= {0, 1, 2} and (prim == 2).any()
    tab, r16 = _port_inputs(v0, e1, e2, o, d)
    W = torch.from_numpy(tab["W"])
    through = np.nonzero(prim == 2)[0]
    for face in (0, 1):
        explained, crack = tdense.loop_prim_skipped(
            r16[through], torch.from_numpy(tmax[through]), W,
            torch.full((len(through),), face), torch.full((len(through),), 2))
        assert explained.all() and crack.all()
