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
        torch.from_numpy(tab["chunk_bounds"]))
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
    t, prim = tdense.dense_intersect_loop(r16, tmax, W, cb)
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
