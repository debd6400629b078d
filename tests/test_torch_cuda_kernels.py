"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc, and skip without them.  The file
imports neither jax nor pbrt_tpu, so it also runs on a machine without
JAX (see README: "PyTorch/CUDA port").

Tolerances: K1's hits are identical (its predicate avoids FMA
contraction); its near bound agrees to 1e-6 relative.  K2 and its plain
version sum the same f32 products in different orders, so found agrees
on >= 0.9999 of lanes and prim on >= 0.999 (ties and edge grazes), and
on every closest-hit lane both t lie within the f32 rounding bound of
the exact t (`loop_t_reference`): a fixed bound between the two does not
hold where num/nd cancels.  K2 motion is held to the same agreement and
to the motion bound (`loop_t_reference_motion`), at 128-triangle chunks
(45 KB of shared memory) and at 256 (90 KB, above the 48 KB default).
K2's ablation modes: empty and stage equal their plain versions bit for
bit, sections lies within `sections_reference`'s f32 bound, and direct
and full equal production K2 bit for bit.  The tile dump's sections lie
and t within the f32 bounds of two evaluations (`tile_dump_bounds`) of
its plain version's, its accept flags differ only where two f32
evaluations may round a test either way (`dump_tile.unexplained_accepts`:
no such difference unexplained, at most a tenth of the accepted tests,
of which there are at least 16), and its last running (t, prim) equals
production K2's on the tile bit for bit; both at 128- and 256-triangle
chunks.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.tools import dump_tile

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from pbrt_tpu_torch.ops import cuda_kernels
    try:
        cuda_kernels._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _soup_and_rays(device, n_tris=600, n_rays=4096, seed=3):
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 10 - 5
    e1, e2 = rs.randn(2, n_tris, 3) * 0.5
    o = (rs.rand(n_rays, 3) * 14 - 7).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tab = dense.build_dense_tables(v0, e1, e2)
    anyhit = torch.zeros(n_rays, dtype=torch.bool)
    anyhit[1::2] = True
    r16 = dense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tab["center"]), anyhit=anyhit)
    tmax = torch.full((n_rays,), 3.0e38)
    tmax[::5] = -1.0
    return (r16.to(device), tmax.to(device),
            torch.from_numpy(tab["W"]).to(device),
            torch.from_numpy(tab["chunk_bounds"]).to(device))


def test_kernels_match_plain(device):
    r16, tmax, W, cb = _soup_and_rays(device)
    before = dict(dense.LAUNCHES)
    hits, near = dense.tile_queue(r16, tmax, cb)
    hits_p, near_p = dense.tile_queue_plain(r16, tmax, cb)
    assert torch.equal(hits, hits_p)
    torch.testing.assert_close(near[hits], near_p[hits], rtol=1e-6, atol=0)
    cl, na = dense.tile_chunk_lists(r16, tmax, cb)
    t, p = dense.loop_hits(r16, tmax, W, cl, na)
    tp, pp = dense.loop_hits_plain(r16, tmax, W, cl, na)
    torch.cuda.synchronize()
    assert ((p >= 0) == (pp >= 0)).float().mean() >= 0.9999
    assert (p == pp).float().mean() >= 0.999
    assert (p[tmax <= 0] == -1).all()
    closest = (r16[:, 12] < 0.5) & (p == pp) & (p >= 0)
    t64, bound = dense.loop_t_reference(r16[closest], W, p[closest])
    for tt in (t, tp):
        assert ((tt[closest].double() - t64).abs()
                <= bound * t64.abs()).all()
    assert dense.LAUNCHES["dense_queue"] == before["dense_queue"] + 2
    assert dense.LAUNCHES["dense_loop"] == before["dense_loop"] + 1


def test_wrappers_reject_bad_inputs(device):
    r16, tmax, W, cb = _soup_and_rays(device, n_rays=256)
    with pytest.raises(TypeError):
        dense.tile_queue(r16.double(), tmax, cb)
    with pytest.raises(ValueError):
        dense.tile_queue(r16[:200], tmax[:200], cb)     # not whole tiles
    with pytest.raises(ValueError):
        dense.tile_queue(r16, tmax.cpu(), cb)           # mixed devices


def _moving_soup_and_rays(device, chunk, n_tris=600, n_rays=4096, seed=4):
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 10 - 5
    e1, e2 = rs.randn(2, n_tris, 3) * 0.5
    dm = np.zeros((n_tris, 12))
    dm[1::2, 0:3] = rs.randn(n_tris // 2, 3)
    dm[1::2, 3:9] = rs.randn(n_tris // 2, 6) * 0.2
    o = (rs.rand(n_rays, 3) * 14 - 7).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    time = rs.rand(n_rays).astype(np.float32)
    tab = dense.build_dense_tables_motion(v0, e1, e2, dm, chunk=chunk)
    anyhit = torch.zeros(n_rays, dtype=torch.bool)
    anyhit[1::2] = True
    r16 = dense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tab["center"]), anyhit=anyhit)
    tmax = torch.full((n_rays,), 3.0e38)
    tmax[::5] = -1.0
    return (r16.to(device), tmax.to(device),
            torch.from_numpy(time).to(device),
            torch.from_numpy(tab["W"]).to(device),
            torch.from_numpy(tab["chunk_bounds"]).to(device))


@pytest.mark.parametrize("chunk", [128, 256])
def test_motion_kernel_matches_plain(device, chunk):
    r16, tmax, time, W, cb = _moving_soup_and_rays(device, chunk)
    before = dict(dense.LAUNCHES)
    cl, na = dense.tile_chunk_lists(r16, tmax, cb)
    t, p = dense.loop_hits_motion(r16, tmax, time, W, cl, na)
    tp, pp = dense.loop_hits_motion_plain(r16, tmax, time, W, cl, na)
    torch.cuda.synchronize()
    assert ((p >= 0) == (pp >= 0)).float().mean() >= 0.9999
    assert (p == pp).float().mean() >= 0.999
    assert (p[tmax <= 0] == -1).all()
    anyhit = r16[:, 12] > 0.5
    assert torch.equal((p >= 0)[anyhit], (pp >= 0)[anyhit])
    closest = ~anyhit & (p == pp) & (p >= 0)
    assert closest.sum() > 100
    t64, bound = dense.loop_t_reference_motion(r16[closest], time[closest],
                                               W, p[closest])
    for tt in (t, tp):
        assert ((tt[closest].double() - t64).abs()
                <= bound * t64.abs()).all()
    assert dense.LAUNCHES["dense_loop_motion"] == \
        before["dense_loop_motion"] + 1
    assert dense.LAUNCHES["dense_loop"] == before["dense_loop"]


def _static_case(device, chunk, n_tris=600, n_rays=2048, seed=5):
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 10 - 5
    e1, e2 = rs.randn(2, n_tris, 3) * 0.5
    o = (rs.rand(n_rays, 3) * 14 - 7).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tab = dense.build_dense_tables(v0, e1, e2, chunk=chunk)
    anyhit = torch.zeros(n_rays, dtype=torch.bool)
    anyhit[1::3] = True
    r16 = dense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tab["center"]),
                            anyhit=anyhit).to(device)
    tmax = torch.full((n_rays,), 3.0e38)
    tmax[::7] = -1.0
    tmax = tmax.to(device)
    W = torch.from_numpy(tab["W"]).to(device)
    cl, na = dense.tile_chunk_lists(
        r16, tmax, torch.from_numpy(tab["chunk_bounds"]).to(device))
    return r16, tmax, W, cl, na


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("mode", dense.ABLATE_MODES)
def test_ablation_mode_matches_plain(device, chunk, mode):
    r16, tmax, W, cl, na = _static_case(device, chunk)
    key = dense.ablate_kernel(mode)
    before = dense.LAUNCHES[key]
    t, p = dense.loop_hits_ablate(mode, r16, tmax, W, cl, na)
    assert dense.LAUNCHES[key] == before + 1
    tp, pp = dense.loop_hits_ablate_plain(mode, r16, tmax, W, cl, na)
    torch.cuda.synchronize()
    if mode in ("empty", "stage"):
        assert torch.equal(t, tp) and torch.equal(p, pp)
    elif mode == "sections":
        assert torch.equal(p, pp)
        exact, bound = dense.sections_reference(r16, tmax, W, cl, na)
        live = torch.isfinite(exact)
        assert live.sum() > 1000 and torch.equal(torch.isfinite(t), live)
        for x in (t, tp):
            assert ((x[live].double() - exact[live]).abs()
                    <= bound[live]).all()
    else:
        t2, p2 = dense.loop_hits(r16, tmax, W, cl, na)
        assert torch.equal(t, t2) and torch.equal(p, p2)


@pytest.mark.parametrize("chunk", [128, 256])
def test_tile_dump_matches_plain_and_k2(device, chunk):
    r16, tmax, W, cl, na = _static_case(device, chunk)
    t2, p2 = dense.loop_hits(r16, tmax, W, cl, na)
    T = dense.TILE
    for tile in (0, 5):
        picks = cl[tile, :int(na[tile])].contiguous()
        rt, tt = r16[tile * T:(tile + 1) * T], tmax[tile * T:(tile + 1) * T]
        got = dense.tile_dump(r16, tmax, W, picks, tile)
        ref = dense.tile_dump_plain(rt, tt, W, picks)
        torch.cuda.synchronize()
        bound, t_rel = dense.tile_dump_bounds(rt, W, picks)
        assert ((got["sections"] - ref["sections"]).abs().double()
                <= bound).all()
        gap = (got["t"] - ref["t"]).abs().double() / ref["t"].abs().double()
        finite = torch.isfinite(gap)
        assert (gap[finite] <= t_rel[finite]).all()
        differ, unexplained = dump_tile.unexplained_accepts(
            got, ref, tt, rt[:, 12] > 0.5, bound, t_rel)
        n_accepted = int(ref["accepted"].sum())
        assert n_accepted >= 16 and not unexplained.any()
        assert int(differ.sum()) <= n_accepted // 10
        assert torch.equal(got["best_t"][-1], t2[tile * T:(tile + 1) * T])
        assert torch.equal(got["best_prim"][-1], p2[tile * T:(tile + 1) * T])
