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
hold where num/nd cancels.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import dense_intersect as dense

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
