"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc, and skip without them.  The file
imports neither jax nor pbrt_tpu, so it also runs on a machine without
JAX (see README: "PyTorch/CUDA port").

Tolerances: K1's chunk lists (its kList instantiation, the one launch
of `tile_chunk_lists`) equal the plain version's bit for bit, on a
soup, on kernel_workloads' edge cases (equal and signed-zero entry t,
dead and all-miss tiles, C = 1, 48 and 576) and on the cluster mesh's
z40 rays; K1's cull alone (kCull, `tile_queue`) gives identical hits
(its predicate avoids FMA contraction) and near within 1e-6 relative;
and `dense_intersect_loop`, static and motion, equals K2 on the plain
lists bit for bit.  K2 and its plain
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

The redesign (four triangles a step, the division only for inside tests,
lists split across blocks, asynchronous staging, static chunks of the
motion table on the static body) is held bit for bit where it must be:
K2 split into slices of G listed chunks equals K2 in one block per tile
(G >= C) for every G, in every mode, with any-hit lanes that hit in
several slices; K2 motion on a motion table with no moving triangle
equals static K2, whether or not it is told which chunks are static, and
K2 motion with and without `chunk_static` are equal on a mixed table.
Lists with one tile of all C chunks and one of a single chunk, and
static K2 at 1024-triangle chunks (180 KB of shared memory for two
stages), are held to the plain versions by the contract above.  So are
the shapes cell's batches (319 chunks of 512 triangles; K1's bitonic
sort), with ties at shared edges allowed as on the matched-RNG batches
and one lane a batch of another triangle where rounding explains it
(dense.loop_prim_skipped), and the BSSRDF probe passes' batches of the
skin scene (mostly dead lanes, finite tmax), with two such lanes, and
the light-side integrators' batches on scenes/cornell_bench.pbrt: a bdpt
pass's rays leaving the light, its (2,2) and (2,1) connections (any-hit
between surface points and toward the camera, finite tmax, dead lanes)
and an SPPM iteration's first photons, with two such lanes.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.tools import dump_tile
from pbrt_tpu_torch.tools import kernel_workloads

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
    assert dense.LAUNCHES["dense_queue_cull"] == \
        before["dense_queue_cull"] + 1
    assert dense.LAUNCHES["dense_queue"] == before["dense_queue"] + 1
    assert dense.LAUNCHES["dense_loop"] == before["dense_loop"] + 1


@pytest.mark.parametrize("fn", [dense.tile_queue, dense.tile_chunk_lists])
def test_wrappers_reject_bad_inputs(device, fn):
    r16, tmax, W, cb = _soup_and_rays(device, n_rays=256)
    before = dict(dense.LAUNCHES)
    with pytest.raises(TypeError):
        fn(r16.double(), tmax, cb)
    with pytest.raises(TypeError):
        fn(r16, tmax, cb.half())
    with pytest.raises(ValueError):
        fn(r16[:200], tmax[:200], cb)                   # not whole tiles
    with pytest.raises(ValueError):
        fn(r16, tmax[:128], cb)                         # shapes disagree
    with pytest.raises(ValueError):
        fn(r16, tmax, cb[:, :6].contiguous())           # not [C, 8]
    with pytest.raises(ValueError):
        fn(r16, tmax.cpu(), cb)                         # mixed devices
    with pytest.raises(ValueError):                     # C > MAX_CHUNKS
        fn(r16, tmax, cb[:1].expand(dense.MAX_CHUNKS + 1, 8).contiguous())
    with pytest.raises(ValueError):                     # not 16-byte aligned
        fn(r16, tmax, torch.zeros(cb.numel() + 1, device=device)[1:]
           .view(cb.shape))
    assert dense.LAUNCHES == before


def _queue_case(device, name):
    if name == "soup":
        r16, tmax, _, cb = _soup_and_rays(device)
        return r16, tmax, cb
    if name == "z40":
        wl = kernel_workloads.cluster_rays_z40(device)
        return wl.r16, wl.tmax, wl.chunk_bounds
    return kernel_workloads.queue_cases(device)[name]


@pytest.mark.parametrize("name", ["soup", "ties", "signed_zero",
                                  "dead_miss", "C1", "C48", "C576", "z40"])
def test_k1_lists_and_cull_equal_plain(device, name):
    r16, tmax, cb = _queue_case(device, name)
    before = dict(dense.LAUNCHES)
    cl, na = dense.tile_chunk_lists(r16, tmax, cb)
    assert dense.LAUNCHES["dense_queue"] == before["dense_queue"] + 1
    hits, near = dense.tile_queue(r16, tmax, cb)
    assert dense.LAUNCHES["dense_queue_cull"] == \
        before["dense_queue_cull"] + 1
    cl_p, na_p = dense.tile_chunk_lists_plain(r16, tmax, cb)
    hits_p, near_p = dense.tile_queue_plain(r16, tmax, cb)
    torch.cuda.synchronize()
    assert torch.equal(cl, cl_p) and torch.equal(na, na_p)
    assert torch.equal(hits, hits_p)
    torch.testing.assert_close(near[hits], near_p[hits], rtol=1e-6, atol=0)
    assert (near[~hits] == dense.F32_MAX).all()
    if name == "dead_miss":
        assert na.tolist() == [6, 0, 0]
        assert torch.equal(cl[1:].cpu(), torch.arange(8, dtype=torch.int32)
                           .expand(2, 8))


def test_dense_intersect_loop_equals_k2_on_plain_lists(device):
    """The main path's intersect (K1's one launch, then K2) gives, static
    and motion, what K2 gives on the plain version's lists, bit for
    bit."""
    r16, tmax, W, cb = _soup_and_rays(device)
    static = torch.ones(W.shape[0], dtype=torch.bool, device=device)
    t, p = dense.dense_intersect_loop(r16, tmax, W, cb, static)
    cl, na = dense.tile_chunk_lists_plain(r16, tmax, cb)
    t_p, p_p = dense.loop_hits(r16, tmax, W, cl, na)
    assert torch.equal(t, t_p) and torch.equal(p, p_p)
    assert (p >= 0).sum() > 100
    r16, tmax, time, W, cb, static = _moving_soup_and_rays(device, 128)
    t, p = dense.dense_intersect_loop(r16, tmax, W, cb, static, time=time)
    cl, na = dense.tile_chunk_lists_plain(r16, tmax, cb)
    t_p, p_p = dense.loop_hits_motion(r16, tmax, time, W, cl, na, static)
    assert torch.equal(t, t_p) and torch.equal(p, p_p)
    assert (p >= 0).sum() > 100


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
            torch.from_numpy(tab["chunk_bounds"]).to(device),
            torch.from_numpy(tab["chunk_static"]).to(device))


@pytest.mark.parametrize("chunk", [128, 256])
def test_motion_kernel_matches_plain(device, chunk):
    r16, tmax, time, W, cb, static = _moving_soup_and_rays(device, chunk)
    before = dict(dense.LAUNCHES)
    cl, na = dense.tile_chunk_lists(r16, tmax, cb)
    t, p = dense.loop_hits_motion(r16, tmax, time, W, cl, na, static)
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


def _contract(t, p, tp, pp, r16, W, motion_time=None):
    assert ((p >= 0) == (pp >= 0)).float().mean() >= 0.9999
    assert (p == pp).float().mean() >= 0.999
    anyhit = r16[:, 12] > 0.5
    closest = ~anyhit & (p == pp) & (p >= 0)
    assert closest.sum() > 50
    if motion_time is None:
        t64, bound = dense.loop_t_reference(r16[closest], W, p[closest])
    else:
        t64, bound = dense.loop_t_reference_motion(
            r16[closest], motion_time[closest], W, p[closest])
    for tt in (t, tp):
        assert ((tt[closest].double() - t64).abs()
                <= bound * t64.abs()).all()


def _mixed_case(device, n_tris=2600, n_rays=4096, seed=7, chunk=None):
    """A soup of n_tris triangles in C > LOOP_SLICE chunks (the lists are
    split across blocks), odd triangles of the first third moving; rays
    from inside, every other any-hit, every seventh dead."""
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 10 - 5
    e1, e2 = rs.randn(2, n_tris, 3) * 0.6
    dm = np.zeros((n_tris, 12))
    dm[1:n_tris // 3:2, 0:3] = rs.randn(len(dm[1:n_tris // 3:2]), 3) * 0.4
    o = (rs.rand(n_rays, 3) * 8 - 4).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    order = np.argsort(np.floor(o[:, 0]) * 64 + np.floor(o[:, 1]) * 8
                       + np.sign(d[:, 2]), kind="stable")
    o, d = o[order], d[order]
    tabs = {"static": dense.build_dense_tables(v0, e1, e2, chunk=chunk),
            "motion": dense.build_dense_tables_motion(v0, e1, e2, dm,
                                                      chunk=chunk),
            "still": dense.build_dense_tables_motion(
                v0, e1, e2, np.zeros_like(dm), chunk=chunk)}
    anyhit = torch.zeros(n_rays, dtype=torch.bool)
    anyhit[1::2] = True
    r16 = dense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tabs["static"]["center"]),
                            anyhit=anyhit).to(device)
    tmax = torch.full((n_rays,), 3.0e38)
    tmax[::7] = -1.0
    tmax = tmax.to(device)
    time = torch.from_numpy(rs.rand(n_rays).astype(np.float32)).to(device)
    out = {}
    for k, tab in tabs.items():
        cb = torch.from_numpy(tab["chunk_bounds"]).to(device)
        cl, na = dense.tile_chunk_lists(r16, tmax, cb)
        out[k] = dict(W=torch.from_numpy(tab["W"]).to(device), cl=cl, na=na,
                      static=torch.from_numpy(tab.get(
                          "chunk_static", np.ones(cb.shape[0], bool)))
                      .to(device))
    return r16, tmax, time, out


def _run(case, r16, tmax, time, blocks=None, mode=None,
         chunk_static=True):
    """A loop kernel on `case` with `blocks` blocks per tile (default
    dense.loop_blocks); K2 motion told the case's static chunks, or (not
    chunk_static) none."""
    if time is None:
        name = "dense_loop" if mode is None else dense.ablate_kernel(mode)
        return dense._launch_loop(name, r16, tmax, None, case["W"],
                                  case["cl"], case["na"], mode=mode,
                                  blocks=blocks)
    return dense._launch_loop(
        "dense_loop_motion", r16, tmax, time, case["W"], case["cl"],
        case["na"],
        chunk_static=(case["static"] if chunk_static
                      else torch.zeros_like(case["static"])),
        blocks=blocks)


def test_split_lists_equal_one_block_per_tile(device):
    r16, tmax, time, cases = _mixed_case(device)
    C = cases["static"]["W"].shape[0]
    S = dense.loop_blocks(C)
    assert S > 3 and int(cases["static"]["na"].max()) > 8
    anyhit = r16[:, 12] > 0.5
    for kind, tm in (("static", None), ("motion", time)):
        case = cases[kind]
        whole = _run(case, r16, tmax, tm, blocks=1)
        # any-hit lanes that hit in more than one slice of 1 chunk
        per = torch.zeros(r16.shape[0], dtype=torch.int64, device=device)
        for k in range(int(case["na"].max())):
            one = dict(case, cl=torch.roll(case["cl"], -k, 1).contiguous(),
                       na=(case["na"] - k).clamp(0, 1).to(torch.int32))
            per += _run(one, r16, tmax, tm, blocks=1)[1] >= 0
        assert int((anyhit & (per > 1)).sum()) > 20, kind
        # blocks walking 1, several or every S-th slice of LOOP_SLICE
        for blocks in (2, 3, S):
            got = _run(case, r16, tmax, tm, blocks=blocks)
            torch.cuda.synchronize()
            assert torch.equal(got[0], whole[0]), (kind, blocks)
            assert torch.equal(got[1], whole[1]), (kind, blocks)
        plain = (dense.loop_hits_plain(r16, tmax, case["W"], case["cl"],
                                       case["na"]) if tm is None else
                 dense.loop_hits_motion_plain(r16, tmax, tm, case["W"],
                                              case["cl"], case["na"]))
        _contract(*whole, *plain, r16, case["W"], tm)


@pytest.mark.parametrize("mode", dense.ABLATE_MODES[:-1])
def test_split_ablation_modes_match_plain(device, mode):
    r16, tmax, _, cases = _mixed_case(device)
    case = cases["static"]
    C = case["W"].shape[0]
    args = (r16, tmax, case["W"], case["cl"], case["na"])
    t, p = dense.loop_hits_ablate(mode, *args)
    tp, pp = dense.loop_hits_ablate_plain(mode, *args)
    for blocks in (1, 3, dense.loop_blocks(C)):
        t2, p2 = _run(case, r16, tmax, None, blocks=blocks, mode=mode)
        torch.cuda.synchronize()
        if mode != "sections":
            assert torch.equal(t2, t) and torch.equal(p2, p), blocks
        else:
            # the least of the same f32 values, merged in any order
            assert torch.equal(p2, p) and torch.equal(
                torch.where(t2 == 0, 0.0, t2), torch.where(t == 0, 0.0, t))
    if mode in ("empty", "stage"):
        assert torch.equal(t, tp) and torch.equal(p, pp)
    elif mode == "sections":
        assert torch.equal(p, pp)
        exact, bound = dense.sections_reference(*args)
        live = torch.isfinite(exact)
        for x in (t, tp):
            assert ((x[live].double() - exact[live]).abs()
                    <= bound[live]).all()
    else:
        t2, p2 = dense.loop_hits(*args)
        assert torch.equal(t, t2) and torch.equal(p, p2)


def test_lists_of_all_chunks_and_of_one_chunk(device):
    r16, tmax, time, cases = _mixed_case(device)
    for kind, tm in (("static", None), ("motion", time)):
        case = dict(cases[kind])
        C = case["W"].shape[0]
        na = case["na"].clone()
        na[0::2] = C          # every chunk listed (in K1's order first)
        na[1::2] = 1
        case["na"] = na
        got = _run(case, r16, tmax, tm)
        plain = (dense.loop_hits_plain(r16, tmax, case["W"], case["cl"], na)
                 if tm is None else dense.loop_hits_motion_plain(
                     r16, tmax, tm, case["W"], case["cl"], na))
        torch.cuda.synchronize()
        _contract(*got, *plain, r16, case["W"], tm)


def test_motion_on_still_table_equals_static_k2(device):
    r16, tmax, time, cases = _mixed_case(device)
    st, still = cases["static"], cases["still"]
    assert bool(still["static"].all())
    assert torch.equal(st["cl"], still["cl"]) and torch.equal(st["na"],
                                                             still["na"])
    want = dense.loop_hits(r16, tmax, st["W"], st["cl"], st["na"])
    for told in (True, False):
        got = _run(still, r16, tmax, time, chunk_static=told)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_motion_mixed_table_static_chunks_off_horner(device):
    r16, tmax, time, cases = _mixed_case(device)
    case = cases["motion"]
    assert 0 < int(case["static"].sum()) < case["static"].numel()
    got = dense.loop_hits_motion(r16, tmax, time, case["W"], case["cl"],
                                 case["na"], case["static"])
    horner = _run(case, r16, tmax, time, chunk_static=False)
    plain = dense.loop_hits_motion_plain(r16, tmax, time, case["W"],
                                         case["cl"], case["na"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], horner[0]) and torch.equal(got[1], horner[1])
    _contract(*got, *plain, r16, case["W"], time)


def test_static_k2_at_1024_triangle_chunks(device):
    r16, tmax, _, cases = _mixed_case(device, n_tris=3000, chunk=1024)
    case = cases["static"]
    assert case["W"].shape == (3, 16, 4 * 1024)
    assert dense._smem_bytes(1024, 1) > dense.SMEM_DEFAULT
    got = dense.loop_hits(r16, tmax, case["W"], case["cl"], case["na"])
    plain = dense.loop_hits_plain(r16, tmax, case["W"], case["cl"],
                                  case["na"])
    torch.cuda.synchronize()
    _contract(*got, *plain, r16, case["W"])


def _refrng(device):
    import os
    from pbrt_tpu_torch.parser.api import parse_scene
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return parse_scene(os.path.join(root, "scenes", "cornell_refrng.pbrt"),
                       device=device)


def test_k2_on_the_matched_rng_mixed_batch(device):
    """K1 and K2 on the matched-RNG integrator's camera and first-bounce
    batches of scenes/cornell_refrng.pbrt at 128x128 (16,384 rays; 3 x
    16,384 continuation, probe and shadow rays, the last third any-hit):
    the contract of test_kernels_match_plain, but for the triangle a
    closest-hit lane finds.  Raw Sobol' samples on axis-aligned geometry
    send rays through shared mesh edges, where two f32 evaluations may
    each pick one of the edge's triangles: every lane whose triangle
    differs from the plain version's must be such a tie
    (dense.loop_prim_tie), and every any-hit lane whose occluded flag
    differs must have found a triangle that an f32 evaluation may accept
    or reject (dense.loop_hit_marginal)."""
    from pbrt_tpu_torch.tools import pbrt as cli
    job = _refrng(device)
    scene = job.scene
    batches = kernel_workloads.refpath_batches(
        scene, cli.build_camera(job, 128, 128, device), 128, 128, 5)
    assert batches["bounce1"][0].shape[0] == 3 * 128 * 128
    assert int((batches["bounce1"][0][:, 12] > 0.5).sum()) == 128 * 128
    for r16, tmax, _ in batches.values():
        _seam_contract(scene, r16, tmax)


def _seam_contract(scene, r16, tmax, skips=0):
    """K1's lists equal the plain lists; K2 against its plain version on
    them with ties at shared edges allowed (test_k2_on_the_matched_rng_
    mixed_batch), and at most `skips` closest-hit lanes of another
    triangle without a tie, each explained by dense.loop_prim_skipped.
    Returns K1's n_active and [(lane, crack)] for those lanes."""
    cl, na = dense.tile_chunk_lists(r16, tmax, scene.dense_cb)
    cl_p, na_p = dense.tile_chunk_lists_plain(r16, tmax, scene.dense_cb)
    assert torch.equal(cl, cl_p) and torch.equal(na, na_p)
    t, p = dense.loop_hits(r16, tmax, scene.dense_w, cl, na)
    tp, pp = dense.loop_hits_plain(r16, tmax, scene.dense_w, cl, na)
    torch.cuda.synchronize()
    assert ((p >= 0) == (pp >= 0)).float().mean() >= 0.9999
    anyhit = r16[:, 12] > 0.5
    occ = anyhit & ((p >= 0) != (pp >= 0))
    assert dense.loop_hit_marginal(r16[occ], tmax[occ], scene.dense_w,
                                   torch.maximum(p, pp)[occ]).all()
    differ = ~anyhit & (p >= 0) & (pp >= 0) & (p != pp)
    lanes = torch.nonzero(differ)[:, 0]
    lanes = lanes[~dense.loop_prim_tie(r16[lanes], scene.dense_w, p[lanes],
                                       pp[lanes])]
    assert len(lanes) <= skips
    explained, crack = dense.loop_prim_skipped(
        r16[lanes], tmax[lanes], scene.dense_w, p[lanes], pp[lanes])
    assert explained.all()
    closest = ~anyhit & (p == pp) & (p >= 0)
    t64, bound = dense.loop_t_reference(r16[closest], scene.dense_w,
                                        p[closest])
    for tt in (t, tp):
        assert ((tt[closest].double() - t64).abs()
                <= bound * t64.abs()).all()
    return na, list(zip(lanes.tolist(), crack.tolist()))


@pytest.mark.parametrize("batch", ["camera", "bounce1", "bitonic"])
def test_k1_k2_on_the_shapes_cell(device, tmp_path, batch):
    """K1 and the static K2 on the shapes cell (tools/shapes_scene.py at
    its defaults: 162,962 triangles in 319 chunks of 512): its camera and
    bounce-1 batches at 256x256 and kernel_workloads.bitonic_batch, some
    of whose tiles enter more chunks than K1 orders by counting
    (dense.QUEUE_RANK_MAX), so that its bitonic sort runs.  The contract
    of test_k2_on_the_matched_rng_mixed_batch (the heightfield and the
    blobs share edges between triangles), with one closest-hit lane of
    a batch allowed another triangle without a tie if rounding explains
    it.  Pinned: lane 39696 of the bounce-1 batch, where K2 passes
    between the two faces of a blob edge (148389, which the plain version
    returns, and the face across the edge) to face 147926 behind them, a
    crack of the formulation (ROADMAP Queue 3, open)."""
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli
    from pbrt_tpu_torch.tools import shapes_scene
    job = parse_scene(shapes_scene.write_shapes_scene(str(tmp_path)),
                      device=device)
    scene = job.scene
    assert scene.dense_chunk == 512
    assert scene.dense_w.shape[0] > dense.QUEUE_RANK_MAX
    if batch == "bitonic":
        r16, tmax, _ = kernel_workloads.bitonic_batch(scene)
    else:
        r16, tmax, _ = kernel_workloads.main_path_batches(
            scene, cli.build_camera(job, 256, 256, device),
            SamplerConfig("sobol", 0, 4), 256, 256, 65536, 5)[batch]
    na, skipped = _seam_contract(scene, r16, tmax, skips=1)
    if batch == "bitonic":
        assert (na > dense.QUEUE_RANK_MAX).any()
    assert skipped == ([(39696, True)] if batch == "bounce1" else [])


@pytest.mark.parametrize("batch", ["b0_p0", "b0_p3", "b1_p0", "b1_p3"])
def test_k1_k2_on_the_bssrdf_probe_batches(device, tmp_path, batch):
    """K1 and the static K2 on the BSSRDF probe passes of the skin scene
    (tools/skin_scene.py at its defaults, 256x256, Sobol 4 spp, depth 5):
    the first and last of a bounce's 4 passes at bounces 0 and 1, short
    chords of finite tmax from off the surface with most lanes dead
    (tmax -1).  The shapes cell's contract, with two closest-hit lanes a
    batch allowed another triangle where rounding explains it (a fiber's
    or a block's shared edge)."""
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli
    from pbrt_tpu_torch.tools import skin_scene
    job = parse_scene(skin_scene.write_skin_scene(str(tmp_path)),
                      device=device)
    scene = job.scene
    assert scene.has_sss and scene.use_dense
    r16, tmax, _ = kernel_workloads.sss_probe_batches(
        scene, cli.build_camera(job, 256, 256, device),
        SamplerConfig("sobol", 0, 4), 256, 256, 65536, 5,
        light_strategy="spatial")[batch]
    assert (tmax < 0).float().mean() > 0.5       # most probe lanes dead
    _seam_contract(scene, r16, tmax, skips=2)


@pytest.mark.parametrize("batch", ["light", "s2t2", "t1", "photon"])
def test_k1_k2_on_the_light_side_batches(device, batch):
    """K1 and the static K2 on kernel_workloads.bdpt_batches (one bdpt
    pass of 32,768 camera rays at 256x256, Sobol, depth 5) and
    photon_batch (65,536 photons) of scenes/cornell_bench.pbrt: the
    shapes cell's contract with two closest-hit lanes a batch allowed
    another triangle where rounding explains it."""
    import os
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job = parse_scene(os.path.join(root, "scenes", "cornell_bench.pbrt"),
                      device=device)
    scene = job.scene
    cfg = SamplerConfig("sobol", 0, 4)
    if batch == "photon":
        r16, tmax, _ = kernel_workloads.photon_batch(scene, cfg, 65536, 5)
    else:
        r16, tmax, _ = kernel_workloads.bdpt_batches(
            scene, cli.build_camera(job, 256, 256, device), cfg, 256, 256,
            32768, 5)[batch]
    assert (r16[:, 12] > 0.5).any() == (batch in ("s2t2", "t1"))
    _seam_contract(scene, r16, tmax, skips=2)


def test_trace_ref_on_the_card_matches_the_cpu(device):
    """trace_ref on 2,048 lanes of the 128x128 raster (rows 56-71) on the
    card and on the CPU (the kernels against their plain versions inside
    the whole integrator): image means within 1e-3, >= 99% of lanes
    within 1e-2 relative."""
    from pbrt_tpu_torch.integrators import refpath
    from pbrt_tpu_torch.tools import pbrt as cli
    out = []
    for dev in (device, torch.device("cpu")):
        job = _refrng(dev)
        sampler = refpath.RefSampler.make(128, 128)
        ids = torch.arange(56 * 128, 72 * 128, device=dev)
        ray, _, _, pid, sidx = refpath.camera_rays_ref(
            cli.build_camera(job, 128, 128, dev), 128, 128, sampler, ids, 1)
        L = refpath.trace_ref(job.scene, refpath.build_ref_lights(job.scene),
                              sampler, ray, pid, sidx, max_depth=5)
        out.append(L.sum(-1).cpu().numpy())
    g, c = out
    assert np.isfinite(g).all() and (g >= 0).all()
    assert abs(g.mean() / c.mean() - 1) < 1e-3
    assert (np.abs(g - c) <= 1e-2 * np.abs(c)).mean() >= 0.99


# ---------------------------------------------------------------------------
# the BVH and kd-tree walks (csrc/accel_walk.cu)
# ---------------------------------------------------------------------------

def _walk_scene(device, accel, moving, n=3000, seed=5):
    """n random triangles (a quarter of them moving, for `moving`), four of
    them sharing one box centre, and a sphere, built for the walks."""
    from pbrt_tpu_torch.core.transform import Transform, translate
    from pbrt_tpu_torch.scene import ir
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 3) * 10 - 5
    verts = base[:, None, :] + np.concatenate(
        [np.zeros((n, 1, 3)), rs.randn(n, 2, 3) * 0.4], 1)
    verts[:4] = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]]) \
        * np.arange(1, 5)[:, None, None]
    b = ir.SceneBuilder()
    m = b.add_material(ir.MaterialSpec())
    k = n // 4 if moving else 0
    b.add_triangle_mesh(verts[:n - k].reshape(-1, 3),
                        np.arange(3 * (n - k)).reshape(-1, 3), m)
    if k:
        b.add_triangle_mesh(verts[n - k:].reshape(-1, 3),
                            np.arange(3 * k).reshape(-1, 3), m,
                            object_to_world1=translate(0.3, -0.2, 0.1))
    b.add_sphere(Transform(), 1.2, m)
    s = b.build(device=device, accel=accel)
    assert s.has_animated_mesh == moving
    return s


def _walk_fns(s, accel, ray, anyhit):
    """(kernel wrapper, plain version, arguments) of scene s's walk."""
    from pbrt_tpu_torch.ops import accel_walk
    from pbrt_tpu_torch.ops import intersect as isect
    args = isect._walk_args(s, ray, anyhit)
    if accel == "kdtree":
        args.update(tmax=ray.tmax.contiguous(), kd_packed=s.kd_packed,
                    kd_prim_idx=s.kd_prim_idx, kd_bounds=s.kd_bounds,
                    kd_max_leaf=s.kd_max_leaf, tri_packed=s.tri_packed)
        return accel_walk.kd_walk, accel_walk.kd_walk_plain, args
    args.update(packed=s.bvh_packed, links=s.bvh_links,
                max_leaf=s.max_leaf, tri_packed=s.tri_packed)
    return accel_walk.bvh_walk, accel_walk.bvh_walk_plain, args


def _walk_equal(fn, plain, args, name):
    """The kernel's (t, prim) against the plain version's, bit for bit on
    every lane, in one launch; returns (prim, the plain version's
    counts)."""
    from pbrt_tpu_torch.ops import accel_walk
    accel_walk.reset_launch_counts()
    t, prim = fn(**args)
    torch.cuda.synchronize()
    assert accel_walk.LAUNCHES[name] == 1
    tp, pp, counts = plain(counts=True, **args)
    assert torch.equal(prim, pp)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))
    return prim, counts


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "motion"])
def test_walk_equals_plain(device, accel, moving):
    """bvh_walk and kd_walk (static and motion instantiations) against
    their plain versions on the same CUDA tensors: (t, prim) equal bit
    for bit on every lane, the closest-hit and the any-hit ones; rays from
    inside and outside the triangles' box, axis-parallel ones, dead lanes
    and finite tmax, shutter times outside [0, 1] included; then the
    walks' edge cases (kernel_workloads.walk_edge_rays: split planes, the
    2e20 reciprocal, face exits with t_cell <= 0, any-hit rays through the
    sphere's pre-hit), and the batch's 1% of lanes with the most node
    visits alone."""
    from pbrt_tpu_torch.core import geometry as geom
    s = _walk_scene(device, accel, moving)
    rs = np.random.RandomState(9)
    B = 8192
    o = rs.uniform(-8, 8, (B, 3)).astype(np.float32)
    d = rs.randn(B, 3)
    d[:6] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1e-21, 0],
             [-1, 0, -1e-22], [0, 0, -1]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(B, np.inf, np.float32)
    tmax[::13] = -1
    tmax[3::5] = rs.uniform(0.5, 6, len(tmax[3::5]))
    ray = geom.Ray.make(*(torch.as_tensor(x, device=device) for x in (o, d)),
                        tmax=torch.as_tensor(tmax, device=device),
                        time=torch.as_tensor(rs.uniform(-0.2, 1.2, B)
                                             .astype(np.float32),
                                             device=device))
    anyhit = torch.as_tensor(rs.rand(B) < 0.4, device=device)
    fn, plain, args = _walk_fns(s, accel, ray, anyhit)
    assert (args["time"] is not None) == moving
    name = ("kd_walk" if accel == "kdtree" else "bvh_walk") + (
        "_motion" if moving else "")
    prim, counts = _walk_equal(fn, plain, args, name)
    found = prim >= 0
    assert 0.2 < found.float().mean().item() < 0.95
    assert (prim[~anyhit & found] >= 0).all()
    # the edge cases
    eo, ed, etmax, etime, eany = kernel_workloads.walk_edge_rays(
        s, seed=1, aim=[(0.0, 0.0, 0.0)])
    fn, plain, eargs = _walk_fns(s, accel, geom.Ray.make(
        eo, ed, tmax=etmax, time=etime), eany)
    eprim, _ = _walk_equal(fn, plain, eargs, name)
    assert bool((eany & (eargs["prim_init"] >= 0)).any())
    assert bool((eprim >= 0).any())
    # the longest walks alone
    top = torch.topk(counts.visits, B // 100).indices
    sub = {k: (v[top].contiguous() if k in kernel_workloads.WALK_RAY_ARGS
               and v is not None else v) for k, v in args.items()}
    _walk_equal(fn, plain, sub, name)
