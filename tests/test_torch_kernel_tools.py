"""The kernel harnesses of the port (K2's ablation modes, the tile dump,
the intersect stage split and their workloads) on the CPU, where every
kernel wrapper takes its plain version, held against pbrt_tpu on the same
numpy-seeded inputs.

Tolerances, each with its reason:
- workload tables: chunk boxes, centers and chunk sizes exactly equal to
  pbrt_tpu's (the same f64 numpy code, rounded once to f32).
- the dump's sections against pbrt_tpu's truth of
  scripts/debug/dbg_dense_dump.py:86-92 (one dot of [r_hi|r_lo|r_hi] with
  the bf16x2 table, jnp on the CPU): 2^-14 * sum|r_i W_i| per entry, the
  error of the bf16x2 split (hi + lo keeps ~16 bits of each operand).
- the dump's sections against f64 sections from pbrt_tpu's
  `_plucker_sections`: gamma_17 * sum|r_i W_i| (a 16-product f32 dot, and
  the table's own f32 rounding).
- full and direct against pbrt_tpu's loop kernel in interpret mode: the
  tolerances of test_torch_dense_intersect.py (found on >= 99.9% of rays,
  t within 5e-3 relative, prim on > 99%).
- empty and stage: exactly their contract; sections within
  `sections_reference`'s bound; the composed intersect stages exactly
  equal to `intersect`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.ops import pallas_intersect as jdense
from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import cuda_kernels
from pbrt_tpu_torch.ops import dense_intersect as tdense
from pbrt_tpu_torch.tools import ablate_k2, dissect_intersect, dump_tile
from pbrt_tpu_torch.tools import kernel_workloads as kw
from test_dense_kernel import _run_dense, _rays, _soup
from test_torch_dense_intersect import _check_closest
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
T = tdense.TILE


@pytest.fixture(scope="module")
def tiny():
    return kw.tiny600(CPU)


@pytest.mark.parametrize("name", ["cluster", "tiny600"])
def test_workload_tables_match_jax(name):
    mesh = kw.cluster_mesh(0) if name == "cluster" else kw.tiny600_mesh()[0]
    ref = jdense.build_dense_tables(*mesh)
    got = tdense.build_dense_tables(*mesh)
    assert got["chunk"] == ref["chunk"] == 128
    assert np.array_equal(got["chunk_bounds"], ref["chunk_bounds"])
    assert np.array_equal(got["center"], ref["center"])
    if name == "cluster":
        assert mesh[0].shape == (65792, 3) and got["W"].shape[0] == 514
        assert got["W"].nbytes == 514 * 16 * 512 * 4      # 16.8 MB


def _tile(wl, tile=0):
    sl = slice(tile * T, (tile + 1) * T)
    return wl.r16[sl], wl.tmax[sl]


def test_dump_sections_match_jax_bf16x2_truth(tiny):
    """s6: tile 0 over picks 0 1 2 2 against the dot of the bf16x2 table
    pbrt_tpu builds, as dbg_dense_dump.py computes its truth."""
    picks = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    r, tm = _tile(tiny)
    got = tdense.tile_dump_plain(r, tm, tiny.W, picks)["sections"].numpy()
    W2 = jnp.asarray(jdense.build_dense_tables(*kw.tiny600_mesh()[0])["W"])
    rj = jnp.asarray(r.numpy())
    r_hi = rj.astype(jnp.bfloat16)
    r_lo = (rj - r_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    r48 = jnp.concatenate([r_hi, r_lo, r_hi], -1)
    order = [0, 1, 3, 2]                      # s1 s2 num s0 -> s1 s2 s0 num
    for k, c in enumerate(picks.tolist()):
        out = np.asarray(jnp.dot(r48, W2[c],
                                 preferred_element_type=jnp.float32))
        mag = np.abs(r.numpy()) @ np.abs(tiny.W[c].numpy())
        for s, js in enumerate(order):
            sl = slice(js * 128, (js + 1) * 128)
            assert (np.abs(got[k, s] - out[:, sl].T)
                    <= 2.0 ** -14 * mag[:, sl].T).all()


def test_dump_sections_match_f64_sections(tiny):
    (v0, e1, e2), _ = kw.tiny600_mesh()
    center = v0.mean(0)
    inv = (1.0 / jdense._plucker_scale(v0, e1, e2, center))[:, None]
    W64 = np.zeros((4, 16, 640))
    W64[:, :, :600] = jdense._plucker_sections(v0, e1, e2, center, inv)
    picks = torch.tensor([4, 0, 2], dtype=torch.int32)
    r, tm = _tile(tiny, 3)
    got = tdense.tile_dump_plain(r, tm, tiny.W, picks)["sections"].numpy()
    r64 = r.double().numpy()
    u = 2.0 ** -24
    for k, c in enumerate(picks.tolist()):
        cols = W64[:, :, c * 128:(c + 1) * 128]             # [4,16,128]
        for s, js in enumerate([0, 1, 3, 2]):
            exact = (r64 @ cols[js]).T
            mag = (np.abs(r64) @ np.abs(cols[js])).T
            assert (np.abs(got[k, s] - exact)
                    <= 17 * u / (1 - 17 * u) * mag + 1e-30).all()


def _walk(r16, tmax, W, picks):
    """A triangle-by-triangle walk of one tile as the kernel walks it."""
    chunk = W.shape[2] // 4
    acc = np.zeros((len(picks), chunk, T), bool)
    best_t, best_p = tmax.numpy().copy(), np.full(T, -1)
    done = ~(best_t > 0)
    ref = tdense.tile_dump_plain(r16, tmax, W, torch.tensor(
        picks, dtype=torch.int32))
    for k, c in enumerate(picks):
        t = ref["t"][k].numpy()
        s1, s2, s0 = (ref["sections"][k, i].numpy() for i in range(3))
        inside = ((np.signbit(s0) == np.signbit(s1))
                  & (np.signbit(s0) == np.signbit(s2)))
        for j in range(chunk):
            for lane in range(T):
                p = c * chunk + j
                tt = t[j, lane]
                if (not done[lane] and inside[j, lane] and tt > 1e-4
                        and (tt < best_t[lane] or (tt == best_t[lane]
                                                   and p < best_p[lane]))):
                    acc[k, j, lane] = True
                    best_t[lane], best_p[lane] = tt, p
                    if r16[lane, 12] > 0.5:
                        best_t[lane], done[lane] = -1.0, True
    return ref, acc, best_t, best_p


def test_dump_plain_accepts_as_the_kernel_walks(tiny):
    """tile_dump_plain's vectorised accept flags and running best equal a
    sequential walk, with any-hit, dead and repeated picks."""
    r, tm = (x.clone() for x in _tile(tiny, 2))
    r[1::3, 12] = 1.0                                   # any-hit lanes
    tm[::5] = -1.0                                      # dead lanes
    ref, acc, best_t, best_p = _walk(r, tm, tiny.W, [3, 1, 1, 0, 2])
    assert acc.sum() > 10 and acc[:, :, 1::3].sum() > 3
    assert np.array_equal(ref["accepted"].numpy(), acc)
    assert np.array_equal(ref["best_t"][-1].numpy(), best_t.astype(np.float32))
    assert np.array_equal(ref["best_prim"][-1].numpy(), best_p)


def test_dump_last_best_equals_k2_plain(tiny):
    for tile in (0, 7):
        picks = tiny.chunk_list[tile, :int(tiny.n_active[tile])]
        out = tdense.tile_dump(tiny.r16, tiny.tmax, tiny.W, picks, tile)
        t, p = dump_tile.k2_on_tile(tiny, tile, picks)
        assert torch.equal(out["best_t"][-1], t)
        assert torch.equal(out["best_prim"][-1], p)


def _dump_case(tiny, tile, picks, anyhit_every=0):
    r, tm = (x.clone() for x in _tile(tiny, tile))
    if anyhit_every:
        r[1::anyhit_every, 12] = 1.0
    pk = torch.tensor(picks, dtype=torch.int32)
    ref = tdense.tile_dump_plain(r, tm, tiny.W, pk)
    sec_bound, t_rel = tdense.tile_dump_bounds(r, tiny.W, pk)
    return r, tm, ref, sec_bound, t_rel


def _unexplained(got, ref, r, tm, sec_bound, t_rel):
    differ, bad = dump_tile.unexplained_accepts(got, ref, tm, r[:, 12] > 0.5,
                                                sec_bound, t_rel)
    return int(differ.sum()), int(bad.sum())


def test_dump_accept_rule_fails_a_kernel_that_accepts_nothing(tiny):
    """A dump whose accept flags are all false (its sections, t and
    running bests right) differs from plain on every accepted test, and
    no rounding explains any of them; equal dumps differ nowhere."""
    r, tm, ref, sb, tr = _dump_case(tiny, 0, [0, 1, 2, 2])
    assert _unexplained(ref, ref, r, tm, sb, tr) == (0, 0)
    got = dict(ref, accepted=torch.zeros_like(ref["accepted"]))
    n = int(ref["accepted"].sum())
    assert n >= 20 and _unexplained(got, ref, r, tm, sb, tr) == (n, n)


def test_dump_accept_rule_explains_only_near_ties(tiny):
    """In the last pick (a repeat, where plain accepts nothing) a kernel
    accepting a test one ulp under the lane's best against plain's one
    ulp over it is a near tie; accepting a test at half the best is not."""
    r, tm, ref, sb, tr = _dump_case(tiny, 3, [3, 1, 1])
    assert not ref["accepted"][-1].any()
    best = ref["best_t"][-1]
    lanes = ((best < tm) & (tr[-1, 5] < 1e-3)).nonzero()[:, 0]
    assert lanes.numel() > 10
    lane, b = int(lanes[0]), best[int(lanes[0])].item()
    for t_k, t_p, explained in ((b * (1 - 2.0 ** -23), b * (1 + 2.0 ** -23),
                                 True), (b * 0.5, b * 0.5, False)):
        got = {k: v.clone() for k, v in ref.items()}
        pl = {k: v.clone() for k, v in ref.items()}
        got["t"][-1, 5, lane], pl["t"][-1, 5, lane] = t_k, t_p
        got["accepted"][-1, 5, lane] = True
        assert _unexplained(got, pl, r, tm, sb, tr) == (1, 0 if explained
                                                         else 1)


def test_dump_accept_rule_follows_any_hit_walks_apart(tiny):
    """A kernel whose any-hit lane skips plain's first accept (no near
    tie there) and accepts a later test is wrong once, at the skipped
    test; its later accept, made after the walks part (plain's lane is
    done), is explained by that."""
    r, tm, ref, sb, tr = _dump_case(tiny, 2, [3, 1, 0, 2], anyhit_every=3)
    n, chunk = ref["accepted"].shape[:2]
    edge = (ref["sections"][:, :3].abs() <= sb[:, :3]).any(1)
    clear = ((ref["t"] > 1e-3) & ~edge).reshape(n * chunk, T)
    acc = ref["accepted"].reshape(n * chunk, T)
    lane = next(ln for ln in range(1, T, 3) if acc[:, ln].any()
                and clear[acc[:, ln].nonzero()[0, 0] + 1:, ln].any())
    first = int(acc[:, lane].nonzero()[0, 0])
    later = first + 1 + int(clear[first + 1:, lane].nonzero()[0, 0])
    assert clear[first, lane]
    got = {k: v.clone() for k, v in ref.items()}
    flags = got["accepted"].view(n * chunk, T)
    flags[first, lane], flags[later, lane] = False, True
    assert _unexplained(got, ref, r, tm, sb, tr) == (2, 1)


@pytest.mark.parametrize("coherent,seeds", [(True, (0, 1)), (False, (3, 4))])
def test_full_and_direct_plain_match_loop_plain_and_jax(coherent, seeds):
    v0, e1, e2 = _soup(seed=seeds[0])
    o, d = _rays(seed=seeds[1], coherent=coherent)
    tmax = np.full(o.shape[0], 3.0e38, np.float32)
    tab = tdense.build_dense_tables(v0, e1, e2)
    r16 = tdense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tab["center"]))
    tm = torch.from_numpy(tmax)
    W = torch.from_numpy(tab["W"])
    cl, na = tdense.tile_chunk_lists(r16, tm,
                                     torch.from_numpy(tab["chunk_bounds"]))
    ref = tdense.loop_hits_plain(r16, tm, W, cl, na)
    tj, pj = _run_dense(v0, e1, e2, o, d, tmax)
    for mode in ("full", "direct"):
        t, p = tdense.loop_hits_ablate_plain(mode, r16, tm, W, cl, na)
        assert torch.equal(t, ref[0]) and torch.equal(p, ref[1])
        _check_closest(t.numpy(), p.numpy(), tj, pj, 5e-3)


def test_empty_and_stage_plain_give_their_contract(tiny):
    args = tiny.args()
    na = tiny.n_active.numpy()
    t, p = tdense.loop_hits_ablate_plain("empty", *args)
    assert torch.equal(t, tiny.tmax)
    assert np.array_equal(p.numpy(), np.repeat(na, T))
    t, p = tdense.loop_hits_ablate_plain("stage", *args)
    assert np.array_equal(p.numpy(), np.repeat(na, T))
    offs = tdense.staged_offsets(128).numpy()
    Wf = tiny.W.reshape(tiny.W.shape[0], -1).numpy().view(np.uint32)
    cl = tiny.chunk_list.numpy()
    bits = t.numpy().view(np.uint32)
    for tile in (0, 5, 15):
        for lane in (0, 1, 77, 127):
            word = (22 * lane) % (22 * 128)
            acc = np.uint32(0)
            for k in range(na[tile]):
                acc ^= Wf[cl[tile, k], offs[word // 128] + word % 128]
            assert bits[tile * T + lane] == acc


def test_sections_plain_within_reference_bound(tiny):
    args = tiny.args()
    t, p = tdense.loop_hits_ablate_plain("sections", *args)
    exact, bound = tdense.sections_reference(tiny.r16, tiny.tmax, tiny.W,
                                             tiny.chunk_list, tiny.n_active)
    live = torch.isfinite(exact)
    assert live.all() and (bound > 0).all()
    assert ((t.double() - exact).abs() <= bound).all()
    # the least num + nd of lane 0 of tile 1, from its own dot products
    r = tiny.r16[T].double()
    vals = [(r @ tiny.W[c].double()).reshape(4, 128).sum(0).min().item()
            for c in tiny.chunk_list[1, :int(tiny.n_active[1])].tolist()]
    assert exact[T].item() == pytest.approx(min(vals), rel=1e-12)


def test_wrappers_on_cpu_take_plain_and_count_nothing(tiny):
    tdense.reset_launch_counts()
    for mode in tdense.ABLATE_MODES:
        a = tdense.loop_hits_ablate(mode, *tiny.args())
        b = tdense.loop_hits_ablate_plain(mode, *tiny.args())
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    tdense.tile_dump(tiny.r16, tiny.tmax, tiny.W,
                     torch.tensor([1], dtype=torch.int32), 1)
    assert set(tdense.LAUNCHES.values()) == {0}
    assert [tdense.ablate_kernel(m) for m in tdense.ABLATE_MODES] == [
        "dense_loop_ablate[empty]", "dense_loop_ablate[stage]",
        "dense_loop_ablate[sections]", "dense_loop_ablate[direct]",
        "dense_loop"]
    assert all(tdense.ablate_kernel(m) in tdense.LAUNCHES
               for m in tdense.ABLATE_MODES)
    with pytest.raises(ValueError):
        tdense.loop_hits_ablate("nodot", *tiny.args())


def test_dissect_stages_compose_to_intersect():
    scene, _ = flagship.cornell(device="cpu")
    ray = dissect_intersect.batch(scene, 512, 3, CPU)
    assert 0.6 < (ray.tmax > 0).float().mean() < 0.8
    fns, composed = dissect_intersect.stages(scene, ray)
    whole = dissect_intersect.isect.intersect(scene, ray)
    for a, b in zip(composed, whole):
        assert torch.equal(a, b)
    assert set(fns) == set(dissect_intersect.STAGES)
    assert fns["sphere pre-test"] is not None        # Cornell's glass ball


@pytest.mark.parametrize("tool,argv", [
    (ablate_k2, ["--workload", "cornell", "--rounds", "1", "--reps", "1"]),
    (dissect_intersect, ["--scene", "cornell", "--batch", "256",
                         "--rounds", "1", "--reps", "1"]),
    (dump_tile, ["--picks", "0", "1", "2", "2"]),
    (dump_tile, ["--tile", "9"]),
])
def test_tool_main_runs_on_cpu(tool, argv, capsys):
    assert tool.main(["--cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out
    if tool is ablate_k2:
        assert "machinery" in out and "epilogue" in out
    if tool is dump_tile:
        assert "bit for bit: True" in out


def test_parse_ptxas_report_per_function():
    text = """
ptxas info    : Compiling entry function '_Z4loopv' for 'sm_90a'
ptxas info    : Function properties for _Z4loopv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4hotv' for 'sm_90a'
ptxas info    : Function properties for _Z4hotv
    0 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
    """
    r = cuda_kernels.parse_ptxas(text)
    assert r == {"_Z4loopv": {"registers": 56, "stack": 8,
                              "spill_stores": 0, "spill_loads": 0},
                 "_Z4hotv": {"registers": 255, "stack": 0,
                             "spill_stores": 12, "spill_loads": 16}}


def test_parse_sass_counts_per_function():
    text = """
        Function : _ZN12_GLOBAL__N_117dense_loop_kernelILi2EEEvPKfS2_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*00f0*/                   FFMA R7, R2, R3, R7 ;
        /*0100*/              @!P0 FFMA R7, R2, R3, R7 ;
        /*0110*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0120*/                   MUFU.RCP R4, R5 ;
        /*0130*/             @!UP0 STS [R3], R4 ;
        /*0140*/                   LDS.128 R8, [R2+0x200] ;
        /*0150*/                   LDS R9, [R2] ;
        Function : other
        /*0000*/                   FMUL R1, R2, R3 ;
    """
    c = cuda_kernels.parse_sass(text)
    k = c["_ZN12_GLOBAL__N_117dense_loop_kernelILi2EEEvPKfS2_"]
    assert k == {"LDC": 1, "FFMA": 2, "BAR": 1, "BAR.SYNC": 1, "MUFU": 1,
                 "MUFU.RCP": 1, "STS": 1, "LDS": 2, "LDS.128": 1}
    assert c["other"] == {"FMUL": 1}


def test_ab_loop_slice_copy_changes_only_g(tmp_path):
    """The kernel's slice length G (kSlice in csrc/dense_loop.cu) and its
    mirror LOOP_SLICE agree, and ab_loop --slices' copy of the package
    sets both to the value asked for and changes nothing else."""
    import filecmp
    import os
    import re
    from pbrt_tpu_torch.tools import ab_loop
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        ab_loop.__file__)))
    with open(os.path.join(pkg, "csrc", "dense_loop.cu")) as f:
        assert re.findall(r"constexpr int kSlice = (\d+);", f.read()) == [
            str(tdense.LOOP_SLICE)]
    g = tdense.LOOP_SLICE + 3
    root = ab_loop.slice_tree(os.path.dirname(pkg), g, str(tmp_path))
    copy = os.path.join(root, "pbrt_tpu_torch")
    changed = {"csrc/dense_loop.cu", "ops/dense_intersect.py"}
    for rel in changed:
        with open(os.path.join(pkg, rel)) as f:
            a = f.read().splitlines()
        with open(os.path.join(copy, rel)) as f:
            b = f.read().splitlines()
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        assert len(a) == len(b) and len(diff) == 1, rel
        assert diff[0][1] in (f"constexpr int kSlice = {g};",
                              f"LOOP_SLICE = {g}"), rel
    for d, _, files in os.walk(copy):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), copy)
            if rel not in changed:
                assert filecmp.cmp(os.path.join(pkg, rel),
                                   os.path.join(d, name), shallow=False)
    assert not os.path.exists(os.path.join(copy, "_build"))
