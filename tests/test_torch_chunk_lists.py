"""K1's chunk lists (tile_chunk_lists: its plain version on the CPU) on
constructed edge cases, K1's bound (kernel_workloads.queue_bytes,
queue_bound), and ab_queue's copy with another kRankMax.

The lists' contract is checked exactly on every case: each tile's list
is a permutation of the chunk ids; its first n_active entries are the
hit chunks in ascending (near, chunk id), -0.0 taken as +0.0; the rest
are the missed chunks in ascending id.  The constructed cases
(kernel_workloads.queue_cases) also have their lists written out here:
equal entry t ordered by chunk id, entry t of -0.0 ordered with +0.0 by
chunk id, a dead tile and a live tile that misses every box (the
identity list, n_active 0), and C = 1, 48 and 576 chunks.
"""
import filecmp
import os

import pytest
import torch

from pbrt_tpu_torch.ops import dense_intersect as tdense
from pbrt_tpu_torch.tools import ab_queue
from pbrt_tpu_torch.tools import kernel_workloads as kw
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ALONG = [5, 7, 1, 2, 0, 3, 4, 6]     # the ties case's list
LISTS = {"ties": {0: ALONG}, "signed_zero": {0: [0, 1, 3, 2]},
         "dead_miss": {0: ALONG, 1: list(range(8)), 2: list(range(8))}}
N_ACTIVE = {"ties": [6], "signed_zero": [4], "dead_miss": [6, 0, 0]}


@pytest.fixture(scope="module")
def cases():
    return kw.queue_cases(torch.device("cpu"))


def check_contract(cl, na, hits, near):
    """The lists' contract (module docstring) against the cull's outputs."""
    n_tiles, C = hits.shape
    assert cl.dtype == na.dtype == torch.int32
    assert cl.shape == (n_tiles, C) and na.shape == (n_tiles,)
    assert torch.equal(na, hits.sum(1, dtype=torch.int32))
    for b in range(n_tiles):
        row, n = cl[b].long(), int(na[b])
        assert torch.equal(row.sort().values, torch.arange(C))
        act, rest = row[:n], row[n:]
        assert hits[b, act].all() and not hits[b, rest].any()
        assert (rest.diff() > 0).all()
        key = (near[b, act] + 0.0).tolist()
        pairs = list(zip(key, act.tolist()))
        assert pairs == sorted(pairs) and len(set(pairs)) == n


@pytest.mark.parametrize("name", ["ties", "signed_zero", "dead_miss", "C1",
                                  "C48", "C576"])
def test_chunk_lists_contract(cases, name):
    r16, tmax, cb = cases[name]
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    hits, near = tdense.tile_queue(r16, tmax, cb)
    check_contract(cl, na, hits, near)
    for tile, want in LISTS.get(name, {}).items():
        assert cl[tile].tolist() == want
    if name in N_ACTIVE:
        assert na.tolist() == N_ACTIVE[name]
    else:
        C = cb.shape[0]
        assert cl.shape[1] == int(name[1:]) == C
        assert na.sum() > 0 and (na < C).any()
    if name == "signed_zero":
        # the case holds what it names: chunks 0 and 3 keyed at -0.0
        assert torch.signbit(near[0]).tolist() == [True, False, False, True]


def test_chunk_lists_from_cull_orders_signed_zero_by_id():
    """-0.0 and +0.0 tie, in either order of ids; +inf misses follow."""
    inf = float("inf")
    near = torch.tensor([[-0.0, 0.0, 2.0, -0.0, 0.0],
                         [0.5, 0.0, -0.0, inf, -0.0]])
    hits = torch.tensor([[True] * 5, [True, True, True, False, True]])
    cl, na = tdense.chunk_lists_from_cull(hits, near)
    assert cl.tolist() == [[0, 1, 3, 4, 2], [1, 2, 4, 0, 3]]
    assert na.tolist() == [5, 4]


@pytest.mark.parametrize("mode", ["list", "cull"])
def test_queue_bound_counts(cases, mode):
    """dead_miss: 256 live lanes of 384 (tiles 0 and 2), 8 chunks."""
    r16, tmax, cb = cases["dead_miss"]
    out = 3 * 8 * 4 + 3 * 4 if mode == "list" else 3 * 8 * 5
    nbytes = 256 * 64 + 384 * 4 + 8 * 8 * 4 + out
    assert kw.queue_bytes(mode, r16, tmax, cb) == nbytes
    flops = kw.QUEUE_FLOPS * 256 * 8
    ms, by = kw.queue_bound(mode, r16, tmax, cb)
    assert ms == pytest.approx(max(flops / kw.F32_PEAK,
                                   nbytes / kw.HBM_BPS) * 1e3)
    assert by == "bytes"
    with pytest.raises(ValueError):
        kw.queue_bytes("sort", r16, tmax, cb)


def test_queue_bound_by_operations_at_many_chunks(cases):
    r16, tmax, cb = cases["C576"]
    live = int((tmax > 0).sum())
    ms, by = kw.queue_bound("list", r16, tmax, cb)
    assert by == "operations"
    assert ms == pytest.approx(kw.QUEUE_FLOPS * live * 576 / kw.F32_PEAK
                               * 1e3)


def test_ab_queue_rank_copy_changes_only_rank_max(tmp_path):
    """ab_queue --rank-max's package differs from this one in the one
    line that sets kRankMax, K1's threshold between its two order
    algorithms."""
    pkg = os.path.join(ab_queue.HERE, "pbrt_tpu_torch")
    root = ab_queue.rank_tree(str(tmp_path), 7)
    copy = os.path.join(root, "pbrt_tpu_torch")
    rel = os.path.join("csrc", "dense_queue.cu")
    with open(os.path.join(pkg, rel)) as f:
        a = f.read().splitlines()
    with open(os.path.join(copy, rel)) as f:
        b = f.read().splitlines()
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(a) == len(b) and len(diff) == 1
    assert diff[0][0].startswith("constexpr int kRankMax = ")
    assert diff[0][1] == "constexpr int kRankMax = 7;"
    for d, _, files in os.walk(copy):
        for name in files:
            r = os.path.relpath(os.path.join(d, name), copy)
            if r != rel:
                assert filecmp.cmp(os.path.join(pkg, r),
                                   os.path.join(d, name), shallow=False)
    assert not os.path.exists(os.path.join(copy, "_build"))
