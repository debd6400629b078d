"""Low-discrepancy sequences as pure counter-based functions (port of
pbrt_tpu.core.lds): Owen-scrambled Sobol' for the production sampler,
plain Sobol' on the reference's GlobalSampler index map for the
matched-RNG integrator (integrators/refpath.py), scrambled radical
inverses (Halton), the (0,2)-sequence and the maximized-minimal-distance
generator matrices.

Direction numbers and generator matrices come from the JAX package's
`data/sobol_matrices.npy` ([1024, 30] uint32) and `data/maxmindist.npz`
([17, 32] uint32), read by path.  Words ride in int64 (see core/rng.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from pbrt_tpu_torch import DATA_DIR
from pbrt_tpu_torch.core import rng as _rng

SOBOL_BITS = 30
_SOBOL_NP = np.load(os.path.join(DATA_DIR, "sobol_matrices.npy"))
N_SOBOL_DIMS = _SOBOL_NP.shape[0]
_INV_2_32 = 2.3283064365386963e-10


@functools.lru_cache(maxsize=None)
def _columns(dim: int):
    """Direction numbers of one dimension as python ints (bit j -> v_j)."""
    return tuple(int(v) for v in _SOBOL_NP[dim])


def sobol_u32(index, dim: int):
    """Sobol' sample bits: XOR of the direction numbers selected by the
    bits of `index` (int64 tensor of 32-bit words).  Returns [0, 2^30)."""
    x = torch.zeros_like(index)
    for j, v in enumerate(_columns(dim)):
        x = x ^ (((index >> j) & 1) * v)
    return x


_LANE_COLS = 32          # the table's 30 columns padded to a power of 2


@functools.lru_cache(maxsize=None)
def _lane_table(device):
    """The direction numbers as an int64 [1024, 32] tensor on `device`,
    two zero columns appended for sobol_u32_lanes' xor tree."""
    t = np.zeros((N_SOBOL_DIMS, _LANE_COLS), np.int64)
    t[:, :SOBOL_BITS] = _SOBOL_NP
    return torch.as_tensor(t, device=device)


def sobol_u32_lanes(index, dim):
    """sobol_u32 with a dimension per lane: index and dim are int64
    tensors of one shape.  Each lane gathers its dimension's row of
    direction numbers, masks it by the bits of its index and xors the
    row down by halves; xor is associative, so the bits equal
    sobol_u32's wherever dim is constant.  A dim past the table is
    clamped to its last row, as the JAX package's gather clamps it."""
    table = _lane_table(index.device)
    rows = table[torch.clamp(dim, 0, N_SOBOL_DIMS - 1)]       # [..., 32]
    shifts = torch.arange(_LANE_COLS, device=index.device)
    x = rows * ((index[..., None] >> shifts) & 1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def sobol_sample(index, dim: int, scramble_seed=None):
    """Sobol' float in [0,1); scramble_seed (32-bit words) Owen-scrambles."""
    x = (sobol_u32(index, dim) << (32 - SOBOL_BITS)) & _rng.M32
    if scramble_seed is not None:
        x = _rng.owen_scramble(x, scramble_seed)
    f = x.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=_rng.ONE_MINUS_EPS)


# ---------------------------------------------------------------------------
# radical inverse (Halton)
# ---------------------------------------------------------------------------

def _primes(n):
    sieve = np.ones(20000, dtype=bool)
    sieve[:2] = False
    for i in range(2, 142):
        if sieve[i]:
            sieve[i * i::i] = False
    return np.nonzero(sieve)[0][:n]


#: first 1024 primes (the reference uses 1000, lowdiscrepancy.cpp
#: PrimeTableSize)
PRIMES = _primes(1024)


def _to_unit(bits):
    """A 32-bit fixed-point word as a float in [0, 1)."""
    return torch.clamp(bits.to(torch.float32) * _INV_2_32,
                       max=_rng.ONE_MINUS_EPS)


def radical_inverse_base2(index):
    """Base-2 radical inverse: the reversed bits as a fraction."""
    return _to_unit(_rng.reverse_bits32(index))


@functools.lru_cache(maxsize=None)
def _digit_factors(base, n_digits):
    """base^-(d+1) for each digit d, as the JAX package forms them: one
    f32 product a digit (python floats holding the f32 values).  A
    factor that falls below f32's normal range is flushed to zero, as
    XLA on the CPU flushes it; its terms lie far below the ulp of the
    sum either way."""
    inv = np.float32(1.0 / base)
    f, out = np.float32(1.0), []
    for _ in range(n_digits):
        f = np.float32(f * inv)
        if abs(f) < np.finfo(np.float32).tiny:
            f = np.float32(0.0)
        out.append(float(f))
    return tuple(out)


def radical_inverse(index, base: int, n_digits=20, perm_seed=None):
    """Radical inverse of `index` (int64 tensor of 32-bit words) in prime
    `base`, with an optional per-digit scramble keyed on (perm_seed,
    digit position).  All n_digits digits are formed even where the
    index has fewer: the scramble adds a term to each (reference:
    lowdiscrepancy.h ScrambledRadicalInverse)."""
    index = _rng.u32(index)
    out = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    for d, factor in enumerate(_digit_factors(base, n_digits)):
        digit = index % base
        if perm_seed is not None:
            h = _rng.hash_combine(perm_seed, d)
            digit = (digit + h % base) % base
        out = out + digit.to(torch.float32) * factor
        index = index // base
    return torch.clamp(out, max=_rng.ONE_MINUS_EPS)


def halton_sample(index, dim: int, perm_seed=None):
    """Halton point coordinate of dimension `dim` (an int)."""
    base = int(PRIMES[dim])
    if base == 2 and perm_seed is None:
        return radical_inverse_base2(index)
    seed = None if perm_seed is None else _rng.hash_combine(perm_seed, dim)
    return radical_inverse(index, base, perm_seed=seed)


# ---------------------------------------------------------------------------
# (0,2)-sequence and generator matrices (reference: lowdiscrepancy.h
# Sample02 / VanDerCorput / MultiplyGenerator, the zerotwosequence and
# maxmin samplers)
# ---------------------------------------------------------------------------

_MAXMIN_NP = np.load(os.path.join(DATA_DIR, "maxmindist.npz"))["C"]


def maxmin_matrix(log2_spp):
    """CMaxMinDist generator matrix for 2^log2_spp samples (the
    reference's data constants, lowdiscrepancy.cpp:249)."""
    return _MAXMIN_NP[min(max(log2_spp, 0), 16)]


def generator_matrix_sample(index, matrix_rows, scramble=None):
    """XOR of the matrix rows (32 uint32, numpy) that the bits of `index`
    select, xor-scrambled, as a float in [0, 1)."""
    idx = _rng.u32(index)
    v = torch.zeros_like(idx)
    for b in range(32):
        row = int(matrix_rows[b])
        if row:
            v = v ^ (((idx >> b) & 1) * row)
    if scramble is not None:
        v = v ^ _rng.u32(scramble)
    return _to_unit(v)


def sample_02(index, scramble_x, scramble_y):
    """2D (0,2)-sequence point with xor scrambles (32-bit words)."""
    index = _rng.u32(index)
    x_bits = _rng.reverse_bits32(index) ^ _rng.u32(scramble_x)
    y_bits = (sobol_u32(index, 1) << 2) ^ _rng.u32(scramble_y)
    return _to_unit(x_bits), _to_unit(y_bits)


# ---------------------------------------------------------------------------
# the reference's GlobalSampler index map (plain Sobol', sobol.cpp)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sobol_global_tables(m, n_frame_bits=None):
    """Per-resolution tables for the pbrt GlobalSampler index map (numpy;
    a copy of pbrt_tpu.core.lds.sobol_global_tables).

    Returns a dict with uint32 arrays gx [m], gy [m], gf [n_frame_bits]:
      q = XOR_k(px bit k ? gx[k]) ^ XOR_k(py bit k ? gy[k])
          ^ XOR_l(frame bit l ? gf[l])
      index = (frame << 2m) | q
    Requires 2m + n_frame_bits <= 30 (the table has 30 columns).  The
    arrays are cached and shared: callers must not write to them.
    """
    if n_frame_bits is None:
        n_frame_bits = SOBOL_BITS - 2 * m   # max spp = 2^this
    if m == 0:
        return dict(gx=np.zeros(1, np.uint32), gy=np.zeros(1, np.uint32),
                    gf=np.zeros(n_frame_bits, np.uint32), m=0)
    if 2 * m + n_frame_bits > SOBOL_BITS:
        raise ValueError(
            f"sobol_global_tables: 2*{m}+{n_frame_bits} > {SOBOL_BITS} "
            "index bits (lower spp or resolution)")
    # 32-bit columns of dims 0/1 (table rows are v_k << (SOBOL_BITS-1-k))
    cx = _SOBOL_NP[0].astype(np.uint64) << 2
    cy = _SOBOL_NP[1].astype(np.uint64) << 2

    def top_bits(col):
        # bit k (k=0 LSB) of the m-bit pixel coordinate = bit 32-m+k of col
        return [(int(col) >> (32 - m + k)) & 1 for k in range(m)]

    # M: rows = 2m equations (m for x, m for y), cols = 2m unknown q bits
    M = np.zeros((2 * m, 2 * m), np.uint8)
    for j in range(2 * m):
        tx, ty = top_bits(cx[j]), top_bits(cy[j])
        for k in range(m):
            M[k, j] = tx[k]
            M[m + k, j] = ty[k]
    # invert M over GF(2)
    A = np.concatenate([M, np.eye(2 * m, dtype=np.uint8)], 1)
    for col in range(2 * m):
        piv = next(r for r in range(col, 2 * m) if A[r, col])
        A[[col, piv]] = A[[piv, col]]
        for r in range(2 * m):
            if r != col and A[r, col]:
                A[r] ^= A[col]
    Minv = A[:, 2 * m:]
    # q = Minv @ rhs: the q pattern each rhs bit contributes
    col_for_rhs = np.zeros(2 * m, np.uint32)
    for r in range(2 * m):
        col_for_rhs[r] = sum(1 << j for j in range(2 * m) if Minv[j, r])
    # rhs for px bit k is e_k (rows 0..m-1); for py bit k is e_{m+k}
    gx = col_for_rhs[:m].copy()
    gy = col_for_rhs[m:].copy()
    # frame bit l (index bit 2m+l) adds its columns' top bits to the rhs
    gf = np.zeros(n_frame_bits, np.uint32)
    for l in range(n_frame_bits):
        tx, ty = top_bits(cx[2 * m + l]), top_bits(cy[2 * m + l])
        q = 0
        for r in range(m):
            if tx[r]:
                q ^= int(col_for_rhs[r])
            if ty[r]:
                q ^= int(col_for_rhs[m + r])
        gf[l] = q
    return dict(gx=gx, gy=gy, gf=gf, m=m)


def sobol_global_index(frame, px, py, m):
    """Sobol' index (int64 tensor of 32-bit words) of pixel-sample `frame`
    at pixel (px, py) on a 2^m raster: the reference's
    SobolIntervalToIndex, from sobol_global_tables.  frame, px, py are
    int64 tensors (or ints) that broadcast together."""
    frame, px, py = (torch.as_tensor(x, dtype=torch.int64)
                     for x in (frame, px, py))
    if m == 0:
        return frame & _rng.M32
    tabs = sobol_global_tables(m)
    q = torch.zeros(torch.broadcast_shapes(frame.shape, px.shape, py.shape),
                    dtype=torch.int64, device=px.device)
    for k in range(m):
        q = q ^ (((px >> k) & 1) * int(tabs["gx"][k]))
        q = q ^ (((py >> k) & 1) * int(tabs["gy"][k]))
    for l, g in enumerate(tabs["gf"]):
        q = q ^ (((frame >> l) & 1) * int(g))
    return ((frame << (2 * m)) | q) & _rng.M32


def sobol_sample_pbrt(index, dim):
    """Plain (unscrambled) Sobol' float exactly as the reference's
    SobolSample(index, dim) (lowdiscrepancy.h:259, scramble = 0).  dim is
    an int, or an int64 tensor of index's shape (a dimension per lane)."""
    bits = (sobol_u32(index, dim) if isinstance(dim, int)
            else sobol_u32_lanes(index, dim))
    x = (bits << (32 - SOBOL_BITS)) & _rng.M32
    f = x.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=_rng.ONE_MINUS_EPS)
