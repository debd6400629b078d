"""The sampler the port's renders draw from, written out plainly: each
sample is a pure function of (pixel, sample index, dimension, seed).

Owen-scrambled Sobol' (Burley 2020): the Sobol' bits of the sample index
in the dimension's direction numbers (Joe and Kuo's, as pbrt-v3's
sobolmatrices.cpp lists them; `data/sobol_matrices.npy`), then a
Laine-Karras scramble over reversed bits keyed by a PCG hash of
(pixel, dimension, seed).  32-bit words ride in int64 tensors, masked
after every step.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = 0.99999994
SOBOL_BITS = 30
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(maxsize=None)
def sobol_matrices():
    """[1024, 30] direction numbers (bit j of the index -> column j)."""
    return np.load(os.path.join(_DATA, "sobol_matrices.npy")).astype(
        np.int64)


def _mul32(x, c):
    # low 32 bits of x * c without overflowing int64
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg_hash(x):
    x = x & M32
    state = (_mul32(x, 747796405) + 2891336453) & M32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def hash_combine(*xs):
    h = 0x9E3779B9
    for x in xs:
        h = pcg_hash(h ^ (x & M32))
    return h


def _reverse32(x):
    x = x & M32
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def _laine_karras(x, seed):
    x = (x + seed) & M32
    for c in (0x6c50b47c, 0xb82f1e52, 0xc7afe638, 0x8d22f6e6):
        x = x ^ _mul32(x, c)
    return x


def sample(pixel, index, dim, seed, dtype=torch.float32):
    """[B] samples in [0, 1) of dimension `dim` (a python int) for pixel
    ids and sample indices (int64 tensors)."""
    cols = sobol_matrices()[dim % 1024]
    x = torch.zeros_like(index)
    for j in range(SOBOL_BITS):
        x = x ^ (((index >> j) & 1) * int(cols[j]))
    x = (x << (32 - SOBOL_BITS)) & M32
    scramble = hash_combine(pixel, torch.full_like(pixel, dim),
                            torch.full_like(pixel, seed & M32))
    x = _reverse32(_laine_karras(_reverse32(x), scramble))
    f = x.to(torch.float32) * 2.3283064365386963e-10
    return torch.clamp(f, max=ONE_MINUS_EPS).to(dtype)


def uniform(pixel, index, salt, dtype=torch.float32):
    """[B] uniform floats of the counters (pixel, index, salt): a PCG hash
    of the three, its top 24 bits scaled into [0, 1) (pbrt-v3's
    UniformFloat resolution)."""
    h = hash_combine(pixel, index, torch.full_like(pixel, salt & M32))
    f = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp(f, max=ONE_MINUS_EPS).to(dtype)
