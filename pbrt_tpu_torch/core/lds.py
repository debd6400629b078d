"""Owen-scrambled Sobol' samples as pure counter-based functions
(port of the Sobol' part of pbrt_tpu.core.lds).

Direction numbers come from the JAX package's `data/sobol_matrices.npy`
([1024, 30] uint32), read by path.  Words ride in int64 (see core/rng.py).
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


def sobol_sample(index, dim: int, scramble_seed=None):
    """Sobol' float in [0,1); scramble_seed (32-bit words) Owen-scrambles."""
    x = (sobol_u32(index, dim) << (32 - SOBOL_BITS)) & _rng.M32
    if scramble_seed is not None:
        x = _rng.owen_scramble(x, scramble_seed)
    f = x.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=_rng.ONE_MINUS_EPS)
