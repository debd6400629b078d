"""Counter-based RNG primitives (port of pbrt_tpu.core.rng).

The JAX package does all of this in uint32.  Torch has no uint32 shifts
or adds on the CPU, so 32-bit words ride in int64 tensors holding values
in [0, 2^32) and every step masks with `& 0xFFFFFFFF`.  The results are
bit-identical to the JAX hashes.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = 0.99999994      # reference: pbrt.h OneMinusEpsilon


def u32(x):
    """A python int or int64 tensor reduced to its low 32 bits."""
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def mul32(x, c: int):
    """Low 32 bits of x * c for 32-bit x and constant c.

    x * c can reach 2^64 when c >= 2^31, overflowing int64, so the
    product is formed from c's 16-bit halves: both partial products stay
    below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg_hash(x):
    """PCG output permutation on a 32-bit state (O'Neill, pcg-random.org)."""
    x = u32(x)
    state = (mul32(x, 747796405) + 2891336453) & M32
    word = mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(*xs):
    """Mix several 32-bit counters into one well-distributed word."""
    h = 0x9E3779B9
    for x in xs:
        h = pcg_hash(h ^ u32(x))
    return h


def laine_karras_permutation(x, seed):
    """Owen-scramble hash over reversed bits (Laine & Karras 2011 /
    Burley 2020).  Three of its constants exceed 2^31: see mul32."""
    x = (u32(x) + u32(seed)) & M32
    x = x ^ mul32(x, 0x6c50b47c)
    x = x ^ mul32(x, 0xb82f1e52)
    x = x ^ mul32(x, 0xc7afe638)
    x = x ^ mul32(x, 0x8d22f6e6)
    return x


def reverse_bits32(x):
    x = u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def owen_scramble(x_bits, seed):
    """Owen-scramble a 32-bit radical-inverse value (bits already reversed)."""
    x = reverse_bits32(x_bits)
    x = laine_karras_permutation(x, seed)
    return reverse_bits32(x)


def _unit_float(bits):
    """The top 24 bits of a 32-bit word as a float in [0, 1), clamped to
    OneMinusEpsilon (the reference's rng.h UniformFloat)."""
    return torch.clamp((bits >> 8).to(torch.float32) * (1.0 / 16777216.0),
                       max=ONE_MINUS_EPS)


def uniform_u32(*counters):
    return hash_combine(*counters)


def uniform_float(*counters):
    """U[0,1) from counters; 24 mantissa bits (reference rng.h UniformFloat)."""
    return _unit_float(hash_combine(*counters))


def uniform_float2(*counters):
    """Two decorrelated U[0,1) from one counter set."""
    h = hash_combine(*counters)
    return _unit_float(h), _unit_float(pcg_hash(h ^ 0x68bc21eb))
