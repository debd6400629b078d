"""Stateless counter-based samplers (port of pbrt_tpu.samplers.samplers).

    sample_dim(cfg, pixel_id, sample_idx, dim) -> [B] floats in [0,1)

Every sample is a pure function of (pixel, sample, dim), as in the JAX
package, with its constants and seed mixing:
  independent  PCG-hash white noise (reference: samplers/random.cpp)
  stratified   jittered strata over the sample index (stratified.cpp)
  sobol        Owen-scrambled Sobol', a scramble per pixel and dim
  halton       per-pixel scrambled Halton (halton.cpp)
  zerotwosequence  xor-scrambled (0,2)-sequence pairs (zerotwosequence.cpp)
  maxmindist   the reference's CMaxMinDist generator matrices for the
               pixel-sample pair, shuffled per pixel by a keyed index
               bijection; higher dims pad with the (0,2)-sequence
               (maxmin.cpp)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pbrt_tpu_torch.core import lds, rng
from pbrt_tpu_torch.utils.stats import span

SAMPLER_TYPES = ("independent", "random", "stratified", "sobol", "halton",
                 "zerotwosequence", "maxmindist")


class SamplerConfig(NamedTuple):
    kind: str = "sobol"
    seed: int = 0
    spp: int = 16          # samples per pixel (stratified and maxmin use it)


def _sample_02(pixel_id, sample_idx, dim, seed):
    """One coordinate of the per-pixel xor-scrambled (0,2)-sequence."""
    sx = rng.hash_combine(pixel_id, dim // 2, seed)
    sy = rng.hash_combine(pixel_id, dim // 2, seed ^ 0x94d049a9)
    x, y = lds.sample_02(sample_idx, sx, sy)
    return x if dim % 2 == 0 else y


@span("sampler")
def sample_dim(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """pixel_id, sample_idx: int64 tensors of 32-bit words; dim: int."""
    seed = rng.u32(cfg.seed)
    kind = cfg.kind
    if kind == "sobol":
        scramble = rng.hash_combine(pixel_id, dim, seed)
        return lds.sobol_sample(rng.u32(sample_idx), dim % lds.N_SOBOL_DIMS,
                                scramble_seed=scramble)
    sample_idx = rng.u32(sample_idx)
    if kind in ("independent", "random"):
        return rng.uniform_float(pixel_id, sample_idx, dim, seed)
    if kind == "stratified":
        # jittered strata along each dim, decorrelated by a permutation
        n = max(cfg.spp, 1)
        perm = rng.hash_combine(pixel_id, dim, seed) % n
        stratum = ((sample_idx + perm) & rng.M32) % n
        jitter = rng.uniform_float(pixel_id, sample_idx, dim,
                                   seed ^ 0x5bd1e995)
        return torch.clamp((stratum.to(torch.float32) + jitter) / float(n),
                           max=rng.ONE_MINUS_EPS)
    if kind == "maxmindist":
        # the pixel-sample pair is (i/spp, CMaxMinDist[log2 spp] at i)
        # with i shuffled per pixel: a rotation, then (for a power of 2)
        # an xor within the power of 2
        spp = max(cfg.spp, 1)
        log2 = (spp - 1).bit_length()
        h = rng.hash_combine(pixel_id, seed ^ 0x9d7a3c1b)
        idx = ((sample_idx + h) & rng.M32) % spp
        if spp == (1 << log2):
            idx = (idx ^ (h >> 7)) & (spp - 1)
        if dim == 0:
            return torch.clamp(idx.to(torch.float32) / float(spp),
                               max=rng.ONE_MINUS_EPS)
        if dim == 1:
            return lds.generator_matrix_sample(idx, lds.maxmin_matrix(log2))
        return _sample_02(pixel_id, sample_idx, dim, seed)
    if kind == "halton":
        perm_seed = rng.hash_combine(pixel_id, seed)
        return lds.halton_sample(sample_idx, dim % 256, perm_seed=perm_seed)
    if kind == "zerotwosequence":
        return _sample_02(pixel_id, sample_idx, dim, seed)
    raise ValueError(f"unknown sampler {kind}")


def sample_2d(cfg, pixel_id, sample_idx, dim):
    return (sample_dim(cfg, pixel_id, sample_idx, dim),
            sample_dim(cfg, pixel_id, sample_idx, dim + 1))
