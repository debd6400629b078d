"""Stateless counter-based samplers (port of pbrt_tpu.samplers.samplers).

    sample_dim(cfg, pixel_id, sample_idx, dim) -> [B] floats in [0,1)

Every sample is a pure function of (pixel, sample, dim), as in the JAX
package.  Only the Owen-scrambled Sobol' sampler is ported so far.
"""

from __future__ import annotations

from typing import NamedTuple

from pbrt_tpu_torch.core import lds, rng


class SamplerConfig(NamedTuple):
    kind: str = "sobol"
    seed: int = 0
    spp: int = 16


def sample_dim(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """pixel_id, sample_idx: int64 tensors of 32-bit words; dim: int."""
    if cfg.kind != "sobol":
        raise NotImplementedError(
            f"sampler {cfg.kind!r} is not ported yet (only 'sobol')")
    scramble = rng.hash_combine(pixel_id, dim, rng.u32(cfg.seed))
    return lds.sobol_sample(rng.u32(sample_idx), dim % lds.N_SOBOL_DIMS,
                            scramble_seed=scramble)
