"""Primary-sample-space Metropolis light transport (port of
pbrt_tpu.integrators.mlt; reference: src/integrators/mlt.cpp, PSSMLT).

The reference runs nChains Markov chains over lazily mutated primary
samples (MLTSampler, mlt.h:53-105).  Here every chain advances in
lockstep: the chain state is a [C, D] matrix of primary-space uniforms
(D = 5 + 9 (depth + 1), path.py's camera and bounce dimensions; later
dimensions wrap), a proposal is a Kelemen small step (an exponentially
scaled offset, wrapped mod 1) or a large step (fresh uniforms), and a
path is evaluated by `path.trace_paths` on those uniforms (its
`uniforms` hook: 1 + depth closest-hit calls, K1 and K2 on the card).
The bootstrap's mean luminance is b; chains start from bootstrap paths
resampled by luminance, and both the proposal and the current state
splat with Kelemen's MIS weights.

The counter-based draws are the JAX package's, bit for bit: its
per-dimension loops over salts salt + 131 d run here as one [C, D] hash
with a salt vector, which gives the same values (every step is
elementwise).  Each draw is prng.uniform_float(chain id, step, salt).
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import rng
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.integrators import path as pathmod

# the Kelemen small step's magnitude range: sigma * 64^-e, e in [0,1)
_LOG64 = float(np.log(np.float32(64.0)))


def n_dims(max_depth):
    """The chain state's primary-sample dimensions at max_depth."""
    return pathmod.DIM_BOUNCE_BASE + (max_depth + 1) * \
        pathmod.DIMS_PER_BOUNCE


def uniforms_for(ids, it, salt, D):
    """[C, D] draws uniform_float(ids, it, u32(salt + 131 d))."""
    salts = rng.u32(salt + 131 * torch.arange(D, dtype=torch.int64,
                                              device=ids.device))
    return rng.uniform_float(ids[:, None], it, salts[None, :])


def eval_paths(scene, camera, W, H, u, max_depth, generate_rays=None):
    """The paths of primary samples u [C, D]: (L [C,31] times the camera
    weight, pfilm [C,2] = (u0 W, u1 H)); the lens takes u2, u3, and
    trace_paths reads every other dimension from u (no sampler)."""
    if generate_rays is None:
        generate_rays = pathmod.generate_fn(camera)
    C = u.shape[0]
    pfilm = torch.stack([u[:, 0] * W, u[:, 1] * H], -1)
    ray, weight = generate_rays(camera, pfilm, u[:, 2:4], width=W, height=H)
    pid = torch.zeros(C, dtype=torch.int64, device=u.device)
    L = pathmod.trace_paths(scene, ray, pid, pid, None, max_depth=max_depth,
                            uniforms=u)
    return L * weight[:, None], pfilm


def mutate_step(scene, camera, film, state, it, b, sigma, large_step_prob,
                max_depth, generate_rays=None):
    """One lockstep mutation of every chain (mlt.cpp's inner loop):
    propose, splat the proposal and the current state with their Kelemen
    weights into film.splat in place, accept.  state = (u_cur [C,D],
    L_cur [C,31], pf_cur [C,2], I_cur [C]); returns the new state and the
    accept mask."""
    W, H = film.width, film.height
    u_cur, L_cur, pf_cur, I_cur = state
    C, D = u_cur.shape
    ids = torch.arange(C, dtype=torch.int64, device=u_cur.device)
    is_large = rng.uniform_float(ids, it, rng.u32(0x500)) < large_step_prob
    fresh = uniforms_for(ids, it, 0x900, D)
    # the small step, every dimension: an exponentially distributed
    # magnitude (Kelemen's mutation size), a random sign
    e1 = uniforms_for(ids, it, 0xA00, D)
    e2 = uniforms_for(ids, it, 0xB37, D)
    s = sigma * torch.exp(-_LOG64 * e1)
    delta = torch.where(e2 < 0.5, s * 2 * e2, -s * (2 * e2 - 1))
    u_prop = torch.where(is_large[:, None], fresh,
                         torch.remainder(u_cur + delta, 1.0))
    L_prop, pf_prop = eval_paths(scene, camera, W, H, u_prop, max_depth,
                                 generate_rays)
    I_prop = spec.luminance(L_prop)
    a = torch.clamp(I_prop / torch.clamp(I_cur, min=1e-12), 0.0, 1.0)
    # Kelemen's MIS weights of both states (mlt.cpp's splat pair)
    w_prop = (a + is_large.to(a.dtype)) / torch.clamp(
        I_prop / b + large_step_prob, min=1e-12)
    w_cur = (1.0 - a) / torch.clamp(I_cur / b + large_step_prob, min=1e-12)
    filmmod.add_splats(film, pf_prop, L_prop * w_prop[:, None])
    filmmod.add_splats(film, pf_cur, L_cur * w_cur[:, None])
    acc = rng.uniform_float(ids, it, rng.u32(0xC11)) < a
    ac = acc[:, None]
    return (torch.where(ac, u_prop, u_cur), torch.where(ac, L_prop, L_cur),
            torch.where(ac, pf_prop, pf_cur),
            torch.where(acc, I_prop, I_cur)), acc


def bootstrap(scene, camera, W, H, n_chains, n_bootstrap, max_depth,
              generate_rays=None):
    """The bootstrap (mlt.cpp Render): n_bootstrap fresh paths estimate
    b = E[luminance] (a host float), and n_chains seeds are resampled from
    them by luminance.  Returns (b, state) with state as mutate_step's, or
    (b, None) when b <= 0."""
    dev = scene.device
    D = n_dims(max_depth)
    u_boot = uniforms_for(torch.arange(n_bootstrap, dtype=torch.int64,
                                       device=dev), 0, 0x11, D)
    L_boot, _ = eval_paths(scene, camera, W, H, u_boot, max_depth,
                           generate_rays)
    I_boot = spec.luminance(L_boot)
    b = float(I_boot.mean())
    if b <= 0:
        return b, None
    cdf, fint = sampling.build_distribution_1d(I_boot)
    u_sel = rng.uniform_float(torch.arange(n_chains, dtype=torch.int64,
                                           device=dev), 7, rng.u32(0x77))
    seed_idx, _ = sampling.sample_distribution_1d_discrete(cdf, fint,
                                                           I_boot, u_sel)
    u_cur = u_boot[seed_idx]
    L_cur, pf_cur = eval_paths(scene, camera, W, H, u_cur, max_depth,
                               generate_rays)
    return b, (u_cur, L_cur, pf_cur, spec.luminance(L_cur))


def render_mlt(scene, camera, W, H, n_chains=8192, mutations_per_chain=64,
               n_bootstrap=65536, sigma=0.01, large_step_prob=0.3,
               max_depth=5, generate_rays=None):
    """Returns ([H,W,31] radiance, b): the splats normalized as the
    reference's film scale b / mutationsPerPixel (mlt.cpp Render)."""
    b, state = bootstrap(scene, camera, W, H, n_chains, n_bootstrap,
                         max_depth, generate_rays)
    film = filmmod.make_film(W, H, device=scene.device)
    if state is None:
        return film.splat, 0.0
    for it in range(mutations_per_chain):
        state, _ = mutate_step(scene, camera, film, state, it + 1, b, sigma,
                               large_step_prob, max_depth, generate_rays)
    # E_u[C_j] by the Kelemen-weighted splats over all mutations; a pixel
    # is the film's pixel count times its share of primary space
    return film.splat * (W * H / (n_chains * mutations_per_chain)), b
