"""Differentiable rendering on torch autograd (port of
pbrt_tpu.integrators.diff).

Reverse-mode pixel gradients with respect to scene parameters (material
albedo and emission spectra, the env map, the camera's pose and field of
view) through the wavefront path loop.  The bounce loop is unrolled in
Python, so autograd records the whole estimator; discrete sampling
decisions (lobe choice, Russian roulette, visibility) are step functions
with zero gradient: the detached-sampling estimator, unbiased for albedo
and emission parameters.  The hit search runs under `torch.no_grad()`
(ops/intersect.py), so the dense kernels run in the forward only and the
backward launches none of them; gradients reach the camera through
`make_hit`'s f32 re-solve of the winner and the hit point o + t d.

The differentiable leaves are plain `SceneData` fields that the shading
code reads directly (mat_kd / ks / kr / kt in `gather_materials`,
light_L in `sample_li` / `area_le`, env_map in the env lookups), so
`apply_params` replaces them and nothing else.  Tables built from them
at scene build (the light strategies' power tables, the env map's
sampling cdfs and `env_lum`) stay fixed, as in the JAX package.

`make_train_step` is inverse rendering with Adam (optax.adam's defaults:
b1 0.9, b2 0.999, eps 1e-8 added after the square root), each update
followed by a clamp to >= 0 of every parameter but the camera's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.utils.stats import span

# scene leaves that are differentiable targets
DIFFERENTIABLE_FIELDS = ("mat_kd", "mat_ks", "mat_kr", "mat_kt", "light_L",
                         "env_map")

# camera parameters:
#   cam_delta [6] - se(3) pose perturbation (rx,ry,rz, tx,ty,tz) composed
#                   onto cam_to_world
#   cam_fov   []  - perspective field of view in degrees
CAMERA_PARAM_KEYS = ("cam_delta", "cam_fov")


def _skew(v):
    z = v.new_zeros(())
    return torch.stack([z, -v[2], v[1], v[2], z, -v[0],
                        -v[1], v[0], z]).reshape(3, 3)


def _so3_exp(r):
    """Rodrigues: axis-angle [3] -> rotation matrix [3,3]; differentiable
    at r = 0 too, where it takes the first-order form I + skew(r) (the
    branch not taken gets a zero cotangent, and 1/theta stays finite)."""
    theta2 = torch.sum(r * r)
    theta = torch.sqrt(theta2 + 1e-20)
    K = _skew(r / theta)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta2 > 1e-12, R, eye + _skew(r))


def _se3_matrix(delta):
    """[6] (rx,ry,rz,tx,ty,tz) -> [4,4] rigid transform."""
    top = torch.cat([_so3_exp(delta[:3]), delta[3:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=delta.dtype,
                          device=delta.device)
    return torch.cat([top, bottom], 0)


def _perspective_raster_to_camera(fov_deg, width, height):
    """Differentiable rebuild of make_perspective's raster_to_camera for a
    tensor fov (reference transform.cpp Perspective)."""
    screen = projective._screen_window(width, height)
    r2s = torch.as_tensor(np.asarray(projective._raster_to_screen(
        width, height, screen).m, np.float32), device=fov_deg.device)
    n, f = 1e-2, 1000.0
    inv_tan = 1.0 / torch.tan(torch.deg2rad(fov_deg) / 2.0)
    one = torch.ones((), device=fov_deg.device)
    zero = torch.zeros((), device=fov_deg.device)
    c2s = torch.stack([
        inv_tan, zero, zero, zero,
        zero, inv_tan, zero, zero,
        zero, zero, one * (f / (f - n)), one * (-f * n / (f - n)),
        zero, zero, one, zero]).reshape(4, 4)
    return torch.linalg.inv(c2s) @ r2s


def apply_camera_params(camera, params, width, height):
    """The camera with its pose and / or fov overridden by the
    optimization parameters."""
    if "cam_delta" in params:
        D = _se3_matrix(params["cam_delta"])
        camera = camera.replace(cam_to_world=camera.cam_to_world @ D)
    if "cam_fov" in params:
        r2c = _perspective_raster_to_camera(params["cam_fov"], width, height)
        camera = camera.replace(raster_to_camera=r2c,
                                camera_to_raster=torch.linalg.inv(r2c))
    return camera


# the spectral material leaves, broadcast to every material's row as the
# JAX package's packed table takes them (a [1, 31] albedo sets them all)
_MATERIAL_SPECTRA = ("mat_kd", "mat_ks", "mat_kr", "mat_kt")


def apply_params(scene, params):
    """The scene with its leaves replaced by the optimization parameters
    (no positivity transform: the caller keeps them >= 0).  The material
    spectra broadcast to (M, 31)."""
    shape = tuple(scene.mat_kd.shape)
    return dataclasses.replace(scene, **{
        k: torch.broadcast_to(v, shape) if k in _MATERIAL_SPECTRA else v
        for k, v in params.items()})


def render_samples(params, scene, camera, W, H, cfg: SamplerConfig,
                   pixel_ids, sample_idx, max_depth=4, generate_rays=None):
    """Trace one sample per pixel id; returns (L [B,31], pid)."""
    if generate_rays is None:
        generate_rays = projective.generate_rays
    scene2 = apply_params(scene, {k: v for k, v in params.items()
                                  if k not in CAMERA_PARAM_KEYS})
    camera = apply_camera_params(camera, params, W, H)
    ray, weight, _, pid, sidx = pathmod.camera_rays_for_pixels(
        camera, W, H, cfg, pixel_ids, sample_idx, generate_rays)
    L = pathmod.trace_paths(scene2, ray, pid, sidx, cfg, max_depth=max_depth)
    return L * weight[:, None], pid


def render_loss(params, scene, camera, W, H, cfg, pixel_ids, sample_indices,
                target, max_depth=4):
    """MSE between the estimated pixel spectra (averaged over the given
    sample indices) and target [n_pix, 31] spectra."""
    acc = 0.0
    for s in sample_indices:
        L, _ = render_samples(params, scene, camera, W, H, cfg, pixel_ids,
                              s, max_depth=max_depth)
        acc = acc + L
    mean_L = acc / len(sample_indices)
    tgt = target[pixel_ids.long() % target.shape[0]]
    return torch.mean((mean_L - tgt) ** 2)


def adam_init(params):
    """optax.adam's state for params: step count and both moments."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


@torch.no_grad()
def adam_update(params, grads, state, learning_rate, b1=0.9, b2=0.999,
                eps=1e-8):
    """One Adam step in optax's order of operations; returns (params,
    state)."""
    count = state["count"] + 1
    mu = {k: (1 - b1) * grads[k] + b1 * state["mu"][k] for k in params}
    nu = {k: (1 - b2) * grads[k] ** 2 + b2 * state["nu"][k]
          for k in params}
    out = {}
    for k, v in params.items():
        c1 = 1 - torch.tensor(b1, dtype=v.dtype) ** count
        c2 = 1 - torch.tensor(b2, dtype=v.dtype) ** count
        upd = (mu[k] / c1.to(v.device)) / (
            torch.sqrt(nu[k] / c2.to(v.device)) + eps)
        out[k] = v + (-learning_rate) * upd
    return out, {"count": count, "mu": mu, "nu": nu}


def make_train_step(scene, camera, W, H, cfg, target, max_depth=4,
                    learning_rate=5e-2):
    """Returns (init, step) for inverse rendering with Adam:
    init(params) -> state; step(params, state, pixel_ids, sample_idx) ->
    (params, state, loss).  Parameters are f32 tensors on the scene's
    device; step takes their gradients itself (the caller's tensors need
    no requires_grad) and returns them detached, the non-camera ones
    clamped to >= 0.  step's two halves are step.forward(params,
    pixel_ids, sample_idx) -> (leaves, loss) and step.backward(leaves,
    loss, state) -> (params, state)."""

    def forward(params, pixel_ids, sample_idx):
        with span("forward"):
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            return p, render_loss(p, scene, camera, W, H, cfg, pixel_ids,
                                  (sample_idx,), target, max_depth)

    def backward(p, loss, state):
        with span("backward"):
            grads = dict(zip(p, torch.autograd.grad(loss,
                                                    list(p.values()))))
        new, state = adam_update(p, grads, state, learning_rate)
        return {k: (v if k in CAMERA_PARAM_KEYS
                    else torch.maximum(v, torch.zeros((), device=v.device)))
                for k, v in new.items()}, state

    def step(params, state, pixel_ids, sample_idx):
        with span("step"):
            p, loss = forward(params, pixel_ids, sample_idx)
            new, state = backward(p, loss, state)
            return new, state, loss.detach()

    step.forward, step.backward = forward, backward
    return adam_init, step


def finite_difference_grad(loss_fn, params, key_path, idx, eps=1e-3):
    """Central finite difference of a scalar loss with respect to one
    parameter entry: the gradient-correctness harness."""

    def perturbed(delta):
        p = dict(params)
        arr = p[key_path].detach().clone()
        arr.view(-1)[idx] += delta
        p[key_path] = arr
        with torch.no_grad():
            return float(loss_fn(p))

    return (perturbed(eps) - perturbed(-eps)) / (2 * eps)
