"""The plain reference of the port's inverse-rendering step: the loss of
one sample a pixel over every pixel against a target image, its
gradients with respect to the materials' diffuse albedo and the area
light's emission through torch autograd over `path.py`'s estimator, and
optax's Adam with the parameters clamped to >= 0 after each update.

The hit search is not differentiated (visibility is a step function), as
in the port; every sampling decision is detached.  The steps start from
the scene's own spectra scaled by 0.5 (albedo) and 0.7 (emission), as
the traffic says.
"""

from __future__ import annotations

import torch

from benchmark.reference import path as P

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(T: P.Tables, kd_scale, light_scale):
    """The starting parameters, worked out from the reference's scene."""
    return {"mat_kd": (T.kd * kd_scale).detach(),
            "light_L": (T.light_L * light_scale)[None, :].detach()}


def loss_and_grads(T, params, target, pixels, index, seed, W, H, depth,
                   lanes=1 << 17):
    """(loss, {name: gradient}) of one sample index over `pixels`."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    T.kd = p["mat_kd"]
    T.light_L = p["light_L"][0]
    n = pixels.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=T.dev)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for s in range(0, n, lanes):
        px = pixels[s:s + lanes]
        idx = torch.full_like(px, index)
        L = P.trace(T, px, idx, seed, W, H, depth)
        part = ((L - target[px]) ** 2).sum() / (n * L.shape[1])
        g = torch.autograd.grad(part, list(p.values()), allow_unused=True)
        for k, gk in zip(p, g):
            if gk is not None:
                grads[k] += gk
        total += part.detach().double()
    return float(total), grads


def adam(params, grads, state, lr):
    """One step in optax's order, then the clamp to >= 0."""
    t = state["count"] + 1
    out, mu, nu = {}, {}, {}
    for k, v in params.items():
        mu[k] = (1 - B1) * grads[k] + B1 * state["mu"][k]
        nu[k] = (1 - B2) * grads[k] ** 2 + B2 * state["nu"][k]
        upd = (mu[k] / (1 - B1 ** t)) / (torch.sqrt(nu[k] / (1 - B2 ** t))
                                         + EPS)
        out[k] = torch.clamp(v - lr * upd, min=0.0)
    return out, {"count": t, "mu": mu, "nu": nu}


def follow(T, target, pixels, first_index, steps, seed, W, H, depth,
           kd_scale, light_scale, lr):
    """The reference's first `steps` steps: (losses, first gradients'
    norms by leaf, the parameters' change after the steps by leaf)."""
    params = leaves(T, kd_scale, light_scale)
    start = {k: v.clone() for k, v in params.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(v)
                                for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    losses, g_norm = [], None
    for k in range(steps):
        loss, grads = loss_and_grads(T, params, target, pixels,
                                     first_index + k, seed, W, H, depth)
        losses.append(loss)
        if g_norm is None:
            g_norm = {n: float(g.double().norm()) for n, g in grads.items()}
        with torch.no_grad():
            params, state = adam(params, grads, state, lr)
    change = {n: float((params[n] - start[n]).double().norm())
              for n in params}
    return losses, g_norm, change
