"""Film checkpoint and resume (port of pbrt_tpu.film.checkpoint; the
reference writes its film only at the end of Render, integrator.cpp:341).

The film is four tensors and a count of completed samples per pixel, so
a render can stop and resume: the samplers are pure functions of (pixel,
sample index, dimension), so restarting at sample s replays exactly the
stream the uninterrupted render would have used.

Format: one .npz, the JAX package's layout: the film arrays `weighted`,
`weight`, `raw` and `splat`, `completed_spp`, and a fingerprint of
(scene, sampler, spp, depth, resolution) so that a checkpoint is never
resumed against another render.  Each package reads the other's files.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch

log = logging.getLogger("pbrt_tpu_torch")

_FIELDS = ("weighted", "weight", "raw", "splat")
_VERSION = 1


def render_fingerprint(scene, cfg, spp, max_depth, width, height):
    """Cheap structural hash: shapes and the first 64 values of a few
    columns, not the whole arrays (scenes can be tens of MB).  The same
    bytes as the JAX package's for columns of the same bytes."""
    h = hashlib.sha256()
    h.update(f"v{_VERSION}|{cfg.kind}|{cfg.seed}|{spp}|{max_depth}|"
             f"{width}x{height}|".encode())
    for name in ("tri_v0", "mat_kd", "light_L"):
        a = getattr(scene, name).detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a.ravel()[:64]).tobytes())
    return h.hexdigest()[:16]


def save(path, film, completed_spp, fingerprint):
    """Copy the film to the host and write it atomically (a temporary
    file renamed into place), so that a stop mid-save never corrupts the
    previous checkpoint.  The caller synchronises the card first when
    other streams write the film (render does)."""
    tmp = path + ".tmp"
    arrays = {k: getattr(film, k).detach().cpu().numpy() for k in _FIELDS}
    np.savez(tmp, completed_spp=np.int64(completed_spp),
             fingerprint=np.bytes_(fingerprint.encode()), **arrays)
    # numpy appends .npz to names without it
    if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)
    log.info("checkpoint: saved %d spp -> %s", completed_spp, path)


def load(path, film, fingerprint):
    """Restore the film from `path` into its own tensors (copy_, on their
    device) and return (film, completed spp).  A missing file, another
    render's fingerprint, a shape that differs or an unreadable file
    leaves the film as it was and returns 0 with a warning (a fresh
    start), never an error."""
    if not os.path.exists(path):
        return film, 0
    try:
        with np.load(path) as z:
            fp = bytes(z["fingerprint"]).decode()
            if fp != fingerprint:
                log.warning("checkpoint %s is for a different render "
                            "(%s != %s) — starting fresh", path, fp,
                            fingerprint)
                return film, 0
            completed = int(z["completed_spp"])
            saved = {k: z[k] for k in _FIELDS}
        for k in _FIELDS:
            if saved[k].shape != tuple(getattr(film, k).shape):
                log.warning("checkpoint %s: %s shape mismatch — "
                            "starting fresh", path, k)
                return film, 0
    except Exception as e:  # corrupt file -> fresh start
        log.warning("checkpoint %s unreadable (%s) — starting fresh",
                    path, e)
        return film, 0
    for k in _FIELDS:
        dst = getattr(film, k)
        dst.copy_(torch.from_numpy(saved[k]).to(dst.dtype))
    log.info("checkpoint: resuming %s at %d completed spp", path, completed)
    return film, completed
