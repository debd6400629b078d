"""Metadata integrator (port of pbrt_tpu.integrators.metadata; fork
feature: src/integrators/metadata.{h,cpp}).

Renders first-hit scene metadata instead of radiance: depth (the hit's
t along the camera ray), material id + 1, mesh (instance) id, or world
coordinates, written into the spectral channels as the reference does
(metadata.cpp:54-128 stores the value in a constant spectrum;
coordinates take channels 0-2, the rest stay 0).
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.ops import intersect as isect

STRATEGIES = ("depth", "material", "materialId", "mesh", "meshId",
              "instance", "coordinates", "world")


def make_trace_metadata(strategy="depth"):
    """A trace function for path.render that returns the metadata [B,31]
    of each ray's first hit (0 where it misses); other keywords are
    ignored."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown metadata strategy {strategy!r}")

    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=0, **kw):
        hit = isect.intersect_full(scene, ray)
        NS = spec.N_SPECTRAL_SAMPLES
        if strategy in ("coordinates", "world"):
            out = torch.zeros((ray.o.shape[0], NS), device=ray.o.device)
            out[:, 0:3] = torch.where(hit.valid[:, None], hit.p, 0.0)
            return out
        if strategy == "depth":
            v = torch.where(hit.valid, hit.t, 0.0)
        elif strategy in ("material", "materialId"):
            v = torch.where(hit.valid, hit.material + 1, 0).to(torch.float32)
        else:
            v = torch.where(hit.valid, hit.instance, 0).to(torch.float32)
        return v[:, None].expand(-1, NS)

    return trace
