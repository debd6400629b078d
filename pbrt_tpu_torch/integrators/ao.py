"""The ambient-occlusion integrator (port of pbrt_tpu.integrators.ao;
reference: src/integrators/ao.cpp): the share of a cosine-weighted (or
uniform) hemisphere around the first hit's shading normal, turned toward
the viewer, that is unoccluded within the scene's diameter, the same in
every band."""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators.path import _bdim
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim


def make_trace_ao(cos_sample=True):
    """trace_fn of one hemisphere sample a camera ray (the JAX package's
    n_samples = 1, the only count its dispatch gives)."""
    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=0, **kw):
        hit = isect.intersect_full(scene, ray, presorted=True)
        B = ray.o.shape[0]
        ss, ts = geom.coordinate_system(hit.ns)
        # the hemisphere faces the viewer (ao.cpp:68)
        n = torch.where(geom.dot(hit.ns, hit.wo)[:, None] < 0, -hit.ns,
                        hit.ns)
        u1 = sample_dim(cfg, pixel_id, sample_idx, _bdim(0, 1))
        u2 = sample_dim(cfg, pixel_id, sample_idx, _bdim(0, 2))
        if cos_sample:
            w_local = sampling.cosine_sample_hemisphere(u1, u2)
            pdf = sampling.cosine_hemisphere_pdf(w_local[..., 2])
        else:
            w_local = sampling.uniform_sample_hemisphere(u1, u2)
            pdf = torch.full((B,), 1.0 / (2 * np.pi), device=u1.device)
        w = geom.frame_to_world(ss, ts, n, w_local)
        sray = isect.spawn_ray(hit.p, hit.ng, w, ray.wavelength,
                               tmax=torch.where(hit.valid,
                                                scene.world_radius * 2.0,
                                                -1.0))
        free = ~isect.occluded(scene, sray)
        cos_t = torch.clamp(geom.dot(w, n), min=0.0)
        v = torch.where(hit.valid & free & (pdf > 0),
                        cos_t / torch.clamp(pdf * np.pi, min=1e-9), 0.0)
        return v[:, None].expand(B, spec.N_SPECTRAL_SAMPLES)
    return trace
