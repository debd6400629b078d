"""Spectral path integrator with chromatic-aberration bands (port of
pbrt_tpu.integrators.spectralpath; fork feature:
src/integrators/spectralpath.cpp).

The reference traces `numCABands` camera rays per sample, each tagged
with a band-centre wavelength, and stitches each band's slice of the
returned spectrum into the pixel (spectralpath.cpp:233-318).  Here each
band is one `trace_paths` over the band's camera rays, tagged with its
wavelength and with transport confined to its bins by `wavelength_mask`;
each band runs its own Russian roulette on its masked beta.

Projective rays do not depend on the wavelength, so every band reuses
the camera rays.  A lens camera regenerates each band's rays at the
band's centre wavelength from the same pixel, lens and time samples
(dispersion, spectral IoR); the film weight stays the 550 nm ray's, as
in the JAX package.  The regenerated rays keep each lane's time sample,
where the JAX package regenerates them at the shutter's opening: a
moving scene keeps its motion blur (a recorded deviation; a static scene
renders the same in both).
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.cameras.lens import LensCamera
from pbrt_tpu_torch.cameras.projective import ProjectiveCamera
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators import path as pathmod


def band_slices(num_bands):
    """The 31 bins cut into contiguous bands (spectralpath.cpp:252-318):
    [(lo, hi, centre wavelength nm)]."""
    edges = np.linspace(0, spec.N_SPECTRAL_SAMPLES, num_bands + 1)
    out = []
    for i in range(num_bands):
        lo, hi = int(edges[i]), int(edges[i + 1])
        out.append((lo, hi, float(np.mean(spec.BIN_CENTERS[lo:hi]))))
    return out


def make_trace_spectral(num_ca_bands=4, camera=None, generate_rays=None,
                        width=None, height=None):
    """A trace function for path.render; its keywords beyond max_depth
    go to each band's trace_paths.  camera: the render's camera, when
    known.  A lens camera's rays are regenerated per band by
    generate_rays (default: the camera's, path.generate_fn) for a film of
    width x height; projective rays are reused."""
    if camera is not None and not isinstance(camera, (ProjectiveCamera,
                                                      LensCamera)):
        raise NotImplementedError(
            f"spectralpath with a {type(camera).__name__} camera: only "
            "projective and lens cameras are ported")
    regen = isinstance(camera, LensCamera)
    if regen:
        if width is None or height is None:
            raise ValueError("spectralpath with a lens camera needs the "
                             "film's width and height")
        generate_rays = generate_rays or pathmod.generate_fn(camera)
    bands = band_slices(num_ca_bands)

    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=5, **kw):
        B = ray.o.shape[0]
        NS = spec.N_SPECTRAL_SAMPLES
        L = torch.zeros((B, NS), device=ray.o.device)
        if regen:
            # the counter-based sampler gives the camera's samples again
            samples = pathmod.camera_samples(cfg, width, pixel_id,
                                             sample_idx)
        for lo, hi, lam in bands:
            mask = torch.zeros(NS, device=ray.o.device)
            mask[lo:hi] = 1.0
            if regen:
                band_ray, _ = generate_rays(camera, *samples, width=width,
                                            height=height, wavelength=lam)
                # lanes the camera batch padded or lost stay dead
                band_ray = band_ray.replace(tmax=torch.where(
                    ray.tmax > 0, band_ray.tmax, -1.0))
            else:
                band_ray = ray.replace(
                    wavelength=torch.full_like(ray.tmax, lam))
            Lb = pathmod.trace_paths(scene, band_ray, pixel_id, sample_idx,
                                     cfg, max_depth=max_depth,
                                     wavelength_mask=mask.expand(B, NS),
                                     **kw)
            # stitch only this band's slice (spectralpath.cpp:310-316)
            L = L + Lb * mask
        return L

    return trace
