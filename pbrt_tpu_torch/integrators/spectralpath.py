"""Spectral path integrator with chromatic-aberration bands (port of
pbrt_tpu.integrators.spectralpath; fork feature:
src/integrators/spectralpath.cpp).

The reference traces `numCABands` camera rays per sample, each tagged
with a band-centre wavelength, and stitches each band's slice of the
returned spectrum into the pixel (spectralpath.cpp:233-318).  Here each
band is one `trace_paths` over the camera rays, tagged with the band's
wavelength and with transport confined to its bins by `wavelength_mask`.
Projective rays do not depend on the wavelength, so every band reuses
them; each band runs its own Russian roulette on its masked beta.

Lens cameras regenerate their rays per band at the band's wavelength
(dispersion); they wait for the port's lens cameras.
"""

from __future__ import annotations

import numpy as np
import torch

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


def make_trace_spectral(num_ca_bands=4, camera=None):
    """A trace function for path.render.  camera: the render's camera,
    when known; only projective cameras are ported."""
    if camera is not None and not isinstance(camera, ProjectiveCamera):
        raise NotImplementedError(
            "spectralpath regenerates a lens camera's rays per band at the "
            "band's wavelength; lens cameras are not ported")
    bands = band_slices(num_ca_bands)

    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=5):
        B = ray.o.shape[0]
        NS = spec.N_SPECTRAL_SAMPLES
        L = torch.zeros((B, NS), device=ray.o.device)
        for lo, hi, lam in bands:
            mask = torch.zeros(NS, device=ray.o.device)
            mask[lo:hi] = 1.0
            band_ray = ray.replace(wavelength=torch.full_like(ray.tmax, lam))
            Lb = pathmod.trace_paths(scene, band_ray, pixel_id, sample_idx,
                                     cfg, max_depth=max_depth,
                                     wavelength_mask=mask.expand(B, NS))
            # stitch only this band's slice (spectralpath.cpp:310-316)
            L = L + Lb * mask
        return L

    return trace
