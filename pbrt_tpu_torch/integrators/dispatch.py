"""Integrator selection (port of pbrt_tpu.integrators.dispatch; reference
dispatch: api.cpp:1764-1789).

Ported: "path" (parameter lightsamplestrategy: "uniform", "power" or
"spatial", any other name meaning "spatial", as in the JAX package),
"spectralpath" (parameter numCABands; it samples lights uniformly, as the
JAX package's does) and "metadata" (parameter strategy).  Every other
integrator name raises NotImplementedError, as do the render settings the
port does not carry (a crop window, a sample-luminance clamp, an
rrthreshold other than 1).
"""

from __future__ import annotations

from pbrt_tpu_torch.integrators import metadata
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.integrators import spectralpath

INTEGRATORS = ("path", "spectralpath", "metadata")
LIGHT_STRATEGIES = ("uniform", "power", "spatial")


def light_strategy(integrator_params):
    """The path integrator's light strategy: lightsamplestrategy when it
    is one of LIGHT_STRATEGIES, else (pbrt's default too) "spatial"."""
    s = integrator_params.get("lightsamplestrategy", "spatial")
    return s if s in LIGHT_STRATEGIES else "spatial"


def render_with_integrator(job, camera, film, cfg, spp, max_depth,
                           max_rays_per_pass=1 << 18, count_rays=False):
    """Render job.scene into `film` with the job's integrator.  Returns
    the film, or (film, rays traced or None) with count_rays: only the
    path integrator counts its rays."""
    kind = job.integrator_kind
    if kind not in INTEGRATORS:
        raise NotImplementedError(
            f'Integrator "{kind}" is not ported to pbrt_tpu_torch')
    ip = job.integrator_params
    if ip.get("rrthreshold", 1.0) != pathmod.RR_THRESHOLD:
        raise NotImplementedError("rrthreshold other than "
                                  f"{pathmod.RR_THRESHOLD} is not ported")
    if tuple(job.crop_window) != (0.0, 1.0, 0.0, 1.0):
        raise NotImplementedError("cropwindow is not ported")
    if job.max_sample_luminance < 1e30:
        raise NotImplementedError("maxsampleluminance is not ported")
    trace_fn = None
    trace_kwargs = {}
    gen = pathmod.generate_fn(camera)
    if kind == "path":
        trace_kwargs["light_strategy"] = light_strategy(ip)
    elif kind == "spectralpath":
        trace_fn = spectralpath.make_trace_spectral(
            num_ca_bands=ip.get("numCABands", 4), camera=camera,
            generate_rays=gen, width=film.width, height=film.height)
    elif kind == "metadata":
        trace_fn = metadata.make_trace_metadata(ip.get("strategy", "depth"))
    return pathmod.render(job.scene, camera, film, cfg, spp,
                          max_depth=max_depth,
                          max_rays_per_pass=max_rays_per_pass,
                          count_rays=count_rays, trace_fn=trace_fn,
                          generate_rays=gen, trace_kwargs=trace_kwargs)
