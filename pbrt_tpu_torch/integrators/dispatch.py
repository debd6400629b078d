"""Integrator selection (port of pbrt_tpu.integrators.dispatch; reference
dispatch: api.cpp:1764-1789).

Ported:
- "path" (parameter lightsamplestrategy: "uniform", "power" or
  "spatial", any other name meaning "spatial", as in the JAX package);
- "volpath": integrators/volpath.py when the scene has a medium; without
  one, path with the uniform strategy (the JAX package passes none);
- "whitted" (integrators/whitted.py);
- "directlighting": path at depth min(maxdepth, 1), with the "all"
  strategy when its parameter strategy is "all", else lightsamplestrategy's
  (directlighting.cpp:112; through the parser, whose strategy default is
  "depth", that means lightsamplestrategy's);
- "ambientocclusion" / "ao" (integrators/ao.py, parameter cossample);
- "spectralpath" (parameter numCABands; it samples lights uniformly, as
  the JAX package's does) and "metadata" (parameter strategy).

The JAX package's other integrators ("lighttracer", "bdpt", "sppm",
"mlt") raise NotImplementedError naming themselves; a name neither
package knows renders path with a warning and the uniform strategy, as
in the JAX package.

The Film's crop window and maxsampleluminance go to `render`, as the
JAX package passes them.  An integrator's rrthreshold is read by the
parser but reaches no trace function in the JAX package, which renders
with Russian roulette's threshold at 1: so does the port, with a warning
that names the ignored value.
"""

from __future__ import annotations

import logging

from pbrt_tpu_torch.film.film import INF_LUMINANCE
from pbrt_tpu_torch.integrators import ao
from pbrt_tpu_torch.integrators import metadata
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.integrators import spectralpath
from pbrt_tpu_torch.integrators import volpath
from pbrt_tpu_torch.integrators import whitted

log = logging.getLogger("pbrt_tpu_torch")

INTEGRATORS = ("path", "volpath", "whitted", "directlighting",
               "ambientocclusion", "ao", "spectralpath", "metadata")
# the JAX package's integrators that are not ported yet
UNPORTED = ("lighttracer", "bdpt", "sppm", "mlt")
LIGHT_STRATEGIES = ("uniform", "power", "spatial")


def light_strategy(integrator_params):
    """The path integrator's light strategy: lightsamplestrategy when it
    is one of LIGHT_STRATEGIES, else (pbrt's default too) "spatial"."""
    s = integrator_params.get("lightsamplestrategy", "spatial")
    return s if s in LIGHT_STRATEGIES else "spatial"


def integrator_trace(job, camera, width, height, max_depth):
    """(trace_fn or None for trace_paths, its keywords beyond its own,
    max_depth) of the job's integrator, as render_with_integrator renders
    it."""
    kind = job.integrator_kind
    if kind in UNPORTED:
        raise NotImplementedError(
            f'Integrator "{kind}" is not ported to pbrt_tpu_torch')
    ip = job.integrator_params
    trace_fn = None
    trace_kwargs = {}
    if kind == "volpath":
        if job.media:
            trace_fn = volpath.make_trace_volpath(job)
    elif kind == "directlighting":
        max_depth = min(max_depth, 1)
        trace_kwargs["light_strategy"] = (
            "all" if ip.get("strategy", "all") == "all"
            else light_strategy(ip))
    elif kind == "whitted":
        trace_fn = whitted.make_trace_whitted()
    elif kind in ("ambientocclusion", "ao"):
        trace_fn = ao.make_trace_ao(cos_sample=ip.get("cossample", True))
    elif kind == "spectralpath":
        trace_fn = spectralpath.make_trace_spectral(
            num_ca_bands=ip.get("numCABands", 4), camera=camera,
            generate_rays=pathmod.generate_fn(camera), width=width,
            height=height)
    elif kind == "metadata":
        trace_fn = metadata.make_trace_metadata(ip.get("strategy", "depth"))
    elif kind == "path":
        trace_kwargs["light_strategy"] = light_strategy(ip)
    else:
        # trace_paths' own strategy, "uniform", as in the JAX package
        log.warning("unknown integrator %r; using path", kind)
    return trace_fn, trace_kwargs, max_depth


def render_with_integrator(job, camera, film, cfg, spp, max_depth,
                           max_rays_per_pass=1 << 18, count_rays=False):
    """Render job.scene into `film` with the job's integrator.  Returns
    the film, or (film, rays traced or None) with count_rays: only the
    integrators that run trace_paths count their rays."""
    ip = job.integrator_params
    trace_fn, trace_kwargs, max_depth = integrator_trace(
        job, camera, film.width, film.height, max_depth)
    rr = ip.get("rrthreshold", pathmod.RR_THRESHOLD)
    if rr != pathmod.RR_THRESHOLD:
        log.warning("rrthreshold %g is ignored: Russian roulette starts "
                    "below a throughput of %g, as in the JAX package", rr,
                    pathmod.RR_THRESHOLD)
    msl = job.max_sample_luminance
    return pathmod.render(job.scene, camera, film, cfg, spp,
                          max_depth=max_depth,
                          max_rays_per_pass=max_rays_per_pass,
                          count_rays=count_rays, trace_fn=trace_fn,
                          generate_rays=pathmod.generate_fn(camera),
                          trace_kwargs=trace_kwargs,
                          crop_window=job.crop_window,
                          max_sample_luminance=(None if msl >= INF_LUMINANCE
                                                else msl))
