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

The light-side integrators (LIGHT_SIDE) render through their own
drivers, as the JAX package routes them:
- "lighttracer" (integrators/lighttracer.py) and "bdpt" (bdpt.py) fold
  their splat scale into film.splat, which develop adds (the .dat holds
  `raw` alone: a lighttracer .dat is all zeros, a bdpt .dat lacks its
  t=1 strategies, as pbrt_tpu writes them; ROADMAP);
- "sppm" (sppm.py; parameter radius, default the world radius times
  0.01) and "mlt" (mlt.py; parameters chains, bootstrapsamples, sigma,
  largestepprobability) resolve the film: weighted = raw = L, weight 1.
  As in the JAX package MLT runs max(spp, 8) * 8 mutations a chain and
  SPPM max(spp, 4) iterations; the parsed mutationsperpixel and
  iterations reach neither, and the port warns naming the ignored value.
They count no rays, and take neither the crop window nor
maxsampleluminance, as in the JAX package.

A name neither package knows renders path with a warning and the
uniform strategy, as in the JAX package.

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
from pbrt_tpu_torch.integrators import bdpt
from pbrt_tpu_torch.integrators import lighttracer
from pbrt_tpu_torch.integrators import metadata
from pbrt_tpu_torch.integrators import mlt
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.integrators import spectralpath
from pbrt_tpu_torch.integrators import sppm
from pbrt_tpu_torch.integrators import volpath
from pbrt_tpu_torch.integrators import whitted

log = logging.getLogger("pbrt_tpu_torch")

INTEGRATORS = ("path", "volpath", "whitted", "directlighting",
               "ambientocclusion", "ao", "spectralpath", "metadata")
# the integrators with drivers of their own (not trace_paths passes)
LIGHT_SIDE = ("lighttracer", "bdpt", "sppm", "mlt")
LIGHT_STRATEGIES = ("uniform", "power", "spatial")


def light_strategy(integrator_params):
    """The path integrator's light strategy: lightsamplestrategy when it
    is one of LIGHT_STRATEGIES, else (pbrt's default too) "spatial"."""
    s = integrator_params.get("lightsamplestrategy", "spatial")
    return s if s in LIGHT_STRATEGIES else "spatial"


def integrator_trace(job, camera, width, height, max_depth):
    """(trace_fn or None for trace_paths, its keywords beyond its own,
    max_depth) of the job's integrator, as render_with_integrator renders
    it; the LIGHT_SIDE integrators have none and raise ValueError."""
    kind = job.integrator_kind
    if kind in LIGHT_SIDE:
        raise ValueError(f'Integrator "{kind}" renders through its own '
                         "driver, not trace_paths passes")
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
                           max_rays_per_pass=1 << 18, count_rays=False,
                           progress=None, checkpoint_path=None,
                           checkpoint_every=60.0, stats=None):
    """Render job.scene into `film` with the job's integrator.  Returns
    the film, or (film, rays traced or None) with count_rays: only the
    integrators that run trace_paths count their rays.  progress,
    checkpoint_path, checkpoint_every and stats go to `path.render`, as
    the JAX package passes them; the LIGHT_SIDE drivers take none of
    them (the JAX package gives them progress only)."""
    ip = job.integrator_params
    rr = ip.get("rrthreshold", pathmod.RR_THRESHOLD)
    if rr != pathmod.RR_THRESHOLD:
        log.warning("rrthreshold %g is ignored: Russian roulette starts "
                    "below a throughput of %g, as in the JAX package", rr,
                    pathmod.RR_THRESHOLD)
    if job.integrator_kind in LIGHT_SIDE:
        film = render_light_side(job, camera, film, cfg, spp, max_depth)
        return (film, None) if count_rays else film
    trace_fn, trace_kwargs, max_depth = integrator_trace(
        job, camera, film.width, film.height, max_depth)
    msl = job.max_sample_luminance
    return pathmod.render(job.scene, camera, film, cfg, spp,
                          max_depth=max_depth,
                          max_rays_per_pass=max_rays_per_pass,
                          count_rays=count_rays, trace_fn=trace_fn,
                          generate_rays=pathmod.generate_fn(camera),
                          trace_kwargs=trace_kwargs,
                          crop_window=job.crop_window,
                          max_sample_luminance=(None if msl >= INF_LUMINANCE
                                                else msl),
                          progress=progress, checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every, stats=stats)


def render_light_side(job, camera, film, cfg, spp, max_depth):
    """Render a LIGHT_SIDE integrator into `film` (module docstring);
    returns the film."""
    kind = job.integrator_kind
    ip = job.integrator_params
    scene = job.scene
    gen = pathmod.generate_fn(camera)
    if kind == "lighttracer":
        film, scale = lighttracer.render_lighttracer(
            scene, camera, film, cfg, spp, max_depth=max_depth)
        film.splat.mul_(scale)
        return film
    if kind == "bdpt":
        film, scale = bdpt.render_bdpt(scene, camera, film, cfg, spp,
                                       max_depth=max_depth,
                                       generate_rays=gen)
        film.splat.mul_(scale)
        return film
    if kind == "sppm":
        n_it = max(spp, 4)
        if ip.get("iterations", n_it) != n_it:
            log.warning("iterations %d is ignored: SPPM runs max(spp, 4) = "
                        "%d iterations, as in the JAX package",
                        ip["iterations"], n_it)
        L = sppm.render_sppm(scene, camera, film.width, film.height, cfg,
                             n_iterations=n_it,
                             initial_radius=ip.get("radius", None),
                             max_depth=max_depth, generate_rays=gen)
    else:
        n_mut = max(spp, 8) * 8
        if ip.get("mutationsperpixel", n_mut) != n_mut:
            log.warning("mutationsperpixel %d is ignored: each chain runs "
                        "max(spp, 8) * 8 = %d mutations, as in the JAX "
                        "package", ip["mutationsperpixel"], n_mut)
        L, _ = mlt.render_mlt(
            scene, camera, film.width, film.height,
            n_chains=ip.get("chains", 4096) or 4096,
            mutations_per_chain=n_mut,
            n_bootstrap=ip.get("bootstrapsamples", 65536) or 65536,
            sigma=ip.get("sigma", 0.01), max_depth=max_depth,
            large_step_prob=ip.get("largestepprobability", 0.3),
            generate_rays=gen)
    # a resolved film: weight 1, raw = L (the .dat's)
    film.weighted.copy_(L)
    film.raw.copy_(L)
    film.weight.fill_(1.0)
    return film
