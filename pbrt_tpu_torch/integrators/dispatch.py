"""Integrator selection (port of pbrt_tpu.integrators.dispatch; reference
dispatch: api.cpp:1764-1789).

Only the path integrator is ported; every other integrator name raises
NotImplementedError, as do the path settings the port does not carry
(a crop window, a sample-luminance clamp, an rrthreshold other than 1,
and a light strategy other than uniform in scenes with several lights).
"""

from __future__ import annotations

from pbrt_tpu_torch.integrators import path as pathmod


def render_with_integrator(job, camera, film, cfg, spp, max_depth,
                           max_rays_per_pass=1 << 18, count_rays=False):
    """Render job.scene into `film` with the job's integrator.  Returns
    the film, or (film, rays traced) with count_rays."""
    kind = job.integrator_kind
    if kind != "path":
        raise NotImplementedError(
            f'Integrator "{kind}" is not ported to pbrt_tpu_torch')
    ip = job.integrator_params
    strategy = ip.get("lightsamplestrategy", "spatial")
    # with one light every strategy picks it with probability 1, which is
    # what the ported uniform selection does
    if strategy != "uniform" and job.scene.n_lights > 1:
        raise NotImplementedError(
            f'lightsamplestrategy "{strategy}" with {job.scene.n_lights} '
            "lights is not ported (only uniform)")
    if ip.get("rrthreshold", 1.0) != pathmod.RR_THRESHOLD:
        raise NotImplementedError("rrthreshold other than "
                                  f"{pathmod.RR_THRESHOLD} is not ported")
    if tuple(job.crop_window) != (0.0, 1.0, 0.0, 1.0):
        raise NotImplementedError("cropwindow is not ported")
    if job.max_sample_luminance < 1e30:
        raise NotImplementedError("maxsampleluminance is not ported")
    return pathmod.render(job.scene, camera, film, cfg, spp,
                          max_depth=max_depth,
                          max_rays_per_pass=max_rays_per_pass,
                          count_rays=count_rays)
