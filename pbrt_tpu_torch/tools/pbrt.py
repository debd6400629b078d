"""Renderer CLI of the port (port of pbrt_tpu.tools.pbrt; reference:
src/main/pbrt.cpp).

    python -m pbrt_tpu_torch.tools.pbrt scene.pbrt [--outfile x.exr]
        [--spp N] [--maxdepth N] [--quick] [--quiet] [--cpu]
        [--sampler refsobol] [--cropwindow x0 x1 y0 y1]

Parses the scene (parser/api.py lists the directives and kinds; one the
JAX package renders and the port does not yet raises NotImplementedError,
one neither knows is skipped with a warning), builds it and its camera (perspective,
orthographic, environment, or the lens cameras realistic, omni and
realisticEye) on the first CUDA card, or on the CPU with --cpu only,
renders it with the scene's sampler and integrator (path, volpath,
whitted, directlighting, ambientocclusion / ao, spectralpath, metadata,
lighttracer, bdpt, sppm or mlt; integrators/dispatch.py; `--sampler
refsobol`: the matched-RNG parity integrator, integrators/refpath.py),
and writes the RGB image (EXR or PNG by extension, else PNG; developed
with the film's splats), the ISET spectral `.dat` (the fork's
spectralFlag, on by default; the film's `raw` sums, without the splats,
as the JAX package writes it) and the fork's metadata sidecars
<out>_mesh.txt / <out>_materials.txt (api.cpp:1630-1689).
Without a visible card and without --cpu it raises.  --cropwindow is
accepted and, as in the JAX package's CLI, not used: the Film's
"float cropwindow" crops the render.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from pbrt_tpu_torch.cameras import lens as lenscam
from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.film import io as fio
from pbrt_tpu_torch.integrators import dispatch, refpath
from pbrt_tpu_torch.parser.api import parse_scene
from pbrt_tpu_torch.samplers.samplers import SamplerConfig


def build_camera(job, width, height, device=None):
    """The job's camera on `device`: a lens camera (realistic, omni,
    realisticEye), orthographic, environment or perspective (thin lens,
    screen window and camera motion included)."""
    cp = job.camera_params
    kind = job.camera_kind
    if kind in lenscam.LENS_KINDS:
        # a broken lens description is a scene error, not something to
        # paper over with a perspective render (the reference Error()s
        # out, api.cpp MakeCamera)
        return lenscam.make_lens_camera(job, width, height, device)
    if kind == "orthographic":
        return projective.make_orthographic(
            job.cam_to_world, width, height,
            lens_radius=cp["lensradius"], focal_distance=cp["focaldistance"],
            screen=cp["screenwindow"], shutter_open=cp["shutteropen"],
            shutter_close=cp["shutterclose"], device=device)
    if kind == "environment":
        return projective.make_environment(job.cam_to_world, width, height,
                                           device=device)
    return projective.make_perspective(
        job.cam_to_world, cp["fov"], width, height,
        lens_radius=cp["lensradius"], focal_distance=cp["focaldistance"],
        screen=cp["screenwindow"], shutter_open=cp["shutteropen"],
        shutter_close=cp["shutterclose"], cam_to_world1=job.cam_to_world1,
        device=device)


def route_name(scene):
    """The scene's hit search: "dense", "kd-tree" or "BVH"."""
    if scene.use_dense:
        return "dense"
    return "kd-tree" if scene.use_kd else "BVH"


def run_job(job, spp=None, max_depth=None, max_rays_per_pass=1 << 18,
            stats=None, sampler_override=None):
    """Render a RenderJob on its scene's device -> (film, camera).

    spp / max_depth override the scene's; stats, a dict, receives the
    rays traced under "rays" (closest-hit lanes + candidate shadow rays,
    as the JAX package counts them) where the integrator counts them.
    sampler_override="refsobol" renders with the matched-RNG parity
    integrator (pbrt's own Sobol' stream and estimators, comparable
    pixel by pixel with the reference binary at equal spp)."""
    if sampler_override not in (None, "refsobol"):
        raise ValueError(f"unknown sampler override {sampler_override!r}")
    if sampler_override == "refsobol" and \
            job.camera_kind in lenscam.LENS_KINDS:
        # the JAX CLI hands the matched-RNG integrator the projective
        # generator only (pbrt_tpu/tools/pbrt.py:185)
        raise NotImplementedError(
            f'the matched-RNG integrator with Camera "{job.camera_kind}" '
            "is not ported")
    device = job.scene.device
    W, H = job.film_width, job.film_height
    camera = build_camera(job, W, H, device)
    fp = dict(job.filter_params)
    radius = fp.pop("radius", None)
    film = filmmod.make_film(W, H, job.filter_name, radius=radius,
                             device=device, **fp)
    spp = spp or job.spp
    cfg = SamplerConfig(kind=job.sampler_kind, seed=0, spp=spp)
    max_depth = max_depth or job.integrator_params["maxdepth"]
    if sampler_override == "refsobol":
        film = refpath.render_ref(
            job.scene, camera, film, W, H, spp, max_depth=max_depth,
            max_rays_per_pass=min(max_rays_per_pass, 1 << 17))
        return film, camera
    film, n_rays = dispatch.render_with_integrator(
        job, camera, film, cfg, spp, max_depth,
        max_rays_per_pass=max_rays_per_pass, count_rays=True)
    if stats is not None and n_rays is not None:
        stats["rays"] = n_rays
    return film, camera


def write_outputs(job, film, outfile=None, quiet=False):
    """Write the image (with the splats, already scaled), the .dat (raw,
    without them) and the sidecars; returns their paths."""
    out = outfile or job.film_filename
    rgb = np.maximum(filmmod.develop_rgb(film).cpu().numpy()
                     * job.film_scale, 0.0)
    written = []
    try:
        written.append(fio.write_image(out, rgb))
    except ValueError:
        written.append(fio.write_png(os.path.splitext(out)[0] + ".png", rgb))
    if job.spectral_flag:
        written.append(fio.write_dat(out, film.raw, scale=job.film_scale))
    base = os.path.splitext(out)[0]
    with open(base + "_mesh.txt", "w") as f:
        for iid, name in sorted(job.instance_names.items()):
            f.write(f"{iid} {name}\n")
    with open(base + "_materials.txt", "w") as f:
        for mid, name in sorted(job.material_names.items()):
            f.write(f"{mid} {name}\n")
    written += [base + "_mesh.txt", base + "_materials.txt"]
    if not quiet:
        for w in written:
            print(f"wrote {w}")
    return written


def device_name(device):
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrt_tpu_torch",
        description="spectral path tracer on an NVIDIA GPU "
                    "(pbrt-compatible scenes)")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", "-o", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="reduce spp to 1 and depth to 3 (reference --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the CUDA card")
    ap.add_argument("--cropwindow", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"),
                    help="accepted and not used, as by pbrt_tpu's CLI "
                         "(the Film's cropwindow crops)")
    ap.add_argument("--sampler", default=None, choices=["refsobol"],
                    help="override the scene's sampler; 'refsobol' runs the "
                         "matched-RNG parity integrator (pbrt's Sobol' "
                         "stream and estimator structure)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING if args.quiet
                        else logging.INFO, format="%(message)s")
    device = devmod.resolve("cpu" if args.cpu else None)

    t0 = time.perf_counter()
    job = parse_scene(args.scene, device=device)
    if not args.quiet:
        print(f"parsed + built scene in {time.perf_counter() - t0:.1f}s "
              f"({job.scene.prim_type.shape[0]} prims, "
              f"{job.scene.n_lights} lights"
              f"{', motion blur' if job.scene.has_animated_mesh else ''}, "
              f"{route_name(job.scene)} route)")
    stats = {}
    t0 = time.perf_counter()
    film, _ = run_job(job, spp=1 if args.quick else args.spp,
                      max_depth=3 if args.quick else args.maxdepth,
                      stats=stats, sampler_override=args.sampler)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if not args.quiet:
        rate = (f"{stats['rays'] / dt:,.0f} rays/s on " if "rays" in stats
                else "on ")
        print(f"rendered in {dt:.1f}s ({rate}{device_name(device)})")
    write_outputs(job, film, args.outfile, args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
