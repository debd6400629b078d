"""Renderer CLI of the port (port of pbrt_tpu.tools.pbrt; reference:
src/main/pbrt.cpp).

    python -m pbrt_tpu_torch.tools.pbrt scene.pbrt [--outfile x.exr]
        [--spp N] [--maxdepth N] [--quick] [--quiet] [--cpu]
        [--sampler refsobol] [--cropwindow x0 x1 y0 y1] [--nthreads N]
        [--checkpoint FILE] [--checkpoint-interval SEC] [--cat | --toply]

Parses the scene (parser/api.py lists the directives and kinds; one
neither package knows is skipped with a warning), builds it and its
camera (perspective, orthographic, environment, or the lens cameras
realistic, omni and realisticEye; another kind renders as perspective,
as in the JAX package) on the first CUDA card, or on the CPU with --cpu
only, renders it with the scene's sampler and integrator (path, volpath,
whitted, directlighting, ambientocclusion / ao, spectralpath, metadata,
lighttracer, bdpt, sppm or mlt; integrators/dispatch.py; `--sampler
refsobol`: the matched-RNG parity integrator, integrators/refpath.py),
and writes the RGB image (EXR or PNG by extension, else PNG; developed
with the film's splats), the ISET spectral `.dat` (the fork's
spectralFlag, on by default; the film's `raw` sums, without the splats,
as the JAX package writes it) and the fork's metadata sidecars
<out>_mesh.txt / <out>_materials.txt (api.cpp:1630-1689), then prints
the render statistics (utils/stats.py).
Without a visible card and without --cpu it raises.  --cropwindow is
accepted and, as in the JAX package's CLI, not used: the Film's
"float cropwindow" crops the render.  --nthreads is accepted and
ignored.  --checkpoint FILE saves the film there every
--checkpoint-interval seconds and at the end, and resumes from it
(film/checkpoint.py).  --cat / --toply print the scene one directive a
line, Includes expanded (--toply also writes each inline trianglemesh to
a .ply beside the output and names it as a plymesh), and render nothing.
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
from pbrt_tpu_torch.parser.api import PbrtAPI, parse_scene
from pbrt_tpu_torch.parser.tokenizer import tokenize_file, unquote
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.shapes.ply import write_ply
from pbrt_tpu_torch.utils.stats import Stats, count_scene


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


# the directives the parser reads, each of which starts a line of --cat
_DIRECTIVES = frozenset(n[3:] for n in dir(PbrtAPI) if n.startswith("_d_"))


def cat_scene(path, out=None, toply=False):
    """`--cat` / `--toply` (reference parser.cpp --cat/--toply): the
    scene one directive a line with normalised whitespace, Includes
    expanded, nested blocks indented; with toply each inline trianglemesh
    goes to a .ply sidecar and its Shape becomes a plymesh.  Writes to
    `out`, else to stdout; returns 0."""
    groups = []

    def consume(tokens, scene_dir):
        it = iter(tokens)
        for t in it:
            if not t.startswith('"') and t == "Include":
                inc = os.path.join(scene_dir, unquote(next(it)))
                consume(list(tokenize_file(inc)), os.path.dirname(inc))
            elif not t.startswith('"') and t in _DIRECTIVES:
                groups.append([t])
            elif groups:
                groups[-1].append(t)

    consume(list(tokenize_file(path)),
            os.path.dirname(os.path.abspath(path)))
    lines = []
    indent = 0
    n_ply = 0
    base = os.path.splitext(out or path)[0]
    for g in groups:
        name = g[0]
        if toply and name == "Shape" and len(g) > 1 \
                and unquote(g[1]) == "trianglemesh":
            g, n_ply = _shape_to_ply(g, base, n_ply)
        if name in ("AttributeEnd", "TransformEnd", "ObjectEnd",
                    "WorldEnd"):
            indent = max(indent - 1, 0)
        lines.append("    " * indent + " ".join(g))
        if name in ("AttributeBegin", "TransformBegin", "ObjectBegin",
                    "WorldBegin"):
            indent += 1
    text = "\n".join(lines) + "\n"
    if out:
        with open(out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _shape_to_ply(g, base, n_ply):
    """A trianglemesh directive's P / indices / N / uv to
    `<base>_mesh<n>.ply` (reference WritePlyFile, triangle.cpp:112);
    returns (the plymesh directive, n_ply + 1), or (g, n_ply) unchanged
    when it lacks P or indices."""
    params = {}
    i = 1
    while i < len(g):
        if g[i].startswith('"') and i + 1 < len(g) and g[i + 1] == "[":
            j = g.index("]", i + 1)
            params[unquote(g[i])] = g[i + 2:j]
            i = j + 1
        else:
            i += 1

    def key(*names):
        return next((k for k in params if k.split()[-1] in names), None)
    pkey, ikey = key("P"), key("indices")
    if pkey is None or ikey is None:
        return g, n_ply
    verts = np.asarray([float(x) for x in params.pop(pkey)],
                       np.float32).reshape(-1, 3)
    faces = np.asarray([int(float(x)) for x in params.pop(ikey)],
                       np.int32).reshape(-1, 3)
    nkey, ukey = key("N"), key("uv", "st")
    norms = (None if nkey is None else np.asarray(
        [float(x) for x in params.pop(nkey)], np.float32).reshape(-1, 3))
    uvs = (None if ukey is None else np.asarray(
        [float(x) for x in params.pop(ukey)], np.float32).reshape(-1, 2))
    ply_path = f"{base}_mesh{n_ply:05d}.ply"
    write_ply(ply_path, verts, faces, norms=norms, uvs=uvs)
    ng = ["Shape", '"plymesh"', '"string filename"',
          f'"{os.path.basename(ply_path)}"']
    for k, v in params.items():
        ng += [f'"{k}"', "["] + list(v) + ["]"]
    return ng, n_ply + 1


def run_job(job, spp=None, max_depth=None, quiet=False,
            max_rays_per_pass=1 << 18, progress=False, checkpoint_path=None,
            checkpoint_every=60.0, sampler_override=None, stats=None):
    """Render a RenderJob on its scene's device -> (film, camera).

    spp / max_depth override the scene's.  progress (and not quiet):
    print the passes done, the seconds and an estimate of the rest, at
    most every 5 s.  checkpoint_path / checkpoint_every: save and resume
    the film (film/checkpoint.py).  stats, a utils.stats.Stats, receives
    the render's counters where the integrator counts them (closest-hit
    and shadow ray tests, camera rays, path vertices; trace_paths).
    sampler_override="refsobol" renders with the matched-RNG parity
    integrator (pbrt's own Sobol' stream and estimators, comparable
    pixel by pixel with the reference binary at equal spp), which takes
    none of progress, checkpoint or stats, as in the JAX package."""
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

    t0 = time.time()
    last = [0.0]

    def prog(done, total):
        now = time.time()
        if now - last[0] > 5.0 or done == total:
            eta = (now - t0) / max(done, 1) * (total - done)
            print(f"\r  [{done}/{total} passes, {now - t0:.0f}s, "
                  f"eta {eta:.0f}s]", end="", flush=True)
            last[0] = now

    show = progress and not quiet
    film = dispatch.render_with_integrator(
        job, camera, film, cfg, spp, max_depth,
        max_rays_per_pass=max_rays_per_pass, progress=prog if show else None,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        stats=stats)
    if show:
        print()
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
    ap.add_argument("--nthreads", type=int, default=0,
                    help="accepted for the reference CLI's sake and "
                         "ignored (the card runs the passes)")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="save the film to FILE periodically and at the "
                         "end, and resume from it (the reference writes "
                         "its film only at the end)")
    ap.add_argument("--checkpoint-interval", type=float, default=60.0,
                    metavar="SEC", help="seconds between checkpoints")
    ap.add_argument("--cat", action="store_true",
                    help="print the scene one directive a line and exit "
                         "(reference parser --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, with inline triangle meshes written "
                         "to .ply files (reference parser --toply)")
    args = ap.parse_args(argv)
    if args.cat or args.toply:
        return cat_scene(args.scene, out=args.outfile, toply=args.toply)
    logging.basicConfig(level=logging.WARNING if args.quiet
                        else logging.INFO, format="%(message)s")
    device = devmod.resolve("cpu" if args.cpu else None)

    stats = Stats()
    with stats.phase("Parsing + scene compile"):
        job = parse_scene(args.scene, device=device)
    sc = job.scene
    if not args.quiet:
        print(f"parsed + built scene in "
              f"{stats.times['Parsing + scene compile']:.1f}s "
              f"({sc.prim_type.shape[0]} prims, {sc.n_lights} lights"
              f"{', motion blur' if sc.has_animated_mesh else ''}, "
              f"{route_name(sc)} route)")
    spp = 1 if args.quick else args.spp
    with stats.phase("Rendering"):
        film, _ = run_job(job, spp=spp,
                          max_depth=3 if args.quick else args.maxdepth,
                          quiet=args.quiet, progress=True,
                          checkpoint_path=args.checkpoint,
                          checkpoint_every=args.checkpoint_interval,
                          sampler_override=args.sampler, stats=stats)
        # the passes' kernels end inside the render phase
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = stats.times["Rendering"]
    count_scene(stats, sc.prim_type.shape[0], sc.n_lights, sc.n_nodes)
    if not args.quiet:
        n_rays = (stats.counters.get("Intersections/Regular ray "
                                     "intersection tests", 0)
                  + stats.counters.get("Intersections/Shadow ray "
                                       "intersection tests", 0))
        rate = (f"{n_rays / dt:,.0f} rays/s on " if n_rays else "on ")
        print(f"rendered in {dt:.1f}s ({rate}{device_name(device)})")
    with stats.phase("Film output"):
        write_outputs(job, film, args.outfile, args.quiet)
    if not args.quiet:
        stats.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
