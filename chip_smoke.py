"""Smoke test of the PyTorch/CUDA port (`pbrt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pbrt_tpu_torch/csrc` (the dense
intersector's and, for scenes over its cap, the BVH and kd walks; phase
25) and holds each against its plain PyTorch version on the card at the
shapes the main paths give it: K1 and the static K2 on the Cornell
scene's camera and bounce-1 batches, K1 and K2 motion on those of
`pbrt_tpu_torch/scenes/cornell_motion.pbrt`.  K1's chunk lists must
equal the plain version's bit for bit, and K2 takes them; K1's cull
alone (its kCull instantiation, the TPU kernel's contract) is held to
its plain version too.  Then it drives three paths,
each with the kernels' launch counts set to 0 just before it and read
just after:

- the Cornell model (256x256, Sobol, 4 spp, depth 5, 65,536 rays per
  pass) through the port's `render`: K1 and the static K2 six times per
  pass;
- the CLI's `run_job` on scenes/cornell_bench.pbrt (256x256, 2 spp), its
  16x16-block means held against the reference binary's
  (tests/data/ref_cornell_blocks.npz) at the thresholds of
  tests/test_reference_parity.py;
- the CLI's `run_job` on the motion scene (256x256, 4 spp, depth 5,
  65,536 rays per pass): K1 and K2 motion six times per pass, the static
  K2 never.

It compares 32x32 renders of both scenes on the GPU with the same
renders on the CPU, and writes the .dat, EXR and sidecar outputs.

Phase 10 drives the kernel harnesses, again with the counts set to 0
just before and read just after: `tools.ablate_k2` on the Cornell random
rays (s1) and the cluster mesh with 1 and 8 chunks per tile (s2, s5),
every ablation mode of K2 held to its plain version and `full` and
`direct` to production K2 bit for bit; `tools.dissect_intersect` at
B=2^18 on Cornell (s4), its stages composed equal to `intersect`; and
`tools.dump_tile` on the 600-triangle case (s6 picks 0 1 2 2, s7 tile 0's
real list), the dump against its plain version and its last running best
equal to production K2's.

Phases 11-13 drive the matched-RNG, metadata and spectral integrators,
each again with the counts set to 0 just before and read just after:

- 11: `refpath.render_ref` of scenes/cornell_refrng.pbrt (128x128, depth
  5, box film with the reference's pixel boundary) at 4 spp against
  tests/data/ref_cornell_refrng4.npz and at the scene's own 32 spp
  against tests/data/ref_cornell_refrng.npz, each held to the four
  thresholds of tests/test_refrng_parity.py; K1 and the static K2 six
  times per pass, each intersect call after the camera's one batch of
  3 x 16,384 continuation, probe and shadow rays, the last third any-hit.
  K1 and K2 are held to their plain versions on that pass's camera and
  bounce-1 batches first.
- 12: the CLI's `run_job` on scenes/metadata_depth.pbrt (the metadata
  integrator, depth) against tests/data/ref_metadata_depth.npz at the
  thresholds of tests/test_tools.py.
- 13: the spectralpath integrator (4 bands) on the Cornell model at
  256x256, 4 spp, depth 5: finite, non-negative, non-black, and its mean
  within 1% of phase 5's `path.render` of the same samples, >= 95% of
  pixels within 1e-2 (each band runs its own Russian roulette on its
  masked beta, so the two agree statistically, not bit for bit).

Phases 14-17 drive the lens cameras, the samplers and the pixel filters,
each render again with the counts set to 0 just before and read just
after (K1 and the static K2 six times a pass, four times that for
spectralpath); the Cornell model at 256x256, depth 5, 65,536 rays a
pass:

- 14: a realistic camera at Cornell's LookAt with the double-Gauss 50 mm
  of pbrt_tpu_torch/scenes/lenses/dgauss.50mm.dat, an 8 mm stop,
  focused by the paraxial sweep on the box's middle (7 units), a 35 mm
  film diagonal, 4 spp, through `path.render`;
- 15: the same lens with chromatic aberration, through spectralpath (4
  bands, each regenerating its rays at its wavelength), 4 spp: its mean
  within 2% of phase 14's;
- 16: omni, a JSON lens made by the port's lenstool from the same .dat
  with a 64x64 microlens array of jittered centres inserted, at
  simulation radius 1, 2 spp; and realisticEye, the 5-surface eye of
  pbrt_tpu_torch/scenes/lenses/eye5.txt in metres with its four media's
  IoRs and HURB diffraction at the pupil, 2 spp;
- 17: the CLI's `run_job` on pbrt_tpu_torch/scenes/cornell_lens.pbrt
  (the realistic camera, no Sampler line so halton, mitchell) at 2 spp;
  then the Cornell model at 2 spp under each of the six sampler kinds
  and under the triangle, mitchell and sinc filters, each mean within
  2% of the Sobol' / Gaussian render's.

Phases 18-19 drive the surface materials, textures, bump maps and ray
differentials:

- 18: the CLI's `run_job` on pbrt_tpu_torch/scenes/cornell_materials.pbrt
  (cornell_bench's box and camera at 256x256, Sobol, 4 spp, depth 5; an
  imagemap floor, a checkerboard wall, metal, uber at opacity 0.5,
  substrate, translucent, retroreflective, disney, rough glass, a mix of
  two named materials, a Beckmann plastic and a wrinkled bump map),
  counted as phase 5 is (K1 and the static K2 six times a pass): ms a
  pass, launches and device ms of one pass, the share of first-hit lanes
  whose uv derivatives are nonzero (the camera's ray differentials reach
  the EWA lookup); the imagemap's table entry must hold floor.png and
  not the parser's 0.5 fallback; a 32x32 2 spp render on the GPU against
  the CPU at phase 8's limits.
- 19: each ported BSDF family, Beckmann where it applies: eval_f, pdf_f
  and sample_f at B = 2^16 on the card against the CPU (the tolerances
  of tests/test_torch_materials.py); then at B = 2^20 on the card alone,
  sample_f's f and pdf against eval_f and pdf_f at the sampled
  directions (tests/test_bsdfs.py::test_sample_eval_pdf_consistency's
  limits) and the albedo E[f cos / pdf] of the non-delta samples against
  a uniform-sphere estimate of the integral of f |cos| (within 5
  standard errors).

Phase 20 drives every light kind: the CLI's `run_job` on
pbrt_tpu_torch/scenes/cornell_lights.pbrt (cornell_bench's world at
256x256, Sobol, 4 spp, depth 5, under the default spatial light
strategy: its ceiling mesh light, an emissive sphere, point, spot,
goniometric, projection and distant lights, and an infinite light with a
Hosek sky map), counted as phase 5 is, with ms a pass and one profiled
pass's launches, device ms and idle share; K1 and K2 against their plain
versions on that path's camera and bounce-1 batches (shadow rays of tmax
1e30, closest-hit lanes toward the sphere light), and that bounce's
trace_pair through the kernels and through their plain versions, whose
shadow masks must be equal bit for bit; the card against the CPU at
32x32 2 spp (phase 8's limits) on the lights scene and on the
matched-RNG render of pbrt_tpu_torch/scenes/refpath_sphere_sky.pbrt (a
sphere light and the sky); the uniform, power and spatial strategies'
image means of tests/test_lightdistrib.py's two point lights over a
plane within STRATEGY_Z standard errors of their per-pixel difference
(the lights scene's three means are printed: NEE's MIS weight leaves
out the selection pdf, as pbrt_tpu's does, so there they differ); the
furnace (a matte sphere of albedo 0.5 under a constant
infinite light, centre within 2% of 0.5; a white one within 2% of 1) and
a point light over a Lambertian plane (I cos / (pi r^2) rho, 2% at the
centre, 5% at x = 0.5), tests/test_integrators.py's scenes at 256x256.

Phase 21 drives differentiable rendering (integrators/diff.py): the
inverse render at full width, the Cornell model at 256x256 (65,536 rays
a step, Sobol, depth 5, camera fixed), mat_kd and light_L from 0.5 and
0.7 of their values toward `render_samples` at their values at the same
sample index, INV_STEPS steps of `make_train_step` at lr 0.05, each
counted as phase 5 is (K1 and the static K2 six times a step; the first
step's forward and backward apart, the backward launching neither):
the last loss below 0.1 of the first, every gradient finite.  It prints
ms a fwd+bwd step against ms a forward pass of the same samples under
no_grad, fwd+bwd rays/s (trace_paths' count), the peak device memory of
a step and, for one step under torch.profiler
(`tools.profile_pass.profile_train_step`), launches and device ms of its
forward and backward and the idle share.  Then on the card:
tests/test_diff.py's albedo (4 bins) and emission (env_map entry 10)
gradients against finite differences on its 8x8 sphere, at its
threshold; tests/test_diff_camera.py's camera derivatives (rx, tx, fov;
the share of pixels within 10% above 0.7) on cornell(tessellate=False)
at 24x24, depth 2, and its pose recovery (240 Adam steps, lr 2e-3,
error below 0.3 of the start); the mat_kd and light_L gradients of a
32x32 2 spp Cornell render_loss against the CPU's (GRAD_CPU_RTOL of the
largest entry); and every gradient of the materials and lights scenes
finite at 64x64.

Phase 22 drives participating media through volpath (integrators/
volpath.py), each render counted as phase 5 is (a closest-hit call a
bounce and, but for the last, the shadow walk's 8 calls: 46 K1 and K2 a
pass at depth 5, 55 at depth 6): (a) the CLI's `run_job` on
scenes/volpath_bench.pbrt (homogeneous fog bound by MediumInterface, the
camera inside it) at its 128x128, 32 spp, depth 5, against
tests/data/ref_volpath_blocks.npz at tests/test_reference_parity.py:80-86's
limits (energy within 3%, median 16x16-block error < 0.10, band ratio
flat within 0.02); (b) scenes/smoke_glass.pbrt (a density grid bound
inside a glass sphere) at its 48x48, 32 spp, depth 6, against
tests/data/ref_smoke_glass.npz at tests/test_media_interface.py:385-392's
(energy within 10%, median 8x8-block error < 0.15, > 85% of blocks
within 0.35); (c) both at 256x256, 4 spp, 65,536 rays a pass: ms a pass,
one profiled pass's launches, device ms and idle share, K1 and K2 a
pass, and for smoke_glass the K1 active chunks a tile of bounce 1's
walk at crossings 1, 2 and 8; (d) both at 32x32 2 spp on the card
against the CPU (phase 8's limits), and again without their
MediumInterface lines (volpath's scene-medium form); (e) K1 and K2
against their plain versions on smoke_glass's bounce-1 walk batches at
crossings 1 and 2 (whose lanes mostly end on the quadric sphere: few
triangle hits), volpath_bench's at crossing 1 (the fog box's triangles)
and, at 256x256, the bounce-0 walk of kernel_workloads.shells_scene at
crossings 2, 5 and 8, where every live lane crosses a material-less
box's triangle at each step.
Phase 23 renders cornell_bench.pbrt with its integrator overridden to
whitted, ambientocclusion and directlighting ("all" strategy) at 256x256
2 spp, counted as phase 5 is (11, 2 and 2 K1 and K2 a pass): ms a pass,
one profiled pass's launches and device ms; and each at 32x32 2 spp on
the card against the CPU.

Phase 24 drives every shape and the rest of the scene format on the
shapes cell (`tools/shapes_scene.py` at its defaults, written under
chiprun_out/shapes_scene: a plymesh blob placed by six ObjectInstances,
a heightfield floor, a loopsubdiv icosahedron, a hyperboloid, a nurbs
patch, two curves, a cylinder, a disk with an innerradius, a cone placed
through CoordSysTransform, a paraboloid and a sphere cut to 270 degrees,
in cornell_bench.pbrt's box; 162,962 triangles in 319 chunks of 512):
(a) its triangles, quadrics, instances, C, chunk, dense-table MiB and
parse + build seconds; (b) K1 and the static K2 against their plain
versions through compare_kernels with seams on its camera and bounce-1
batches and on `kernel_workloads.bitonic_batch` (unsorted rays in all
directions), one lane a batch allowed another triangle without a tie
where dense.loop_prim_skipped explains it (SHAPES_SKIPS), the tiles
whose hit chunks K1 orders by its bitonic sort (more than
dense.QUEUE_RANK_MAX) counted, at least one required; (c) the
CLI's `run_job` at 256x256, Sobol, 4 spp, depth 5, 65,536 rays a pass,
counted as phase 5 is: ms a pass, rays/s, launches, one profiled pass's
device ms and idle share, peak device memory; (d) the card against the
CPU at 32x32 2 spp; (e) the CLI (`tools.pbrt.main`) on the card at
64x64: a Film cropwindow (pixels outside it 0, inside it the full
render's within phase 8's limits), a maxsampleluminance (no pixel
brighter than spp times the cap, some darker than the full render's),
and the metadata integrator's "mesh" ids at 1 spp (each blob instance
and each wall has its own id).

Phase 25 drives scenes over the dense cap, written under
chiprun_out/walk_cells by `tools/shapes_scene.py`: shapes_1m (`--level 6
--instances 12 --field 256`, ~1.12M triangles, the BVH walk, 256x256, 4
spp), shapes_motion (the defaults with `--moving-field`, 162,962
triangles over the motion cap: the BVH walk's motion instantiation,
128x128), shapes_kd (`--level 5 --instances 13 --accel kdtree`, just
over the cap: the kd walk, 256x256, 4 spp) and shapes_kd_motion
(shapes_motion with `--accel kdtree`: the kd walk's motion
instantiation, 128x128): (a) each cell's triangles, quadrics, BVH and
kd nodes, kd list entries, table MiB and parse + build seconds, its
route, and no dense table; (b) bvh_walk, bvh_walk<motion>, kd_walk and
kd_walk<motion> against their plain versions on the cells' camera and
bounce-1 batches (`kernel_workloads.accel_batches`, any-hit
lanes included): (t, prim) bit for bit on every lane or another prim at
a tie, timed, with node visits a lane and the bound from the plain
version's counts; (c) kd_walk against bvh_walk on the kd cells' batches,
every differing lane a tie or a large-leaf lane (ROADMAP Queue 3 (v)), each
named; (d) shapes_1m through the CLI's run_job over WALK_PASSES passes,
counted as phase 5 is (bvh_walk six times a pass, no K1 or K2): ms a
pass, rays/s, one profiled pass's launches, device ms and idle share,
peak device memory; the other cells one pass each; (e) shapes_1m on
the card against the CPU at 32x32 2 spp; and, as evidence for ROADMAP
Queue 3's open crack, phase 24's shapes cell through K2 and through
bvh_walk (the same scene with use_dense false), the lanes the two answer
differently printed with why.

Phase 26 drives the rest of the materials on the skin scene
(`tools/skin_scene.py` at its defaults, written under
chiprun_out/skin_scene: cornell_bench's box and camera, a tall block in
subsurface "Skin1" at scale 30, a short block in kdsubsurface with a rough
interface, a fourier sphere of a 3-channel 5-order table, a ptex back wall
of one colour a face and a swatch of 600 hair curves; 12,354 triangles):
(a) the CLI's `run_job` at 256x256, Sobol, 4 spp, depth 5, 65,536 rays a
pass, counted as phase 5 is (K1 and the static K2 26 times a pass: the
camera's call and, at each of 5 bounces, 4 probe passes and the
trace_pair): ms a pass, rays/s, one profiled pass's launches, device ms
and idle share; (b) K1 and K2 against their plain versions on the first
and last probe pass of bounces 0 and 1 (many dead lanes, finite tmax),
through compare_kernels with seams (SKIN_SKIPS lanes a batch may be
explained by dense.loop_prim_skipped), each batch's live lanes, and the
probe lanes whose next pass returned the same triangle; (c) the card
against the CPU at 32x32 2 spp; (d) tests/test_bssrdf.py's three
physical checks at 64x64: a bright subsurface sphere more than 4x a dark
one, the probe against the diffusion limit (whitted) on a flat slab
within 0.5-2, and the three-slab chain (2 probe passes find at most 2
hits, 4 at least 3, 8 at most 6), with the slabs rendered at 2 probe
passes, counted.

Phase 27 drives the light-side integrators on scenes/cornell_bench.pbrt
at 256x256, depth 5, through the CLI's `run_job` with the job's
integrator set to each, counted as phase 5 is (K1 and the static K2 once
an intersect call): lighttracer at 4 spp (4 passes of 65,536 photons, 10
calls a pass), bdpt at 4 spp (8 passes of 32,768 camera rays, 31 calls a
pass: 6 camera and 5 light subpath calls, 5 s=1, 10 s>=2 and 5 t=1
connections), sppm at 4 iterations of 65,536 photons (16 calls an
iteration) and mlt at its defaults (4,096 chains, 65,536 bootstrap paths,
64 mutations a chain: 66 path evaluations of 6 calls).  (a) each image
finite, non-negative and non-black, its wall time over its units
(passes, iterations or, with the bootstrap, mutation steps), one unit
timed alone and profiled: its ms, launches, device ms and idle share,
and peak device memory; SPPM's gather kernel G1 (csrc/sppm_gather.cu)
counted too, its count set to 0 just before each render: 4 launches an
sppm iteration, none for the others, and the plain loop never run; (b)
image means against `path` through `run_job` at the same spp: bdpt
within BDPT_GAP, mlt within MLT_GAP; lighttracer's and sppm's ratios
printed (neither sees the emitter or the
mirror through its camera connection, and sppm's visible point keeps
plastic's diffuse part only); (c) K1 and K2 against their plain versions
on kernel_workloads.bdpt_batches (rays leaving the light, the (2,2) and
(2,1) connections) and photon_batch (an iteration's first photons),
through compare_kernels with seams (LIGHT_SKIPS lanes a batch); (d) the
card against the CPU at 32x32 2 spp for lighttracer, bdpt and sppm
(phase 8's limits), and for mlt (MLT_32: 256 chains, 1,024 bootstrap
paths, 16 mutations a chain) the image mean within MLT_CPU_GAP: an
acceptance that flips on rounding sends a chain elsewhere; (e) SPPM's
photon gather kernel (csrc/sppm_gather.cu) against gather_plain on the
gather calls of one iteration of cornell_bench at the benchmark's
362x362 (131,044 visible points and photons, depth 5): M equal but on
points with a pair within 4 ulp of r2, tau_add within 1e-5 relative; the
kernel's device ms on bounce 1's call (the profiler's, or if no trace
holds it CUDA events on a held stream; neither read fails the smoke)
beside the plain loop's (one 1,024-photon chunk, scaled to P), the bound
(pairs x 8 f32 instructions at 33.5e12/s) and the kernel's share of it,
and its registers; the kernels line's `sppm_gather` row takes these and
(a)'s launches.

Phase 28 drives the last modules (~20 s on the H100), each with the
counts set to 0 just before and read just after: (a) checkpoint and
resume: the Cornell model at 256x256, Sobol, 4 spp, depth 5, 65,536 rays
a pass, rendered whole, then to 2 spp with a checkpoint rewritten under
the 4-spp fingerprint (film/checkpoint.py) and resumed to 4 spp: K1 and
K2 12 times each on the resumed half, `weighted`, `weight` and `raw`
within 1e-5 of the whole render relative to each array's largest value
(the splat's f32 atomics order the sums differently), the save's and
load's ms and the file's MiB; (b) the CLI's `main` on
scenes/cornell_bench.pbrt at 2 spp with --checkpoint and its stats
report: 131,072 camera rays, regular plus shadow tests equal to the rays
`count_rays` counts on the same render, and a second `main` on the same
checkpoint launching K1 / K2 0 times and writing the same image and
.dat bytes; (c) `parallel/multihost.py` as two processes on this one
card, gloo with CUDA tensors (NCCL refuses two ranks on one device, so
its path waits for a machine with two cards), each building the kernels
from the shared cache and rendering the tessellated Cornell model at
256x256, 2 spp, depth 5, 32,768 rays a rank a pass, after one untimed
spp of warm-up: the summed film against a one-process `render` of the
same samples (image mean within 1e-5 relative, >= 99.9% of pixels within
1e-4), each rank's ms a pass and its all-reduce's ms; (d) `tools/bsdftest.py` on the card for its 8
materials at 100,000 samples each, each PASS.

Every lens render is finite, non-negative and non-black.  Mitchell's
and sinc's negative lobes make some developed pixels negative where the
image has a sharp edge (the reference clamps them when it writes the
image), so for those two the raw film is held non-negative and the
developed image finite, and the negative pixels are counted.  Each new
phase prints its ms a pass and, for one more pass under torch.profiler,
its kernel launches a pass and device time.  compare_cpu also renders
the realistic, omni and eye cameras, spectralpath with chromatic
aberration, and the halton and maxmindist samplers at 32x32 2 spp.

Any failed check raises, so the exit code is non-zero; there is no
fallback to the CPU or to a plain version.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}};
the line before it lists every kernel with its launches, its largest
difference from the plain version, its times (`ms`: CUDA events around
20 wrapper calls, which hold the time the card waits on the host between
launches; `device_ms`: the device time of the kernels one call launches,
from torch.profiler), its bound and what bounds it, and for K2 and K2
motion the listed chunks of a slice, the blocks a tile may take, the
staging buffers and the merge keys' fills.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the smoke drives one card, cuda:0; on a machine with several, it sees
# only the first unless told otherwise
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import torch  # noqa: E402  (after the device mask)
from torch.autograd import DeviceType  # noqa: E402

from pbrt_tpu_torch.cameras import lens  # noqa: E402
from pbrt_tpu_torch.cameras import projective  # noqa: E402
from pbrt_tpu_torch.core import geometry as geom  # noqa: E402
from pbrt_tpu_torch.core import spectrum  # noqa: E402
from pbrt_tpu_torch.core import transform as tfm  # noqa: E402
from pbrt_tpu_torch.film import checkpoint as ckpt  # noqa: E402
from pbrt_tpu_torch.film import film as filmmod  # noqa: E402
from pbrt_tpu_torch.film import io as filmio  # noqa: E402
from pbrt_tpu_torch.integrators import bdpt  # noqa: E402
from pbrt_tpu_torch.integrators import diff  # noqa: E402
from pbrt_tpu_torch.integrators import dispatch  # noqa: E402
from pbrt_tpu_torch.integrators import mlt  # noqa: E402
from pbrt_tpu_torch.integrators import path  # noqa: E402
from pbrt_tpu_torch.integrators import refpath  # noqa: E402
from pbrt_tpu_torch.integrators import spectralpath  # noqa: E402
from pbrt_tpu_torch.integrators import sppm  # noqa: E402
from pbrt_tpu_torch.integrators import volpath  # noqa: E402
from pbrt_tpu_torch.lights import lights  # noqa: E402
from pbrt_tpu_torch.materials import bsdf  # noqa: E402
from pbrt_tpu_torch.models import flagship  # noqa: E402
from pbrt_tpu_torch.ops import accel_walk  # noqa: E402
from pbrt_tpu_torch.ops import cuda_kernels  # noqa: E402
from pbrt_tpu_torch.ops import dense_intersect as dense  # noqa: E402
from pbrt_tpu_torch.ops import intersect as isect  # noqa: E402
from pbrt_tpu_torch.parser.api import PbrtAPI, parse_scene  # noqa: E402
from pbrt_tpu_torch.samplers.samplers import SamplerConfig  # noqa: E402
from pbrt_tpu_torch.scene.ir import (  # noqa: E402
    MaterialSpec, SceneBuilder, MAT_DISNEY, MAT_GLASS, MAT_MATTE, MAT_METAL,
    MAT_MIRROR, MAT_NONE, MAT_PLASTIC, MAT_RETRO, MAT_ROUGHGLASS,
    MAT_SUBSTRATE, MAT_TRANSLUCENT, MAT_UBER)
from pbrt_tpu_torch.textures.textures import RES as TEX_RES  # noqa: E402
from pbrt_tpu_torch.textures.textures import TEX_IMAGE  # noqa: E402
from pbrt_tpu_torch.tools import ablate_k2  # noqa: E402
from pbrt_tpu_torch.tools import bsdftest  # noqa: E402
from pbrt_tpu_torch.tools import dissect_intersect  # noqa: E402
from pbrt_tpu_torch.tools import dump_tile  # noqa: E402
from pbrt_tpu_torch.tools import kernel_workloads as kw  # noqa: E402
from pbrt_tpu_torch.tools import launch_components  # noqa: E402
from pbrt_tpu_torch.tools import lenstool  # noqa: E402
from pbrt_tpu_torch.tools import profile_pass  # noqa: E402
from pbrt_tpu_torch.tools import pbrt as cli  # noqa: E402
from pbrt_tpu_torch.tools import shapes_scene  # noqa: E402
from pbrt_tpu_torch.tools import skin_scene  # noqa: E402
from pbrt_tpu_torch.utils.stats import Stats  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_SCENE = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
MOTION_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                            "cornell_motion.pbrt")
REF_BLOCKS = os.path.join(ROOT, "tests", "data", "ref_cornell_blocks.npz")
REFRNG_SCENE = os.path.join(ROOT, "scenes", "cornell_refrng.pbrt")
# (spp, the reference binary's image at that spp)
REFRNG_FIXTURES = ((4, os.path.join(ROOT, "tests", "data",
                                    "ref_cornell_refrng4.npz")),
                   (32, os.path.join(ROOT, "tests", "data",
                                     "ref_cornell_refrng.npz")))
REF_W = REF_H = 128
META_SCENE = os.path.join(ROOT, "scenes", "metadata_depth.pbrt")
META_REF = os.path.join(ROOT, "tests", "data", "ref_metadata_depth.npz")
CA_BANDS = 4
LENS_DIR = os.path.join(ROOT, "pbrt_tpu_torch", "scenes", "lenses")
DGAUSS = os.path.join(LENS_DIR, "dgauss.50mm.dat")
EYE_SPEC = os.path.join(LENS_DIR, "eye5.txt")
LENS_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                          "cornell_lens.pbrt")
MATS_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                          "cornell_materials.pbrt")
CORNELL_LOOK = ([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1])
# the eye's media on the film side of each surface (cornea, aqueous,
# lens, vitreous; tests/test_lens.py)
EYE_IORS = (1.377, 1.337, 1.42, 1.336)
SAMPLERS = ("independent", "stratified", "sobol", "halton",
            "zerotwosequence", "maxmindist")
NEW_FILTERS = ("triangle", "mitchell", "sinc")
# a sampler's or filter's image mean against the Sobol' / Gaussian one's,
# and spectralpath with chromatic aberration against phase 14's
MEAN_GAP = 0.02
W = H = 256
SPP = 4
GATE_SPP = 2
DEPTH = 5
RAYS_PER_PASS = 65536
# K2 lanes whose t must lie within 1e-5 relative of the plain version's:
# t = num/nd cancels on some lanes (PERF.md), so a share and not every
# lane.  K2 motion rounds its Horner steps in another order than its plain
# version (table entries first, or dot products first), but most of the
# motion scene's triangles are static (planes 1-3 exact zeros, so Horner
# in either order returns plane 0 exactly), and the share was
# 0.9985 (camera) and 0.9975 (bounce 1) on the H100, the static pair's
# 0.9990 and 0.9978 (PERF.md): the same floor holds both.  Every lane of
# both is held to its f32 rounding bound regardless.
T_SHARE = 0.99
# the same share on the shapes cell's batches (phase 24): its triangles
# are small against their chunk's extent (blob faces, the heightfield,
# the subdivided icosahedron), so that num and nd cancel and the f32
# bound of t exceeds 1e-5 on half its lanes (the median bound was 1.0e-5
# to 1.6e-5).  Measured on the H100: 0.9717 (camera), 0.9660 (bounce 1),
# 0.9797 (bitonic), every lane within 5% of its bound (PERF.md).
SHAPES_T_SHARE = 0.95
# closest-hit lanes of a shapes batch whose triangle may differ from the
# plain version's without a tie (compare_kernels' skips): on the H100 one
# lane of 65,536 in the bounce-1 batch, a crack between the two faces of a
# blob edge (ROADMAP Queue 3), none in the others
SHAPES_SKIPS = 1
KERNELS = {
    "dense_queue": ("pbrt_tpu_torch/csrc/dense_queue.cu",
                    "pbrt_tpu/ops/pallas_intersect.py:761"),
    "dense_queue_cull": ("pbrt_tpu_torch/csrc/dense_queue.cu",
                         "pbrt_tpu/ops/pallas_intersect.py:761"),
    "dense_loop": ("pbrt_tpu_torch/csrc/dense_loop.cu",
                   "pbrt_tpu/ops/pallas_intersect.py:329"),
    "dense_loop_motion": ("pbrt_tpu_torch/csrc/dense_loop.cu",
                          "pbrt_tpu/ops/pallas_intersect.py:329"),
}
# the TPU harnesses K1 and K2 themselves stand in for
ALSO_REPLACES = {
    "dense_queue": "the sort of pbrt_tpu/ops/pallas_intersect.py:812",
    "dense_queue_cull": "scripts/debug/dissect_queue2.py:56",
    "dense_loop": "scripts/debug/micro_loop.py:91",
}
# K2's ablation modes (csrc/dense_loop.cu::LoopMode) and the tile dump:
# each with the TPU harness whose question it answers
HARNESSES = {
    "dense_loop_ablate[empty]": "scripts/ablate_pick.py:59",
    "dense_loop_ablate[stage]": "scripts/ablate_pick.py:59",
    "dense_loop_ablate[sections]": "scripts/ablate_kernel_step.py:44",
    "dense_loop_ablate[direct]": "scripts/ablate_loop.py:39",
    "dense_tile_dump": "scripts/debug/dbg_dense_dump.py:49; "
                       "scripts/debug/dbg_dense_full.py:45",
}
# f32 operations per ray-triangle test of each ablation mode
ABLATE_FLOPS = {"empty": 0, "stage": 0, "sections": 42,
                "direct": kw.TEST_FLOPS}
TINY_PICKS = [0, 1, 2, 2]


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _ms(d):
    """The device ms of a kernel_workloads.device_ms result, or None."""
    return None if d is None else d[0]


def _dev(rec):
    """A record's device ms (kernel_workloads.device_ms), as text."""
    d = rec["device"]
    return "not measured" if d is None else f"{d[0]:.4f}"


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def compare_kernels(scene, batches, card, k2, seams=False, skips=0,
                    t_share=T_SHARE):
    """K1's two instantiations and a K2 (`k2`: "dense_loop" or
    "dense_loop_motion") against their plain versions on the same CUDA
    tensors; K2 takes the lists K1 made.  Returns {kernel: {batch:
    record}}.

    seams (static K2 only): the batches hold rays through shared mesh
    edges by construction (the matched-RNG integrator's raw Sobol'
    samples on axis-aligned geometry), where two f32 evaluations may
    each pick one of the edge's triangles, or one see an edge-grazing
    occluder the other misses.  There every closest-hit lane whose
    triangle differs from the plain version's must be such a tie
    (dense.loop_prim_tie), in place of the share of lanes that must agree
    on the triangle, and every any-hit lane whose occluded flag differs
    must have found a triangle that an f32 evaluation may accept or
    reject (dense.loop_hit_marginal), in place of identical flags.
    skips (with seams): how many closest-hit lanes of a batch may differ
    without a tie, each explained by dense.loop_prim_skipped (every
    triangle the farther answer passed is one rounding may reject: a
    graze of a silhouette, or a crack between the two faces of a shared
    edge, which are printed with their lanes)."""
    motion = k2 == "dense_loop_motion"
    cb, Wt = scene.dense_cb, scene.dense_w
    res = {"dense_queue": {}, "dense_queue_cull": {}, k2: {}}
    for name, (r16, tmax, tm) in batches.items():
        # --- K1's cull: hits identical, near within 1e-6 relative ---
        hits, near = dense.tile_queue(r16, tmax, cb)
        hits_p, near_p = dense.tile_queue_plain(r16, tmax, cb)
        check(torch.equal(hits, hits_p), f"K1 cull {name}: hits differ")
        err = (near - near_p)[hits].abs()
        rel = (err / near_p[hits].abs().clamp(min=1e-30)).max().item() \
            if err.numel() else 0.0
        check(rel <= 1e-6, f"K1 cull {name}: near rel err {rel}")
        # --- K1's lists: equal to the plain version's bit for bit ---
        cl, na = dense.tile_chunk_lists(r16, tmax, cb)
        cl_p, na_p = dense.tile_chunk_lists_plain(r16, tmax, cb)
        check(torch.equal(cl, cl_p) and torch.equal(na, na_p),
              f"K1 {name}: chunk lists differ from the plain version's")
        n_tiles, C = cl.shape
        for key, fn, plain, mode, e in (
                ("dense_queue", lambda: dense.tile_chunk_lists(r16, tmax, cb),
                 lambda: dense.tile_chunk_lists_plain(r16, tmax, cb), "list",
                 0),
                ("dense_queue_cull", lambda: dense.tile_queue(r16, tmax, cb),
                 lambda: dense.tile_queue_plain(r16, tmax, cb), "cull",
                 err.max().item() if err.numel() else 0.0)):
            res[key][name] = dict(
                max_abs_err=e, ms=kw.time_ms(fn, 20, r16.device),
                device=kw.device_ms(fn, 20),
                plain_ms=kw.time_ms(plain, 20, r16.device),
                bound=kw.queue_bound(mode, r16, tmax, cb),
                active=na.float().mean().item())

        # --- K2: the kernel's lists into kernel and plain version ---
        if motion:
            def run_k():
                return dense.loop_hits_motion(r16, tmax, tm, Wt, cl, na,
                                              scene.dense_static)

            def run_p():
                return dense.loop_hits_motion_plain(r16, tmax, tm, Wt, cl,
                                                    na)
        else:
            def run_k():
                return dense.loop_hits(r16, tmax, Wt, cl, na)

            def run_p():
                return dense.loop_hits_plain(r16, tmax, Wt, cl, na)
        t_k, p_k = run_k()
        t_p, p_p = run_p()
        anyhit = r16[:, 12] > 0.5
        found_agree = ((p_k >= 0) == (p_p >= 0)).float().mean().item()
        prim_agree = (p_k == p_p).float().mean().item()
        closest = ~anyhit & (p_k == p_p) & (p_k >= 0)
        terr = (t_k - t_p)[closest].abs()
        # t = num / (s0+s1+s2) cancels badly on some lanes, so no fixed
        # bound holds between two f32 evaluations on every lane.  Every
        # lane of both is held to the f32 rounding bound of the exact t of
        # its winning triangle; the share of lanes where they agree within
        # 1e-5 relative is held to a floor.
        if motion:
            t64, bnd = dense.loop_t_reference_motion(
                r16[closest], tm[closest], Wt, p_k[closest])
        else:
            t64, bnd = dense.loop_t_reference(r16[closest], Wt,
                                              p_k[closest])
        ratio_k = ((t_k[closest] - t64).abs() / (bnd * t64.abs())).max(
        ) if closest.any() else torch.tensor(0.0)
        ratio_p = ((t_p[closest] - t64).abs() / (bnd * t64.abs())).max(
        ) if closest.any() else torch.tensor(0.0)
        # (a batch whose lanes hit no triangle, as a shadow walk's may,
        # has no t to compare)
        share = ((terr <= 1e-5 * t_p[closest].abs()).double().mean().item()
                 if closest.any() else 1.0)
        occ_same = torch.equal((p_k >= 0)[anyhit], (p_p >= 0)[anyhit])
        differ = ~anyhit & (p_k >= 0) & (p_p >= 0) & (p_k != p_p)
        occ_differ = anyhit & ((p_k >= 0) != (p_p >= 0))
        if seams:
            lanes = torch.nonzero(differ)[:, 0]
            tie = dense.loop_prim_tie(r16[lanes], Wt, p_k[lanes],
                                      p_p[lanes])
            lanes = lanes[~tie]
            # (past `skips` lanes the batch fails whatever they are)
            some = lanes[:skips]
            explained, crack = dense.loop_prim_skipped(
                r16[some], tmax[some], Wt, p_k[some], p_p[some])
            unexplained = len(some) - int(explained.sum())
            for i, c in zip(some.tolist(), crack.tolist()):
                print(f"{k2} {name}: lane {i} kernel prim {int(p_k[i])}, "
                      f"plain prim {int(p_p[i])}: not a tie, "
                      + ("a crack between the two faces of an edge"
                         if c else "a graze"))
            unexplained_occ = int(occ_differ.sum()) - int(
                dense.loop_hit_marginal(
                    r16[occ_differ], tmax[occ_differ], Wt,
                    torch.maximum(p_k, p_p)[occ_differ]).sum())
        print(f"{k2} {name}: B={r16.shape[0]} any-hit lanes="
              f"{int(anyhit.sum())} found agree={found_agree:.6f} "
              f"prim agree={prim_agree:.6f} closest lanes compared="
              f"{int(closest.sum())} t within 1e-5 rel of plain={share:.6f} "
              f"(floor {t_share}) largest t err / f32 bound: kernel "
              f"{ratio_k.item():.4f} plain {ratio_p.item():.4f} occluded "
              f"identical={occ_same}"
              + (f" closest lanes of another prim {int(differ.sum())}, of "
                 f"them not a tie {len(lanes)} (at most {skips}), not "
                 f"explained {unexplained}; any-hit lanes of another flag "
                 f"{int(occ_differ.sum())}, of them not marginal "
                 f"{unexplained_occ}" if seams else ""))
        check(found_agree >= 0.9999, f"{k2} {name}: found agree "
              f"{found_agree}")
        if seams:
            check(len(lanes) <= skips and unexplained == 0,
                  f"{k2} {name}: {len(lanes)} lanes found another triangle "
                  f"than the plain version's without a tie (at most "
                  f"{skips}), {unexplained} of them not explained by "
                  "rounding")
        else:
            check(prim_agree >= 0.999, f"{k2} {name}: prim agree "
                  f"{prim_agree}")
        check(ratio_k <= 1.0, f"{k2} {name}: kernel t beyond the f32 bound")
        check(ratio_p <= 1.0, f"{k2} {name}: plain t beyond the f32 bound")
        check(share >= t_share, f"{k2} {name}: only {share} of lanes "
              "within 1e-5")
        if seams:
            check(unexplained_occ == 0, f"{k2} {name}: {unexplained_occ} "
                  "occluded flags differ on a hit no rounding explains")
        else:
            check(occ_same, f"{k2} {name}: occluded flags differ")
        *k2_bound, tests = kw.loop_bound(r16, tmax, Wt, cl, na, t_k, p_k,
                                         scene.dense_static, time=tm)

        res[k2][name] = dict(
            max_abs_err=terr.max().item() if terr.numel() else 0.0,
            ms=kw.time_ms(run_k, 20, r16.device), device=kw.device_ms(run_k),
            plain_ms=kw.time_ms(run_p, 5, r16.device), bound=k2_bound,
            tests=tests)
        q, qc, k = (res["dense_queue"][name], res["dense_queue_cull"][name],
                    res[k2][name])
        print(f"K1 {name}: B={r16.shape[0]} tiles={n_tiles} C={C} active "
              f"chunks/tile={na.float().mean().item():.2f}, lists equal the "
              f"plain version's, cull hits identical, near max rel err="
              f"{rel:.3e}; lists {_dev(q)} ms device, {q['ms']:.4f} ms "
              f"events, plain {q['plain_ms']:.4f} ms, bound "
              f"{q['bound'][0]:.5f} ms ({q['bound'][1]}); cull {_dev(qc)} "
              f"ms device, {qc['ms']:.4f} ms events, plain "
              f"{qc['plain_ms']:.4f} ms, bound {qc['bound'][0]:.5f} ms | "
              f"{k2} {_dev(k)} ms device, {k['ms']:.4f} ms events, plain "
              f"{k['plain_ms']:.4f} ms, {tests[0]} tests on static chunks, "
              f"{tests[1]} on moving ones, bound {k2_bound[0]:.5f} ms "
              f"({k2_bound[1]}) on {card}")
    return res


def compare_list_cases(device):
    """K1's lists and cull against their plain versions on its edge cases
    (kernel_workloads.queue_cases: equal and signed-zero entry t, dead
    and all-miss tiles, 1, 48 and 576 chunks) and on the cluster mesh's
    z40 rays (514 chunks)."""
    cases = kw.queue_cases(device)
    z40 = kw.cluster_rays_z40(device)
    cases["z40"] = (z40.r16, z40.tmax, z40.chunk_bounds)
    for name, (r16, tmax, cb) in cases.items():
        cl, na = dense.tile_chunk_lists(r16, tmax, cb)
        cl_p, na_p = dense.tile_chunk_lists_plain(r16, tmax, cb)
        check(torch.equal(cl, cl_p) and torch.equal(na, na_p),
              f"K1 {name}: chunk lists differ from the plain version's")
        hits, near = dense.tile_queue(r16, tmax, cb)
        hits_p, near_p = dense.tile_queue_plain(r16, tmax, cb)
        rel = ((near - near_p).abs()
               / near_p.abs().clamp(min=1e-30))[hits_p]
        check(torch.equal(hits, hits_p) and (
            rel.numel() == 0 or rel.max().item() <= 1e-6),
            f"K1 cull {name}: differs from the plain version")
    print("K1 edge cases and z40: lists equal the plain version's bit for "
          "bit, cull hits identical and near within 1e-6 rel on "
          + ", ".join(f"{k} (C={v[2].shape[0]}, {v[0].shape[0]} rays)"
                      for k, v in cases.items()))


def check_image(img, what):
    check(bool(torch.isfinite(img).all()), f"{what}: non-finite values")
    check(bool((img >= 0).all()), f"{what}: negative values")
    check(img.mean().item() > 0, f"{what}: black image")


def check_launches(counts, expect, what):
    """expect: {kernel: exact count}; every kernel of the path launched."""
    for k, n in expect.items():
        check(counts[k] == n, f"{what}: {k} launched {counts[k]} times, "
              f"expected {n}")


def stat_rays(stats):
    """Regular plus shadow ray tests of a utils.stats.Stats (the rays
    count_rays counts)."""
    return (stats.counters["Intersections/Regular ray intersection tests"]
            + stats.counters["Intersections/Shadow ray intersection tests"])


def reference_gate(film, spp):
    """16x16-block means of the render against the reference binary's,
    at the thresholds of tests/test_reference_parity.py:108-118."""
    d = np.load(REF_BLOCKS)
    ref_blocks, k = d["blocks"], int(d["block"])
    ours = film.raw.cpu().numpy() / spp
    bo = ours.reshape(16, k, 16, k, 31).mean((1, 3))
    lum_r, lum_o = ref_blocks.sum(-1), bo.sum(-1)
    mask = lum_r > lum_r.mean() * 0.05
    med = float(np.median(np.abs(lum_o - lum_r)[mask] / lum_r[mask]))
    spec_r = ref_blocks.reshape(-1, 31)[mask.ravel()].mean(0)
    spec_o = bo.reshape(-1, 31)[mask.ravel()].mean(0)
    ratio = spec_o / np.maximum(spec_r, 1e-9)
    flat = float(np.abs(ratio / ratio.mean() - 1.0).max())
    return med, flat


def refrng_gate(film, ref):
    """tests/test_refrng_parity.py:53-65's four figures of a matched-RNG
    render against the reference binary's image."""
    ours = film.weighted.cpu().numpy()
    lo, lr = ours.sum(-1), ref.sum(-1)
    rel = np.abs(lo - lr) / np.maximum(lr, 1e-3)
    m = rel < 1e-2
    band = np.abs(ours[m] - ref[m]) / np.maximum(ref[m], 1e-3)
    return {"frac_close": float(m.mean()), "median_rel": float(np.median(rel)),
            "mean_ratio": float(abs(lo.mean() / lr.mean() - 1.0)),
            "band_median": float(np.median(band))}


def metadata_gate(film):
    """tests/test_tools.py:152-164's figures of the depth render: the
    centre pixel's error, the median and largest 6x6-block-median error."""
    ref = np.load(META_REF)["depth"]
    ours = filmmod.develop_spectral(film).cpu().numpy()[:, :, 0]
    check(ours.shape == ref.shape == (48, 48), "metadata: image shape")
    bs, nb = 6, 8
    bm_r = np.median(ref.reshape(nb, bs, nb, bs), axis=(1, 3))
    bm_o = np.median(ours.reshape(nb, bs, nb, bs), axis=(1, 3))
    sel = bm_r > 1e-3
    rel = np.abs(bm_o[sel] - bm_r[sel]) / bm_r[sel]
    return (float(abs(ours[24, 24] / ref[24, 24] - 1.0)),
            float(np.median(rel)), float(rel.max()))


def compare_cpu(renders):
    """Each (name, render(device) -> film) at 32x32 on CUDA and on the
    CPU: image means within 1%, >= 95% of pixels within 1e-2."""
    for name, render in renders:
        g, c = (filmmod.develop_spectral(render(dev)).cpu().numpy().sum(-1)
                for dev in ("cuda", "cpu"))
        mean_rel = abs(g.mean() / c.mean() - 1.0)
        close = (np.abs(g - c) <= 1e-2 * np.abs(c)).mean()
        print(f"GPU vs CPU {name} 32x32 2spp: mean {g.mean():.6f} vs "
              f"{c.mean():.6f} (rel {mean_rel:.3e}), pixels within 1e-2 "
              f"rel {close:.4f}")
        check(mean_rel < 0.01, f"{name}: GPU/CPU image mean differs by "
              f"{mean_rel}")
        check(close >= 0.95, f"{name}: only {close} of pixels agree "
              "within 1e-2")


def cornell_32(dev):
    scene, cam = flagship.cornell(device=dev)
    return path.render(scene, cam(32, 32),
                       filmmod.make_film(32, 32, "gaussian", device=dev),
                       SamplerConfig("sobol", 0, 2), 2, max_depth=DEPTH)


def motion_32(dev):
    job = parse_scene(MOTION_SCENE, device=dev)
    job.film_width = job.film_height = 32
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def realistic_camera(dev, ca=False):
    """The double-Gauss 50 mm at Cornell's LookAt, stopped to 8 mm and
    focused on the box's middle by the paraxial sweep."""
    return lens.build_lens_camera(
        "realistic", tfm.look_at(*CORNELL_LOOK),
        lens.read_dat_lens(DGAUSS, 8.0), focus_distance=7.0,
        film_diag=0.035, ca_enabled=ca, device=dev)


def omni_lens_file(d):
    """The port's lenstool: the .dat lens converted to omni JSON (its stop
    opened to the 8 mm of phase 14; `convert` keeps the .dat reader's
    default 1 mm), a 64x64 microlens array inserted, its lenslets'
    centres jittered by up to 20 um."""
    lenstool.convert(DGAUSS, os.path.join(d, "dgauss.json"))
    out = os.path.join(d, "dgauss_ml.json")
    lenstool.insert_microlens(
        os.path.join(d, "dgauss.json"), out, 64, 64,
        [{"radius": 0.25, "thickness": 0.4, "ior": 1.5,
          "semi_aperture": 0.2, "conic_constant": 0.0}])
    with open(out) as f:
        j = json.load(f)
    for srf in j["surfaces"]:
        if srf["radius"] == 0:
            srf["semi_aperture"] = 4.0
    j["microlens"]["offsets"] = np.random.RandomState(7).uniform(
        -2e-5, 2e-5, (64 * 64, 2)).tolist()
    with open(out, "w") as f:
        json.dump(j, f)
    return out


def omni_camera(dev, path_json):
    surfs, micro = lens.read_json_lens(path_json)
    return lens.build_lens_camera(
        "omni", tfm.look_at(*CORNELL_LOOK), surfs, focus_distance=7.0,
        film_diag=0.035, microlens=micro, microlens_sensor_offset=0.001,
        microlens_sim_radius=1, device=dev)


def eye_camera(dev):
    """The 5-surface eye in metres (the spec's mm times 1e-3) with its
    media's IoRs and HURB diffraction at the 4 mm pupil."""
    _, surfs = lens.read_eye_spec(EYE_SPEC, 1e-3)
    return lens.build_lens_camera(
        "realisticEye", tfm.look_at(*CORNELL_LOOK), surfs,
        film_distance=16.32e-3, retina_radius=12e-3,
        retina_semi_diam=4e-3, film_diag=8e-3,
        ior_spectra=[np.full(31, v, np.float32) for v in EYE_IORS],
        pupil_diameter=4e-3, diffraction=True, device=dev)


def render_32(camera_fn, kind="sobol", trace=None):
    """A render(dev) of the Cornell model at 32x32, 2 spp, through the
    camera camera_fn(dev) (None: Cornell's perspective one), the sampler
    `kind` and trace(camera) (None: trace_paths)."""
    def render(dev):
        scene, cam = flagship.cornell(device=dev)
        cam = cam(32, 32) if camera_fn is None else camera_fn(dev)
        return path.render(scene, cam,
                           filmmod.make_film(32, 32, "gaussian", device=dev),
                           SamplerConfig(kind, 0, 2), 2, max_depth=DEPTH,
                           trace_fn=None if trace is None else trace(cam))
    return render


def pass_profile(scene, camera, cfg, trace=None, depth=DEPTH):
    """One 65,536-ray pass (sample 0 of the first 65,536 pixels: camera
    rays, then trace(scene, ...), default trace_paths, with the keywords
    and ray differentials `path.render` would give it) under
    torch.profiler, after the timed render of the same cell warmed it:
    (device ms, kernel launches) or None if the trace held no device
    time."""
    ids = torch.arange(RAYS_PER_PASS, device=scene.device)
    trace = trace or path.trace_paths
    opts, use_rd = path.trace_options(scene, camera, trace)

    def one_pass():
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, W, H, cfg, ids, 0)
        if use_rd:
            opts["ray_diff"] = path.camera_ray_differentials(
                camera, W, H, cfg, pid, sidx, path.generate_fn(camera),
                cfg.spp)
        trace(scene, ray, pid, sidx, cfg, max_depth=depth, **opts)
    return unit_profile(one_pass)


def unit_profile(fn):
    """(device ms, kernel launches) of fn() under torch.profiler, or None
    if the trace held no device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kw.device_us(e) > 0]
    if not ev:
        return None
    return (sum(kw.device_us(e) for e in ev) / 1e3,
            sum(e.count for e in ev))


def _prof(p):
    return ("not measured" if p is None
            else f"{p[1]:.0f} launches, {p[0]:.2f} ms device time a pass")


def phase10(scene, card):
    """The kernel harnesses (s1-s7) through the tools' entry points, with
    the counts set to 0 just before and read just after; then each
    ablation mode and the tile dump against its plain version, timed, for
    the kernels line.  Returns {"counts", "rows"}."""
    dense.reset_launch_counts()
    t0 = time.perf_counter()
    abl = ablate_k2.run(ablate_k2.parse_args(
        ["--workload", "cornell", "cluster", "--g", "1", "8", "--rounds",
         "3", "--reps", "10"]), scene=scene)
    dis = dissect_intersect.run(dissect_intersect.parse_args(
        ["--scene", "cornell", "--batch", str(1 << 18), "--rounds", "3",
         "--reps", "8"]), scenes={"cornell": scene})
    dumps = [dump_tile.run(dump_tile.parse_args(
        ["--picks"] + [str(c) for c in TINY_PICKS])),
        dump_tile.run(dump_tile.parse_args(["--tile", "0"]))]
    torch.cuda.synchronize()
    counts = dict(dense.LAUNCHES)
    dt = time.perf_counter() - t0
    for k in ("dense_queue", "dense_queue_cull", "dense_loop",
              "dense_tile_dump", *map(dense.ablate_kernel, ABLATE_FLOPS)):
        check(counts[k] > 0, f"harnesses: {k} never launched")
    check(counts["dense_loop_motion"] == 0, "harnesses: K2 motion launched")
    (_, B), stage_ms = next(iter(dis.items()))
    whole = kw.spread(stage_ms["intersect"])[0]
    for d in dumps:
        # dump_tile raises on any of these; held here again, and the tile
        # must accept enough tests for the flags to say anything
        check(d["k2_equal"] and d["bad"] == d["t_beyond"] == 0
              and d["unexplained"] == 0, f"tile dump {d['picks']}: kernel "
              "and plain part")
        check(d["accepted"] >= 20
              and d["accept_differ"] <= d["accepted"] // 10,
              f"tile dump {d['picks']}: {d['accepted']} tests accepted, "
              f"{d['accept_differ']} flags differ")
    print(f"phase 10 kernel harnesses: ablate_k2 (cornell_random, cluster "
          f"g=1, g=8), dissect_intersect (Cornell B={B}: intersect "
          f"{whole:.4f} ms), dump_tile (picks {TINY_PICKS}, tile 0's list: "
          + ", ".join(f"{d['accepted']} accepted, {d['accept_differ']} "
                      "flags differ" for d in dumps)
          + f") in {dt:.1f} s, launches {counts} on {card}")

    # --- rows: each mode and the dump against its plain version, timed ---
    wl = abl["cornell_random"]["workload"]
    args = wl.args()
    _, p_k2 = dense.loop_hits(*args)
    live = int((wl.tmax > 0).sum())
    tests = {"empty": 0, "stage": 0,
             "sections": int((wl.n_active.repeat_interleave(dense.TILE)
                              * (wl.tmax > 0)).sum()) * wl.chunk,
             "direct": sum(dense.loop_test_counts(
                 wl.r16, wl.tmax, p_k2, wl.chunk_list, wl.n_active,
                 wl.chunk, wl.chunk_static))}
    rows = []
    cluster = abl["cluster g=8"]["times"]
    for m in ("empty", "stage", "sections", "direct"):
        name = f"dense_loop_ablate[{m}]"
        t_k, p_k = dense.loop_hits_ablate(m, *args)
        b = kw.bound(ABLATE_FLOPS[m] * tests[m],
                     kw.loop_bytes(m, *args, t_k, p_k,
                                   chunk_static=wl.chunk_static))
        rows.append({
            "name": name, "route": "cuda",
            "source": "pbrt_tpu_torch/csrc/dense_loop.cu",
            "replaces": HARNESSES[name], "launches": counts[name],
            "max_abs_err": max(r["errs"][m] for k, r in abl.items()
                               if k != "sweep"),
            "ms": kw.spread(abl["cornell_random"]["times"][m])[0],
            "plain_ms": kw.time_ms(lambda m=m: dense.loop_hits_ablate_plain(
                m, *args), 3, wl.r16.device),
            "device_ms": _ms(kw.device_ms(
                lambda m=m: dense.loop_hits_ablate(m, *args))),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "ms_cluster_g8": kw.spread(cluster[m])[0],
            "workload": f"cornell_random, {wl.listed} listed chunks, "
                        f"{live} live lanes"})
    tiny = kw.tiny600(scene.dense_w.device)
    picks = torch.tensor(TINY_PICKS, dtype=torch.int32,
                         device=tiny.r16.device)

    def dump():
        return dense.tile_dump(tiny.r16, tiny.tmax, tiny.W, picks, 0)
    out = dump()
    n_tests = len(TINY_PICKS) * tiny.chunk * dense.TILE
    # the ray columns the tests read, tmax, the picks, the staged rows of
    # each distinct pick, the outputs
    b = kw.bound(kw.TEST_FLOPS * n_tests,
                 dense.TILE * 11 * 4 + nbytes(picks, *out.values())
                 + len(set(TINY_PICKS)) * dense.LOOP_ROWS * tiny.chunk * 4)
    rows.append({
        "name": "dense_tile_dump", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/dense_loop.cu",
        "replaces": HARNESSES["dense_tile_dump"],
        "launches": counts["dense_tile_dump"],
        "max_abs_err": max(d["max_abs_err"] for d in dumps),
        "ms": kw.time_ms(dump, 20, picks.device),
        "device_ms": _ms(kw.device_ms(dump)),
        "plain_ms": kw.time_ms(lambda: dense.tile_dump_plain(
            tiny.r16[:dense.TILE], tiny.tmax[:dense.TILE], tiny.W, picks),
            5, picks.device),
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
        "workload": f"tiny600 tile 0, picks {TINY_PICKS}"})
    return {"counts": counts, "rows": rows}


def materials_32(dev):
    job = parse_scene(MATS_SCENE, device=dev)
    job.film_width = job.film_height = 32
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def bsdf_params(B, t, dev, rough=0.2, eta=1.5, sigma=0.0, opacity=1.0,
                beckmann=False, disney=None):
    """A MaterialParams of B lanes of family t with the constant
    parameters of tests/test_bsdfs.py::_params (kd 0.6, ks 0.4, kr = kt =
    1, alpha 0.2, eta 1.5, conductor eta 0.2 and k 3), that family alone
    compiled."""
    def full(v, shape=()):
        return torch.full((B,) + shape, float(v), device=dev)
    sp = dict(kd=0.6, ks=0.4, kr=1.0, kt=1.0)
    return bsdf.MaterialParams(
        type=torch.full((B,), t, dtype=torch.int64, device=dev),
        **{k: full(v, (31,)) for k, v in sp.items()},
        rough_u=full(rough), rough_v=full(rough), eta=full(eta),
        sigma=full(sigma), eta_spec=full(0.2, (31,)),
        k_spec=full(3.0, (31,)), opacity=full(opacity, (31,)),
        beckmann=(torch.ones(B, dtype=torch.bool, device=dev) if beckmann
                  else None),
        disney=(torch.tensor(disney or [0.0] * 8, device=dev).expand(
            B, 8).contiguous() if t == MAT_DISNEY else None),
        families=(t,))


# phase 19's card against CPU tolerance: the card contracts multiply-adds
# and its transcendentals differ from the CPU's by ulps, which grow where
# a formula cancels (z = sqrt(1 - r^2) at the horizon, 1 - F near total
# internal reflection)
GPU_RTOL = 1e-3
GPU_ATOL = 1e-4
# Beckmann's sampled directions: the card's erfinv differs from the CPU's
# by ulps, and the 10 Newton steps on the erf-based CDF carry that into
# the slopes: at most 1.9e-3 on all but 1-3 lanes in 65,536, those up to
# 3.2e-2 (PERF.md)
BECKMANN_WI_TOL = 5e-3
BECKMANN_WI_SHARE = 0.9999


def _bsdf_close(a, b, rtol, mask=None, atol=2e-6):
    """max |a - b| over rtol |b| + atol times b's largest value, on mask."""
    atol = atol * float(b.abs().max().clamp(min=1e-30))
    if mask is not None:
        a, b = a[mask], b[mask]
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / (rtol * b.abs() + atol)).max())


def phase18(run_path, card, device):
    """The materials scene through the CLI's run_job (module docstring)."""
    t0 = time.perf_counter()
    job = parse_scene(MATS_SCENE, device=device)
    parse_s = time.perf_counter() - t0
    sc = job.scene
    check(job.film_width == W and job.film_height == H and job.spp == SPP
          and job.sampler_kind == "sobol"
          and job.integrator_params["maxdepth"] == DEPTH,
          "cornell_materials.pbrt settings")
    # the imagemap really loaded: its table entry is the PNG, not the 0.5
    # constant the parser falls back to
    tt = sc.tex_type.tolist()
    check(TEX_IMAGE in tt[1:], "cornell_materials: no image texture")
    tid = tt.index(TEX_IMAGE, 1)
    img = sc.tex_images[tid][:TEX_RES]
    check(float(img.std()) > 0.05 and bool((sc.mat_kd_tex == tid).any()),
          "cornell_materials: the imagemap did not load")
    png = filmio.read_image(os.path.join(os.path.dirname(MATS_SCENE),
                                         "textures", "floor.png"))
    check(abs(float(img.mean()) - float(png.mean())) < 0.02,
          "cornell_materials: the image table does not hold floor.png")
    camera = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, SPP)
    # the first hits' uv derivatives: ray differentials reach EWA
    ids = torch.arange(RAYS_PER_PASS, device=device)
    ray, _, _, pid, sidx = path.camera_rays_for_pixels(camera, W, H, cfg,
                                                       ids, 0)
    rd = path.camera_ray_differentials(camera, W, H, cfg, pid, sidx,
                                       path.generate_fn(camera), SPP)
    hit = isect.intersect_full(sc, ray, presorted=True, ray_diff=rd)
    share = float(((hit.duv != 0).any(-1) & hit.valid).sum()
                  / hit.valid.sum())
    check(share > 0.5, f"first-hit lanes with duv: {share}")
    _, use_rd = path.trace_options(sc, camera, path.trace_paths)
    check(use_rd, "render passes no ray differentials")
    cli.run_job(job, spp=1, max_depth=DEPTH)
    torch.cuda.synchronize()
    passes = SPP * (-(-W * H // (1 << 18)))
    t0 = time.perf_counter()
    (film, _), counts = run_path(
        "materials render", lambda: cli.run_job(job, spp=SPP,
                                                max_depth=DEPTH),
        {"dense_queue": (DEPTH + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * passes, "dense_loop_motion": 0}, sc)
    ms = (time.perf_counter() - t0) * 1e3 / passes
    m_img = filmmod.develop_spectral(film)
    check_image(m_img, "materials render")
    prof = pass_profile(sc, camera, cfg)
    print(f"phase 18 CLI cornell_materials.pbrt {W}x{H} {SPP} spp depth "
          f"{DEPTH} (families {sc.mat_families}, texture kinds "
          f"{sc.tex_kinds}, bump {sc.has_bump}, mix {sc.has_mix}, Beckmann "
          f"{sc.has_beckmann}): parse + build {parse_s:.2f} s, "
          f"{ms:.2f} ms/pass, image mean {m_img.mean().item():.6f}, "
          f"first-hit lanes with nonzero duv {share:.4f}, imagemap "
          f"{tuple(img.shape)} std {float(img.std()):.4f}, {_prof(prof)}, "
          f"launches {counts} on {card}")
    compare_cpu([("materials", materials_32)])


# phase 19: tests/test_bsdfs.py::test_sample_eval_pdf_consistency's cases
# (its Sw exit lobe is not ported), uber at opacity 0.5, the delta
# families, and Beckmann where a family takes it
BSDF_CASES = (
    ("matte", MAT_MATTE, {}),
    ("matte sigma 20", MAT_MATTE, {"sigma": 20.0}),
    ("plastic", MAT_PLASTIC, {}),
    ("metal", MAT_METAL, {}),
    ("substrate", MAT_SUBSTRATE, {}),
    ("translucent", MAT_TRANSLUCENT, {}),
    ("retroreflective", MAT_RETRO, {}),
    ("roughglass 0.3", MAT_ROUGHGLASS, {"rough": 0.3}),
    ("disney", MAT_DISNEY, {}),
    ("disney metallic", MAT_DISNEY,
     {"disney": [1.0, 0.0, 0.0, 0.5, 0.0, 1.0, 0.0, 0.0]}),
    ("disney sheen clearcoat", MAT_DISNEY,
     {"disney": [0.0, 0.5, 1.0, 0.5, 1.0, 0.8, 0.0, 0.0]}),
    ("disney specTrans", MAT_DISNEY,
     {"rough": 0.3, "disney": [0.0, 0.0, 0.0, 0.5, 0.0, 1.0, 0.9, 0.0]}),
    ("uber opacity 0.5", MAT_UBER, {"opacity": 0.5}),
    ("mirror", MAT_MIRROR, {}),
    ("glass", MAT_GLASS, {}),
    ("none", MAT_NONE, {}),
    ("plastic beckmann", MAT_PLASTIC, {"beckmann": True}),
    ("metal beckmann", MAT_METAL, {"beckmann": True}),
    ("uber beckmann", MAT_UBER, {"opacity": 0.5, "beckmann": True}),
    ("roughglass beckmann", MAT_ROUGHGLASS, {"rough": 0.3,
                                             "beckmann": True}),
)
BSDF_B_CPU = 1 << 16
BSDF_B = 1 << 20
WO_FIXED = (0.3, -0.2, 0.93)      # tests/test_bsdfs.py's WO


def phase19(card, dev, ref="cpu"):
    """Each family's eval_f / pdf_f / sample_f on the card against the
    CPU at B = 2^16 (random wo, wi, uniforms), then at B = 2^20 on the
    card alone: sample_f's f and pdf against eval_f / pdf_f at the
    sampled directions (rtol 1e-4, atol 1e-6, > half the lanes with pdf >
    1e-6: tests/test_bsdfs.py's limits), and the albedo E[f cos / pdf] of
    its non-delta samples against a uniform-sphere estimate of the
    integral of f |cos| (within 5 standard errors)."""
    g = torch.Generator(device="cpu").manual_seed(19)
    B = BSDF_B_CPU

    def unit(n):
        v = torch.randn(n, 3, generator=g)
        return v / v.norm(dim=-1, keepdim=True)
    wo, wi, u = unit(B), unit(B), torch.rand(3, B, generator=g)
    worst, bad = {}, []
    t0 = time.perf_counter()
    for name, t, opts in BSDF_CASES:
        out = {}
        for d in (dev, ref):
            p = bsdf_params(B, t, d, **opts)
            a, b, uu = wo.to(d), wi.to(d), u.to(d)
            out[d] = ((bsdf.eval_f(p, a, b), bsdf.pdf_f(p, a, b))
                      + tuple(bsdf.sample_f(p, a, uu[0], uu[1], uu[2])))
        ge, gp, gwi, gf, gpdf, gspec, gtr, geta = (x.cpu()
                                                   for x in out[dev])
        ce, cp, cwi, cf, cpdf, cspec, ctr, ceta = (x.cpu()
                                                   for x in out[ref])
        # the card's sampled f and pdf against the CPU's eval_f / pdf_f
        # at the card's own directions (non-delta lanes), so that a
        # direction an ulp apart on a steep lobe does not count twice;
        # delta lanes against the CPU's sample_f
        pc = bsdf_params(B, t, ref, **opts)
        ce_s, cp_s = bsdf.eval_f(pc, wo, gwi), bsdf.pdf_f(pc, wo, gwi)
        beck = opts.get("beckmann", False)
        same = (gtr == ctr) & ((gwi - cwi).abs().amax(-1) < 5e-2)
        peak = torch.zeros_like(same)
        if t == MAT_DISNEY:
            # the clearcoat's GTR1 cancellation (tests/test_torch_
            # materials.py): held to 0.25 within 2e-2 rad of the normal
            wh = wo + gwi
            wh = wh / wh.norm(dim=-1, keepdim=True)
            peak = wh[:, 2].abs() > float(np.cos(2e-2))
        ns = ~gspec
        ratios = {
            "f": _bsdf_close(ge, ce, GPU_RTOL, atol=GPU_ATOL),
            "pdf": _bsdf_close(gp, cp, GPU_RTOL, atol=GPU_ATOL),
            "sampled f": max(
                _bsdf_close(gf, ce_s, GPU_RTOL, ns & ~peak, GPU_ATOL),
                _bsdf_close(gf, ce_s, 0.25, ns & peak, GPU_ATOL),
                _bsdf_close(gf, cf, GPU_RTOL, gspec & same, GPU_ATOL)),
            "sampled pdf": max(
                _bsdf_close(gpdf, cp_s, GPU_RTOL, ns & ~peak, GPU_ATOL),
                _bsdf_close(gpdf, cp_s, 0.25, ns & peak, GPU_ATOL),
                _bsdf_close(gpdf, cpdf, GPU_RTOL, gspec & same, GPU_ATOL)),
            "eta_fac": _bsdf_close(geta, ceta, 1e-6, same, 0.0)}
        agree = float(same.float().mean())
        spec_eq = bool(torch.equal(gspec, cspec))
        dwi = (gwi - cwi).abs().amax(-1)[same]
        wi_err = float(dwi.max())
        # GGX: every lane within 1e-4; Beckmann: a share (the erfinv
        # tails), the rest within the 5e-2 of `same`
        wi_ok = (float((dwi <= BECKMANN_WI_TOL).float().mean())
                 >= BECKMANN_WI_SHARE if beck else wi_err <= 1e-4)
        worst[name] = (max(ratios.values()), agree, wi_err)
        if not (max(ratios.values()) <= 1.0 and agree >= 0.999 and spec_eq
                and wi_ok):
            bad.append(f"{name}: error / tolerance {ratios}, same choice "
                       f"{agree}, specular flags equal {spec_eq}, wi "
                       f"{wi_err}")
    cpu_s = time.perf_counter() - t0
    print(f"phase 19 eval_f / pdf_f / sample_f GPU vs CPU at B = {B} "
          f"({len(BSDF_CASES)} cases, {cpu_s:.1f} s; f and pdf within "
          f"{GPU_RTOL} relative or {GPU_ATOL} of the batch's largest, "
          "sampled f and pdf against the CPU's at the card's directions, "
          f"sampled wi within 1e-4 (Beckmann: {BECKMANN_WI_SHARE} of the "
          f"lanes within {BECKMANN_WI_TOL})): worst "
          "error / "
          "tolerance, lanes with the same discrete choice, sampled wi "
          "error: " + "; ".join(f"{k} {v[0]:.3f} {v[1]:.5f} {v[2]:.1e}"
                                for k, v in worst.items()))
    check(not bad, "phase 19 GPU vs CPU: " + " | ".join(bad))

    B = BSDF_B
    wo = torch.tensor(WO_FIXED, device=dev)
    wo = (wo / wo.norm()).expand(B, 3).contiguous()
    gd = torch.Generator(device=dev).manual_seed(20)
    lines, bad = [], []
    for name, t, opts in BSDF_CASES:
        p = bsdf_params(B, t, dev, **opts)
        u = torch.rand(3, B, generator=gd, device=dev)
        wi, f, pdf, spec, _, _ = bsdf.sample_f(p, wo, u[0], u[1], u[2])
        ok = pdf > 1e-6
        f2, p2 = bsdf.eval_f(p, wo, wi), bsdf.pdf_f(p, wo, wi)
        m = ok & ~spec
        cons = (bool(((f[m] - f2[m]).abs()
                      <= 1e-6 + 1e-4 * f2[m].abs()).all())
                and bool(((pdf[m] - p2[m]).abs()
                          <= 1e-6 + 1e-4 * p2[m].abs()).all()))
        okf = float(ok.float().mean())
        if not cons or okf <= 0.5:
            bad.append(f"{name}: sample_f's f / pdf against eval_f / pdf_f "
                       f"{cons}, pdf > 1e-6 on {okf} of the lanes")
        if not bool(m.any()):
            lines.append(f"{name} delta only")
            continue
        est = torch.where(m, f[:, 15] * wi[:, 2].abs()
                          / pdf.clamp(min=1e-6), 0.0)
        uu = torch.rand(2, B, generator=gd, device=dev)
        z = 1.0 - 2.0 * uu[0]
        rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * np.pi * uu[1]
        wu = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], -1)
        gu = bsdf.eval_f(p, wo, wu)[:, 15] * z.abs() * (4.0 * np.pi)
        e_is, e_u = float(est.mean()), float(gu.mean())
        se = float(np.sqrt(float(est.var()) / B + float(gu.var()) / B))
        zs = (e_is - e_u) / max(se, 1e-12)
        lines.append(f"{name} {e_is:.5f} vs {e_u:.5f} (z {zs:+.2f})")
        if abs(zs) >= 5.0:
            bad.append(f"{name}: albedo {e_is} by sample_f against {e_u} by "
                       f"uniform sampling (z {zs})")
    print(f"phase 19 at B = {B} on the card: sample_f against eval_f / "
          "pdf_f consistent, pdf > 1e-6 on over half the lanes: "
          f"{not bad}; albedo by sample_f vs uniform sphere: "
          + "; ".join(lines) + f" on {card}")
    check(not bad, "phase 19 on the card: " + " | ".join(bad))


LIGHTS_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                            "cornell_lights.pbrt")
REF_SPHERE_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                                "refpath_sphere_sky.pbrt")
STRATEGIES = ("uniform", "power", "spatial")
# phase 20: two strategies' image means may differ by at most this many
# standard errors of the mean of their per-pixel difference (the noise of
# the two renders, the image's structure cancelling), on
# tests/test_lightdistrib.py::test_strategies_unbiased's scene
STRATEGY_Z = 5.0
TWO_POINTS = """LookAt 0 0 3  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-30 30 -30 30]
Integrator "path" "integer maxdepth" [1]
WorldBegin
Material "matte" "float Kd" [.5]
Shape "trianglemesh" "point P" [-50 -50 0 50 -50 0 50 50 0 -50 50 0]
    "integer indices" [0 1 2 2 3 0]
LightSource "point" "float I" [100] "point from" [-20 0 5]
LightSource "point" "float I" [1] "point from" [20 0 5]
WorldEnd
"""
# the furnace and the point light over a plane: tests/test_integrators.py
# :43-95's scenes and limits, at 256x256
FURNACE = """LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
WorldBegin
LightSource "infinite" "float L" [1]
Material "matte" "float Kd" [{kd}]
Shape "sphere" "float radius" [1]
WorldEnd
"""
POINT_PLANE = """LookAt 0 0 3  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
WorldBegin
LightSource "point" "float I" [10] "point from" [0 0 1]
Material "matte" "float Kd" [.6]
Shape "trianglemesh" "point P" [-50 -50 0 50 -50 0 50 50 0 -50 50 0]
    "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def lights_32(dev):
    job = parse_scene(LIGHTS_SCENE, device=dev)
    job.film_width = job.film_height = 32
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def refpath_sphere_32(dev):
    """The matched-RNG render of refpath_sphere_sky.pbrt (32x32, 2 spp):
    its sphere light and its sky."""
    job = parse_scene(REF_SPHERE_SCENE, device=dev)
    n = job.film_width
    film = filmmod.make_film(n, n, "box", radius=(0.5, 0.5), device=dev,
                             pbrt_boundary=True)
    return refpath.render_ref(job.scene, cli.build_camera(job, n, n, dev),
                              film, n, n, job.spp,
                              max_depth=job.integrator_params["maxdepth"])


def shadow_mask_vs_plain(scene, camera, cfg, strategy):
    """The first trace_pair of a pass (bounce-1 rays and bounce-0 shadow
    rays; the lanes toward the sphere light closest-hit) through K1 and
    K2, and again with their plain versions in their place, on the card:
    the occluded masks must be equal bit for bit."""
    calls = []
    inner = isect.trace_pair

    def record(*a, **k):
        if not calls:
            calls.append((a, k))
        return inner(*a, **k)

    isect.trace_pair = record
    try:
        ids = torch.arange(RAYS_PER_PASS, device=scene.dense_w.device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(camera, W, H,
                                                           cfg, ids, 0)
        path.trace_paths(scene, ray, pid, sidx, cfg, max_depth=1,
                         light_strategy=strategy)
    finally:
        isect.trace_pair = inner
    a, k = calls[0]
    hit_k, occ_k = inner(*a, **k)
    lists, loop = dense.tile_chunk_lists, dense.loop_hits
    dense.tile_chunk_lists = dense.tile_chunk_lists_plain
    dense.loop_hits = dense.loop_hits_plain
    try:
        hit_p, occ_p = inner(*a, **k)
    finally:
        dense.tile_chunk_lists, dense.loop_hits = lists, loop
    sray, ign = a[2], k["ignore_light"]
    live = sray.tmax > 0
    out = dict(shadow=int(live.sum()), closest=int(((ign >= 0) & live)
                                                   .sum()),
               far=int((live & (sray.tmax > 1e29)).sum()),
               occluded=int(occ_k.sum()),
               mask_differs=int((occ_k != occ_p).sum()),
               prim_agree=float((hit_k.prim == hit_p.prim).float().mean()))
    check(out["closest"] > 0 and out["far"] > 0,
          f"lights trace_pair: no closest-hit or unbounded shadow lanes "
          f"{out}")
    check(out["mask_differs"] == 0, f"lights trace_pair: the shadow mask "
          f"differs from the plain path's on {out['mask_differs']} lanes")
    check(out["prim_agree"] >= 0.999, f"lights trace_pair: hits {out}")
    return out


def _gate_render(run_path, job, spp, depth, what):
    """run_job(job) through run_path (K1 and K2 (depth + 1) times a pass)
    -> its developed image [H,W,31], checked finite, non-negative and
    not black."""
    passes = spp * (-(-job.film_width * job.film_height // (1 << 18)))
    (film, _), _ = run_path(
        what, lambda: cli.run_job(job, spp=spp, max_depth=depth),
        {"dense_queue": (depth + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": (depth + 1) * passes, "dense_loop_motion": 0},
        job.scene)
    img = filmmod.develop_spectral(film)
    check_image(img, what)
    return img


def phase20(run_path, card, device, res):
    """Every light kind (module docstring)."""
    t0 = time.perf_counter()
    job = parse_scene(LIGHTS_SCENE, device=device)
    parse_s = time.perf_counter() - t0
    sc = job.scene
    strategy = dispatch.light_strategy(job.integrator_params)
    check(job.film_width == W and job.film_height == H and job.spp == SPP
          and job.sampler_kind == "sobol" and strategy == "spatial"
          and job.integrator_params["maxdepth"] == DEPTH,
          "cornell_lights.pbrt settings")
    check(sc.light_kinds == tuple(range(7)) and sc.has_mesh_lights
          and sc.has_sphere_lights and sc.has_infinite
          and tuple(sc.env_map.shape) == (128, 256, 31),
          f"cornell_lights: light kinds {sc.light_kinds}")
    camera = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, SPP)
    # K1 and K2 on this path's own batches, and its shadow mask
    batches = kw.main_path_batches(sc, camera, cfg, W, H, RAYS_PER_PASS,
                                   DEPTH, light_strategy=strategy)
    lres = compare_kernels(sc, {f"lights_{k}": v for k, v in
                                batches.items()}, card, "dense_loop")
    for k, v in lres.items():
        res[k].update(v)
    shadow = shadow_mask_vs_plain(sc, camera, cfg, strategy)
    # env sampling's peak memory at B = 2^17: the row search gathers one
    # cdf entry a lane a step, no [B, We+1] row and no [B, We, 31] map row
    u = torch.rand(2, 1 << 17, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lights.sample_env_direction(sc, u[0], u[1])
    torch.cuda.synchronize()
    env_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(env_peak < 64, f"env sampling at 2^17 lanes: {env_peak} MiB")
    print(f"phase 20 lights first trace_pair: {shadow['shadow']} shadow "
          f"lanes, {shadow['closest']} of them closest-hit (toward the "
          f"sphere light), {shadow['far']} with tmax 1e30 (distant, sky), "
          f"{shadow['occluded']} occluded; the mask equals the plain "
          f"path's bit for bit, hits' prim agree {shadow['prim_agree']:.6f}"
          f"; K1 active chunks/tile on bounce 1 "
          f"{res['dense_queue']['lights_bounce1']['active']:.2f} (Cornell "
          f"{res['dense_queue']['bounce1']['active']:.2f}), K2 device ms "
          f"{_dev(res['dense_loop']['lights_bounce1'])} (Cornell "
          f"{_dev(res['dense_loop']['bounce1'])}); env-map sampling of "
          f"2^17 lanes peaks at {env_peak:.2f} MiB above what it was given")

    # the render through the CLI
    cli.run_job(job, spp=1, max_depth=DEPTH)
    torch.cuda.synchronize()
    passes = SPP * (-(-W * H // (1 << 18)))
    t0 = time.perf_counter()
    (film, _), counts = run_path(
        "lights render", lambda: cli.run_job(job, spp=SPP, max_depth=DEPTH),
        {"dense_queue": (DEPTH + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * passes, "dense_loop_motion": 0}, sc)
    ms = (time.perf_counter() - t0) * 1e3 / passes
    l_img = filmmod.develop_spectral(film)
    check_image(l_img, "lights render")
    prof = pass_profile(sc, camera, cfg, trace=functools.partial(
        path.trace_paths, light_strategy=strategy))
    idle = ("not measured" if prof is None
            else f"{1 - prof[0] / ms:.3f}")
    print(f"phase 20 CLI cornell_lights.pbrt {W}x{H} {SPP} spp depth "
          f"{DEPTH} ({sc.n_lights} lights, kinds {sc.light_kinds}, "
          f"strategy {strategy}): parse + build {parse_s:.2f} s, "
          f"{ms:.2f} ms/pass, image mean {l_img.mean().item():.6f}, "
          f"{_prof(prof)}, idle share {idle}, launches {counts} on {card}")
    compare_cpu([("lights", lights_32),
                 ("refpath sphere light", refpath_sphere_32)])

    # the three strategies: on tests/test_lightdistrib.py's two point
    # lights over a plane (delta lights: no MIS) the same image within
    # their noise; on the lights scene their means are printed, not held:
    # NEE's MIS weight leaves out the selection pdf, as pbrt_tpu's does
    # (ROADMAP Queue 3), so non-delta lights' images depend on it
    for name in STRATEGIES:
        job.integrator_params["lightsamplestrategy"] = name
        m = float(_gate_render(run_path, job, GATE_SPP, DEPTH,
                               f"lights {name}").mean())
        print(f"phase 20 lights scene, strategy {name}, {GATE_SPP} spp: "
              f"image mean {m:.6f} (not held to the others')")
    job.integrator_params["lightsamplestrategy"] = strategy
    lums = {}
    for name in STRATEGIES:
        j = PbrtAPI(device).parse_string(TWO_POINTS)
        j.film_width, j.film_height = W, H
        j.integrator_params["lightsamplestrategy"] = name
        lums[name] = _gate_render(run_path, j, GATE_SPP, 1,
                                  f"two point lights, {name}").sum(-1)
    for name in STRATEGIES[1:]:
        d = lums[name] - lums["uniform"]
        z = abs(float(d.mean())) / (float(d.std()) / d.numel() ** 0.5)
        rel = abs(float(lums[name].mean() / lums["uniform"].mean()) - 1)
        print(f"phase 20 two point lights over a plane, strategy {name} vs "
              f"uniform, {GATE_SPP} spp: image means "
              f"{float(lums[name].mean()):.6f} vs "
              f"{float(lums['uniform'].mean()):.6f} (rel {rel:.3e}), "
              f"{z:.2f} standard errors of the mean pixel difference "
              f"(limit {STRATEGY_Z})")
        check(z < STRATEGY_Z, f"two point lights, {name}: mean off "
              f"uniform's by {z} standard errors")

    # the furnace and the point light over a plane, at 256x256
    def scene_job(text, spp, depth, what):
        j = PbrtAPI(device).parse_string(text)
        j.film_width, j.film_height = W, H
        return _gate_render(run_path, j, spp, depth, what).mean(-1)

    c0, c1 = 7 * W // 16, 9 * W // 16          # the middle eighth
    m0, m1 = W // 2 - 2, W // 2 + 2
    x0 = int(0.75 * W)                         # world x = 0.5
    half = float(scene_job(FURNACE.format(kd=0.5), 4, 5, "furnace 0.5")[
        c0:c1, c0:c1].mean())
    white = float(scene_job(FURNACE.format(kd=1.0), 4, 8,
                            "furnace white").mean())
    plane = scene_job(POINT_PLANE, 8, 2, "point light over a plane")
    centre = float(plane[m0:m1, m0:m1].mean())
    off = float(plane[m0:m1, x0 - 2:x0 + 2].mean())
    want_c = 0.6 / np.pi * 10.0
    want_o = want_c / 1.25 ** 1.5        # (0.5, 0, 0): r^2 1.25, cos r^-1
    print(f"phase 20 furnace {W}x{H}: albedo 0.5 centre {half:.5f} (0.5 "
          f"within 2%), white mean {white:.5f} (1 within 2%); point light "
          f"over a plane: centre {centre:.5f} vs {want_c:.5f} (2%), x=0.5 "
          f"{off:.5f} vs {want_o:.5f} (5%)")
    check(abs(half - 0.5) < 0.02 * 0.5, f"furnace 0.5: {half}")
    check(abs(white - 1.0) < 0.02, f"furnace white: {white}")
    check(abs(centre / want_c - 1) < 0.02, f"point light centre {centre}")
    check(abs(off / want_o - 1) < 0.05, f"point light off centre {off}")


# phase 21: the inverse render at full width (the Cornell model at 256x256,
# 65,536 rays a step, Sobol, depth 5, camera fixed): mat_kd and light_L
# from 0.5 and 0.7 of their values toward the render at their values, at
# make_train_step's lr 0.05, until the loss is below INV_DROP of the first.
# Adam moves each entry by about lr a step and light_L's entries are
# ~10-15, so 20 steps leave the loss at 0.42 of the first (the CPU at
# 32x32, PERF.md); 60 steps reach 0.056 there
INV_STEPS = 60
INV_LR = 0.05
INV_DROP = 0.1
# the card's gradients against the CPU's (32x32, 2 spp, depth 5): the two
# trace the same paths but where the card's contracted multiply-adds move
# a path across an edge or a lobe choice (phase 8, 19), and such a lane
# adds its own share to each entry it reaches
GRAD_CPU_RTOL = 1e-2
# tests/test_diff.py's bins and threshold, tests/test_diff_camera.py's
# components, steps and threshold; the pose recovery's Adam steps
FD_BINS = (0, 5, 15, 30)
CAM_W = 24
CAM_P = ([0.004, -0.003, 0.002, 0.02, -0.015, 0.01], 50.4)
POSE_STEPS = 240
POSE_LR = 2e-3
# the leaves each scene uses (a nonzero gradient): every
# DIFFERENTIABLE_FIELDS gradient must be finite (64x64, 1 spp, depth 3)
FINITE_USED = {MATS_SCENE: ("mat_kd", "mat_ks", "mat_kr", "mat_kt",
                            "light_L"),
               LIGHTS_SCENE: ("mat_kd", "light_L", "env_map")}


def fd_sphere(dev):
    """tests/test_diff.py's scene: a matte sphere under a constant
    infinite light, 8x8, on dev."""
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(type=MAT_MATTE,
                                    kd=np.full(31, 0.5, np.float32)))
    b.add_sphere(tfm.Transform(), 1.0, m)
    b.add_infinite_light(np.full(31, 1.0, np.float32))
    cam = projective.make_perspective(tfm.look_at([0, 0, -4], [0, 0, 0],
                                                  [0, 1, 0]), 30.0, 8, 8,
                                      device=dev)
    return b.build(device=dev), cam


def fd_checks(dev):
    """tests/test_diff.py's albedo (4 bins) and emission (env_map entry
    10) gradients against central finite differences, at its threshold
    max(3e-3, 0.05 |fd|).  Returns [(what, ad, fd)]."""
    sc, cam = fd_sphere(dev)
    ids = torch.arange(64, device=dev)
    cfg = SamplerConfig("sobol", 0, 4)
    out = []
    for key, tgt, samples, depth, bins in (
            ("mat_kd", 0.3, (0, 1), 3, FD_BINS),
            ("env_map", 0.0, (0,), 2, (10,))):
        target = torch.full((64, 31), tgt, device=dev)

        def loss(p):
            return diff.render_loss(p, sc, cam, 8, 8, cfg, ids, samples,
                                    target, max_depth=depth)
        params = {key: getattr(sc, key).clone()}
        p = {key: params[key].clone().requires_grad_(True)}
        g = torch.autograd.grad(loss(p), [p[key]])[0].reshape(-1)
        for i in bins:
            fd = diff.finite_difference_grad(loss, params, key, i, eps=2e-3)
            ad = float(g[i])
            out.append((f"{key}[{i}]", ad, fd))
            check(abs(ad - fd) < max(3e-3, 0.05 * abs(fd)),
                  f"gradient of {key}[{i}]: autograd {ad} vs finite "
                  f"difference {fd}")
        if key == "env_map":
            check(abs(ad) > 1e-5, f"env_map[10] gradient {ad}")
    return out


def camera_render(dev):
    """tests/test_diff_camera.py's per-pixel render: cornell(tessellate=
    False) at 24x24, depth 2, sample 0, summed over wavelength."""
    sc, cam_ctor = flagship.cornell(tessellate=False, device=dev)
    cam = cam_ctor(CAM_W, CAM_W)
    ids = torch.arange(CAM_W * CAM_W, device=dev)
    cfg = SamplerConfig("sobol", 0, 4)

    def render(delta, fov):
        L, _ = diff.render_samples({"cam_delta": delta, "cam_fov": fov}, sc,
                                   cam, CAM_W, CAM_W, cfg, ids, 0,
                                   max_depth=2)
        return L.sum(-1)
    return render


def camera_fd_check(dev):
    """tests/test_diff_camera.py::test_camera_grads_match_finite_
    differences: per-pixel derivatives (forward mode) of rx, tx and the
    fov against central differences; the share of significant pixels
    that agree within 10% must exceed 0.7.  Returns {component: share}."""
    render = camera_render(dev)
    d0 = torch.tensor(CAM_P[0], device=dev)
    f0 = torch.tensor(CAM_P[1], device=dev)
    shares = {}
    for name, comp, eps in (("rx", 0, 1e-4), ("tx", 3, 1e-4),
                            ("fov", None, 2e-3)):
        if comp is None:
            ad = torch.autograd.functional.jvp(
                lambda f: render(d0, f), f0, torch.ones((), device=dev))[1]
            fd = (render(d0, f0 + eps) - render(d0, f0 - eps)) / (2 * eps)
        else:
            e = torch.zeros(6, device=dev)
            e[comp] = 1.0
            ad = torch.autograd.functional.jvp(lambda d: render(d, f0), d0,
                                               e)[1]
            fd = (render(d0 + eps * e, f0) - render(d0 - eps * e, f0)) / (
                2 * eps)
        check(bool(torch.isfinite(ad).all()), f"camera {name}: non-finite")
        ad, fd = ad.detach().cpu().numpy(), fd.detach().cpu().numpy()
        scale = np.percentile(np.abs(fd), 75)
        sig = (np.abs(fd) > 0.2 * scale) & (np.abs(fd) < 20 * scale)
        rel = np.abs(ad - fd)[sig] / np.maximum(np.abs(fd[sig]), 0.2 * scale)
        shares[name] = float(np.mean(rel < 0.1))
        check(shares[name] > 0.7, f"camera {name}: {shares[name]} of "
              "pixels agree with finite differences")
    return shares


def pose_recovery(dev):
    """tests/test_diff_camera.py::test_camera_pose_recovery: cam_delta
    from a perturbed pose back toward identity by Adam (lr 2e-3, 240
    steps) on the robust per-pixel loss; the error must fall below 0.3
    of the start.  Returns (start error, end error, wall s)."""
    render = camera_render(dev)
    fov = torch.tensor(50.0, device=dev)
    with torch.no_grad():
        target = render(torch.zeros(6, device=dev), fov)
    true = np.asarray([0.004, -0.003, 0.002, 0.02, -0.015, 0.012])
    params = {"cam_delta": torch.tensor(true, dtype=torch.float32,
                                        device=dev)}
    state = diff.adam_init(params)
    t0 = time.perf_counter()
    for _ in range(POSE_STEPS):
        d = params["cam_delta"].detach().requires_grad_(True)
        d2 = (render(d, fov) - target) ** 2
        g = torch.autograd.grad(torch.mean(d2 / (1.0 + d2)), [d])[0]
        params, state = diff.adam_update({"cam_delta": d},
                                         {"cam_delta": g}, state, POSE_LR)
    err = float(torch.linalg.norm(params["cam_delta"]))
    wall = time.perf_counter() - t0
    err0 = float(np.linalg.norm(true))
    check(err < 0.3 * err0, f"pose recovery: error {err} of {err0}")
    return err0, err, wall


def grads_32(dev):
    """mat_kd and light_L gradients of a 32x32, 2 spp, depth 5
    render_loss of the Cornell model against a seeded target."""
    sc, cam = flagship.cornell(device=dev)
    target = torch.as_tensor(np.random.RandomState(21).rand(1024, 31)
                             .astype(np.float32) * 0.5, device=dev)
    p = {k: getattr(sc, k).clone().requires_grad_(True)
         for k in ("mat_kd", "light_L")}
    loss = diff.render_loss(p, sc, cam(32, 32), 32, 32,
                            SamplerConfig("sobol", 0, 2),
                            torch.arange(1024, device=dev), (0, 1), target,
                            max_depth=DEPTH)
    return dict(zip(p, (g.cpu() for g in torch.autograd.grad(
        loss, list(p.values())))))


def finite_grads(dev, scene_path, res=64):
    """Every DIFFERENTIABLE_FIELDS gradient of a res x res, 1 spp, depth 3
    render_loss of a scene: finite, and nonzero for the leaves it uses.
    Returns {leaf: largest |gradient|}."""
    job = parse_scene(scene_path, device=dev)
    cam = cli.build_camera(job, res, res, dev)
    sc = job.scene
    p = {k: getattr(sc, k).clone().requires_grad_(True)
         for k in diff.DIFFERENTIABLE_FIELDS}
    loss = diff.render_loss(p, sc, cam, res, res,
                            SamplerConfig(job.sampler_kind, 0, 1),
                            torch.arange(res * res, device=dev), (0,),
                            torch.zeros(res * res, 31, device=dev),
                            max_depth=3)
    out = {}
    for k, g in zip(p, torch.autograd.grad(loss, list(p.values()),
                                           allow_unused=True)):
        name = os.path.basename(scene_path)
        check(g is not None or k not in FINITE_USED[scene_path],
              f"{name}: no gradient reaches {k}")
        if g is None:
            continue
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {k} "
              "gradient")
        out[k] = float(g.abs().max())
        check(out[k] > 0 or k not in FINITE_USED[scene_path],
              f"{name}: zero {k} gradient")
    return out


def phase21(run_path, card, device, scene, camera):
    """Differentiable rendering (module docstring)."""
    cfg = SamplerConfig("sobol", 0, SPP)
    start, target, ids = profile_pass.grad_problem(scene, camera, W, H, cfg,
                                                   RAYS_PER_PASS, DEPTH)
    init, step = diff.make_train_step(scene, camera, W, H, cfg, target,
                                      max_depth=DEPTH, learning_rate=INV_LR)
    per_step = {"dense_queue": DEPTH + 1, "dense_queue_cull": 0,
                "dense_loop": DEPTH + 1, "dense_loop_motion": 0}
    none = dict.fromkeys(per_step, 0)
    params, state = start, init(start)
    # the first step by halves: the kernels run in the forward only
    (p, loss), _ = run_path("inverse render step 1 forward",
                            lambda: step.forward(params, ids, 0), per_step,
                            scene)
    (params, state), _ = run_path("inverse render step 1 backward",
                                  lambda: step.backward(p, loss, state),
                                  none, scene)
    losses = [float(loss.detach())]
    t0 = time.perf_counter()
    for i in range(1, INV_STEPS):
        (params, state, loss), _ = run_path(
            f"inverse render step {i + 1}",
            lambda: step(params, state, ids, 0), per_step, scene)
        losses.append(float(loss))
        for k in params:
            check(bool(torch.isfinite(state["mu"][k]).all()
                       and torch.isfinite(state["nu"][k]).all()),
                  f"inverse render step {i + 1}: a {k} gradient is not "
                  "finite")
    step_ms = (time.perf_counter() - t0) * 1e3 / (INV_STEPS - 1)
    check(all(np.isfinite(losses)), f"inverse render losses {losses}")
    check(losses[-1] < INV_DROP * losses[0], f"inverse render: loss "
          f"{losses[-1]} after {INV_STEPS} steps, first {losses[0]}")
    kd_ratio, l_ratio = (float((params[k] / getattr(scene, k))[
        getattr(scene, k) > 0].mean()) for k in ("mat_kd", "light_L"))
    # a forward pass of the same samples without autograd, and the rays
    # a step traces (trace_paths' count, as bench.py counts)
    with torch.no_grad():
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(camera, W, H, cfg,
                                                           ids, 0)
        n_rays = int(path.trace_paths(diff.apply_params(scene, params), ray,
                                      pid, sidx, cfg, max_depth=DEPTH,
                                      count_rays=True)[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            diff.render_samples(params, scene, camera, W, H, cfg, ids, 0,
                                max_depth=DEPTH)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / 5
    prof = profile_pass.profile_train_step(scene, camera, W, H, cfg, params,
                                           target, ids, DEPTH, INV_LR)
    f, b = prof["fwd"], prof["bwd"]
    check(b[4]["dense_queue"] == b[4]["dense_loop"] == 0,
          f"the profiled backward launched {b[4]}")
    print(f"phase 21 inverse render Cornell {W}x{H} ({RAYS_PER_PASS} rays "
          f"a step, sobol, depth {DEPTH}), mat_kd and light_L from 0.5 and "
          f"0.7 of their values, lr {INV_LR}: loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e} after {INV_STEPS} steps (ratio "
          f"{losses[-1] / losses[0]:.4f}, limit {INV_DROP}; step 20 "
          f"{losses[19] / losses[0]:.4f}), mat_kd / light_L at "
          f"{kd_ratio:.4f} / {l_ratio:.4f} of their values; K1 and K2 "
          f"{DEPTH + 1} a step, none in the backward, on {card}")
    print(f"phase 21 fwd+bwd step {step_ms:.2f} ms, forward pass under "
          f"no_grad {fwd_ms:.2f} ms (ratio {step_ms / fwd_ms:.2f}), "
          f"{n_rays} rays a step, fwd+bwd {n_rays / step_ms * 1e3:.4e} "
          f"rays/s; step peak memory {prof['peak_mib']:.1f} MiB "
          f"({prof['above_mib']:.1f} MiB above the scene and state); "
          f"profiled step: forward {f[2]} launches {f[1]:.2f} ms device "
          f"({f[0]:.2f} ms wall), backward {b[2]} launches {b[1]:.2f} ms "
          f"device ({b[0]:.2f} ms wall), idle share {prof['idle']:.3f}, "
          f"on {card}")

    for what, ad, fd in fd_checks(device):
        print(f"phase 21 finite difference {what}: autograd {ad:.6e}, "
              f"central difference {fd:.6e}")
    shares = camera_fd_check(device)
    print("phase 21 camera Jacobian against finite differences (24x24, "
          "depth 2): share of pixels within 10% " + ", ".join(
              f"{k} {v:.3f}" for k, v in shares.items()) + " (> 0.7)")
    err0, err, wall = pose_recovery(device)
    print(f"phase 21 pose recovery: {POSE_STEPS} Adam steps (lr {POSE_LR}) "
          f"in {wall:.2f} s, error {err0:.5f} -> {err:.5f} (ratio "
          f"{err / err0:.3f}, limit 0.3), on {card}")
    g, c = grads_32(device), grads_32("cpu")
    for k in g:
        err = float((g[k] - c[k]).abs().max() / c[k].abs().max())
        print(f"phase 21 GPU vs CPU {k} gradient, Cornell 32x32 2 spp: "
              f"largest difference {err:.3e} of the largest entry "
              f"(limit {GRAD_CPU_RTOL})")
        check(err < GRAD_CPU_RTOL, f"GPU vs CPU {k} gradient: {err}")
    for sp in FINITE_USED:
        m = finite_grads(device, sp)
        print(f"phase 21 {os.path.basename(sp)} 64x64 1 spp depth 3: every "
              "gradient finite; largest " + ", ".join(
                  f"{k} {v:.3e}" for k, v in m.items()))


def lens_phases(scene, pcam, cfg, run_path, card, tmpdir):
    """Phases 14-17 (see the module docstring) on the Cornell model, its
    perspective camera pcam, through run_path (main's counted runs)."""
    device = scene.dense_w.device
    per_pass = {"dense_queue": DEPTH + 1, "dense_queue_cull": 0,
                "dense_loop": DEPTH + 1, "dense_loop_motion": 0}

    def expect(n_passes, bands=1):
        return {k: v * n_passes * bands for k, v in per_pass.items()}

    def render(camera, spp, kind="sobol", filt="gaussian", trace=None):
        return path.render(scene, camera,
                           filmmod.make_film(W, H, filt, device=device),
                           SamplerConfig(kind, 0, spp), spp,
                           max_depth=DEPTH, max_rays_per_pass=RAYS_PER_PASS,
                           trace_fn=trace)

    def timed(what, fn, spp, bands=1):
        t0 = time.perf_counter()
        out, counts = run_path(what, fn, expect(spp, bands), scene)
        return out, counts, (time.perf_counter() - t0) * 1e3 / spp

    walls = {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        walls[name] = now - t_phase
        t_phase = now

    # --- phase 14: realistic ---
    t0 = time.perf_counter()
    lcam = realistic_camera(device)
    build_s = time.perf_counter() - t0
    ids = torch.arange(RAYS_PER_PASS, device=device)
    _, w0, _, _, _ = path.camera_rays_for_pixels(lcam, W, H, cfg, ids, 0)
    survive = (w0 > 0).float().mean().item()
    render(lcam, 1)
    lfilm, counts, ms = timed("realistic render", lambda: render(lcam, SPP),
                              SPP)
    l_img = filmmod.develop_spectral(lfilm)
    check_image(l_img, "realistic render")
    prof = pass_profile(scene, lcam, cfg)
    print(f"phase 14 realistic dgauss.50mm f/6.25 (8 mm stop), film "
          f"distance {lcam.film_distance.item() * 1e3:.3f} mm, Cornell "
          f"{W}x{H} {SPP} spp depth {DEPTH}: camera build {build_s:.3f} s, "
          f"camera rays surviving the stack {survive:.4f}, "
          f"{ms:.2f} ms/pass, image mean {l_img.mean().item():.6f}, "
          f"{_prof(prof)}, launches {counts} on {card}")

    lap("14")

    # --- phase 15: spectralpath with chromatic aberration ---
    ccam = realistic_camera(device, ca=True)

    def spectral(cam, w=W, h=H):
        return spectralpath.make_trace_spectral(CA_BANDS, camera=cam,
                                                width=w, height=h)
    sfilm, counts, ms = timed(
        "spectralpath CA render",
        lambda: render(ccam, SPP, trace=spectral(ccam)), SPP, CA_BANDS)
    s_img = filmmod.develop_spectral(sfilm)
    check_image(s_img, "spectralpath CA render")
    gap = abs(s_img.mean().item() / l_img.mean().item() - 1.0)
    prof = pass_profile(scene, ccam, cfg, spectral(ccam))
    print(f"phase 15 spectralpath {CA_BANDS} bands, chromatic aberration "
          f"on, dgauss, Cornell {W}x{H} {SPP} spp: {ms:.2f} ms/pass, image "
          f"mean {s_img.mean().item():.6f} vs phase 14's "
          f"{l_img.mean().item():.6f} (gap {gap:.3e}, limit {MEAN_GAP}), "
          f"{_prof(prof)}, launches {counts} on {card}")
    check(gap < MEAN_GAP, f"spectralpath CA: mean off phase 14's by {gap}")

    lap("15")

    # --- phase 16: omni with a microlens array, and the eye ---
    ml_json = omni_lens_file(tmpdir)
    for name, cam_fn in (("omni", lambda dev: omni_camera(dev, ml_json)),
                         ("realisticEye", eye_camera)):
        cam = cam_fn(device)
        _, w0, _, _, _ = path.camera_rays_for_pixels(cam, W, H, cfg, ids, 0)
        film, counts, ms = timed(f"{name} render",
                                 lambda: render(cam, GATE_SPP), GATE_SPP)
        img = filmmod.develop_spectral(film)
        check_image(img, f"{name} render")
        prof = pass_profile(scene, cam, cfg)
        extra = (f"microlens {cam.ml_dims} sim radius {cam.ml_sim_radius}, "
                 f"offsets {cam.ml_has_offsets}" if name == "omni" else
                 f"HURB {cam.diffraction}, IoRs {EYE_IORS}")
        print(f"phase 16 {name} ({extra}) Cornell {W}x{H} {GATE_SPP} spp: "
              f"camera rays surviving {(w0 > 0).float().mean().item():.4f}, "
              f"{ms:.2f} ms/pass, image mean {img.mean().item():.6f}, "
              f"{_prof(prof)}, launches {counts} on {card}")

    lap("16")

    # --- phase 17: the CLI on cornell_lens.pbrt, samplers, filters ---
    job = parse_scene(LENS_SCENE, device=device)
    check(job.sampler_kind == "halton" and job.filter_name == "mitchell"
          and job.camera_kind == "realistic", "cornell_lens.pbrt parse")
    (cfilm, _), counts, ms = timed(
        "CLI cornell_lens.pbrt",
        lambda: cli.run_job(job, spp=GATE_SPP, max_depth=DEPTH), GATE_SPP)
    check_image(cfilm.raw, "CLI cornell_lens.pbrt (raw)")
    c_img = filmmod.develop_spectral(cfilm)
    check(bool(torch.isfinite(c_img).all()), "cornell_lens.pbrt: non-finite")
    print(f"phase 17 CLI cornell_lens.pbrt (realistic, halton, mitchell) "
          f"{W}x{H} {GATE_SPP} spp: {ms:.2f} ms/pass, raw mean "
          f"{cfilm.raw.mean().item():.6f}, developed pixels below 0 "
          f"{int((c_img < 0).any(-1).sum())} of {W * H}, launches {counts}"
          f" on {card}")
    means = {}
    for kind in SAMPLERS:
        film, counts, ms = timed(
            f"{kind} render", lambda: render(pcam, GATE_SPP,
                                             kind), GATE_SPP)
        img = filmmod.develop_spectral(film)
        check_image(img, f"{kind} render")
        means[kind] = img.mean().item()
        prof = pass_profile(scene, pcam,
                            SamplerConfig(kind, 0, GATE_SPP))
        print(f"phase 17 sampler {kind} Cornell {W}x{H} {GATE_SPP} spp: "
              f"{ms:.2f} ms/pass, {_prof(prof)}, image mean "
              f"{means[kind]:.6f}, launches {counts}")
    for kind in SAMPLERS:
        gap = abs(means[kind] / means["sobol"] - 1.0)
        print(f"phase 17 sampler {kind}: mean gap to sobol's {gap:.3e} "
              f"(limit {MEAN_GAP})")
        check(gap < MEAN_GAP, f"sampler {kind}: mean off sobol's by {gap}")
    for filt in NEW_FILTERS:
        film, counts, ms = timed(
            f"{filt} render", lambda: render(pcam, GATE_SPP,
                                             filt=filt), GATE_SPP)
        img = filmmod.develop_spectral(film)
        check_image(film.raw, f"{filt} render (raw)")
        check(bool(torch.isfinite(img).all()) and img.mean().item() > 0,
              f"{filt} render: developed image")
        neg = int((img < 0).any(-1).sum())
        if filt == "triangle":
            check(neg == 0, "triangle render: negative pixels")
        gap = abs(img.mean().item() / means["sobol"] - 1.0)
        print(f"phase 17 filter {filt} Cornell {W}x{H} {GATE_SPP} spp: "
              f"{ms:.2f} ms/pass, image mean {img.mean().item():.6f}, gap "
              f"to gaussian's {gap:.3e} (limit {MEAN_GAP}), developed "
              f"pixels below 0 {neg} of {W * H}, launches {counts}")
        check(gap < MEAN_GAP, f"filter {filt}: mean off gaussian's by {gap}")

    lap("17")
    compare_cpu([
        ("realistic", render_32(realistic_camera)),
        ("omni", render_32(lambda dev: omni_camera(dev, ml_json))),
        ("realisticEye", render_32(eye_camera)),
        ("spectralpath CA", render_32(
            lambda dev: realistic_camera(dev, ca=True),
            trace=lambda cam: spectral(cam, 32, 32))),
        ("halton", render_32(None, "halton")),
        ("maxmindist", render_32(None, "maxmindist"))])
    lap("compare_cpu")
    print("phases 14-17 lens cameras, samplers and filters pass; wall s "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))


# phases 22-23: the media scenes and their reference-binary fixtures
VOL_SCENE = os.path.join(ROOT, "scenes", "volpath_bench.pbrt")
VOL_REF = os.path.join(ROOT, "tests", "data", "ref_volpath_blocks.npz")
SMOKE_SCENE = os.path.join(ROOT, "scenes", "smoke_glass.pbrt")
SMOKE_REF = os.path.join(ROOT, "tests", "data", "ref_smoke_glass.npz")
MEDIA_GATE_SPP = 32
WALK_CROSSINGS = 8           # intersect_tr_walk's max_crossings


def volpath_launches(depth, passes):
    """K1 and K2 launches of volpath with MediumInterface media: a
    closest-hit call a bounce and, but for the last, the shadow walk's
    WALK_CROSSINGS calls."""
    n = passes * (depth + 1 + depth * WALK_CROSSINGS)
    return {"dense_queue": n, "dense_queue_cull": 0, "dense_loop": n,
            "dense_loop_motion": 0}


def volpath_gate(film, spp):
    """tests/test_reference_parity.py:55-86's figures of volpath_bench at
    its 128x128: (energy off by, median 16x16-block error, band ratio
    off flat)."""
    d = np.load(VOL_REF)
    ref, k = d["blocks"], int(d["block"])
    ours = film.raw.cpu().numpy() / spp
    bo = ours.reshape(16, k, 16, k, 31).mean((1, 3))
    lum_r, lum_o = ref.sum(-1), bo.sum(-1)
    ratio = bo.reshape(-1, 31).mean(0) / np.maximum(
        ref.reshape(-1, 31).mean(0), 1e-9)
    return (float(abs(lum_o.sum() / lum_r.sum() - 1.0)),
            float(np.median(np.abs(lum_o - lum_r) / lum_r)),
            float(np.abs(ratio / ratio.mean() - 1.0).max()))


def smoke_gate(film):
    """tests/test_media_interface.py:350-392's figures of smoke_glass at
    48x48: (energy off by, median 8x8-block error where the reference
    has signal, share of those blocks within 0.35)."""
    d = np.load(SMOKE_REF)
    ref_lum, res = d["lum"], int(d["res"])
    ours = filmmod.develop_spectral(film).cpu().numpy().sum(-1)
    check(ours.shape == ref_lum.shape == (res, res), "smoke: image shape")

    def blocks(img, bs=8):
        n = img.shape[0] // bs
        return img[:n * bs, :n * bs].reshape(n, bs, n, bs).mean((1, 3))

    br, bo = blocks(ref_lum), blocks(ours)
    sel = br > 0.2 * br.mean()
    rel = np.abs(bo[sel] - br[sel]) / np.maximum(br[sel], 1e-9)
    return (float(abs(bo.mean() / max(br.mean(), 1e-9) - 1.0)),
            float(np.median(rel)), float((rel < 0.35).mean()))


def media_32(scene_path, bound=True):
    """render(dev) of a media scene at 32x32, 2 spp; bound=False drops its
    MediumInterface lines, so that its medium is the scene's one medium
    (volpath's other form: occluded and the medium's own Tr)."""
    def render(dev):
        with open(scene_path) as f:
            text = f.read()
        if not bound:
            text = "\n".join(line for line in text.splitlines()
                             if not line.startswith("MediumInterface"))
        job = PbrtAPI(dev).parse_string(text, os.path.dirname(scene_path))
        check(job.scene.has_prim_media == bound, f"{scene_path}: media")
        job.film_width = job.film_height = 32
        return cli.run_job(job, spp=2)[0]
    return render


def _walk_active(walks, scene):
    """K1's active chunks a tile and the live lanes of walk batches."""
    parts = []
    for c, (r16, tmax, _) in walks.items():
        _, na = dense.tile_chunk_lists(r16, tmax, scene.dense_cb)
        parts.append(f"{c} {na.float().mean().item():.3f} "
                     f"({int((tmax > 0).sum())})")
    return ("K1 active chunks/tile (live lanes) " + ", ".join(parts)
            + f" of {scene.dense_cb.shape[0]} chunks")


def _compare_walks(scene, walks, names, prefix, card, res):
    """compare_kernels on walk batches `names`, into res as prefix+name."""
    wres = compare_kernels(scene, {prefix + c: walks[c] for c in names},
                           card, "dense_loop")
    for k, v in wres.items():
        res[k].update(v)


def phase22(run_path, card, device, res):
    """Participating media through volpath (module docstring)."""
    t0 = time.perf_counter()
    # (a) the homogeneous reference gate, the scene's own 128x128
    job = parse_scene(VOL_SCENE, device=device)
    depth = job.integrator_params["maxdepth"]
    check(job.scene.has_prim_media and not job.scene.has_grid_media
          and job.scene.camera_medium == 0 and job.integrator_kind ==
          "volpath" and depth == 5, "volpath_bench.pbrt settings")
    t1 = time.perf_counter()
    (film, _), counts = run_path(
        "volpath_bench gate",
        lambda: cli.run_job(job, spp=MEDIA_GATE_SPP),
        volpath_launches(depth, MEDIA_GATE_SPP), job.scene)
    dt = time.perf_counter() - t1
    check_image(filmmod.develop_spectral(film), "volpath_bench gate")
    energy, med, flat = volpath_gate(film, MEDIA_GATE_SPP)
    print(f"phase 22a volpath_bench.pbrt {job.film_width}x{job.film_height}"
          f" {MEDIA_GATE_SPP} spp depth {depth} vs ref_volpath_blocks.npz: "
          f"energy off by {energy:.4f} (< 0.03), median block error "
          f"{med:.4f} (< 0.10), band ratio flat within {flat:.4f} (< 0.02);"
          f" {dt:.2f} s, {dt * 1e3 / MEDIA_GATE_SPP:.2f} ms/pass, launches "
          f"{counts} on {card}")
    check(energy < 0.03, f"volpath gate: energy off by {energy}")
    check(med < 0.10, f"volpath gate: median block error {med}")
    check(flat < 0.02, f"volpath gate: band ratio off by {flat}")
    # (b) the grid reference gate, 48x48
    sjob = parse_scene(SMOKE_SCENE, device=device)
    sdepth = sjob.integrator_params["maxdepth"]
    check(sjob.scene.has_grid_media and sjob.scene.camera_medium == -1
          and sdepth == 6, "smoke_glass.pbrt settings")
    t1 = time.perf_counter()
    (sfilm, _), counts = run_path(
        "smoke_glass gate", lambda: cli.run_job(sjob, spp=MEDIA_GATE_SPP),
        volpath_launches(sdepth, MEDIA_GATE_SPP), sjob.scene)
    dt = time.perf_counter() - t1
    check_image(filmmod.develop_spectral(sfilm), "smoke_glass gate")
    energy, med, share = smoke_gate(sfilm)
    print(f"phase 22b smoke_glass.pbrt {sjob.film_width}x"
          f"{sjob.film_height} {MEDIA_GATE_SPP} spp depth {sdepth} vs "
          f"ref_smoke_glass.npz: energy off by {energy:.4f} (< 0.10), "
          f"median block error {med:.4f} (< 0.15), blocks within 0.35 "
          f"{share:.4f} (> 0.85); {dt:.2f} s, "
          f"{dt * 1e3 / MEDIA_GATE_SPP:.2f} ms/pass, launches {counts} on "
          f"{card}")
    check(energy < 0.10, f"smoke gate: energy off by {energy}")
    check(med < 0.15, f"smoke gate: median block error {med}")
    check(share > 0.85, f"smoke gate: only {share} of blocks within 0.35")
    t_gates = time.perf_counter() - t0

    # (c) full width: 256x256, 4 spp, 65,536 rays a pass
    t0 = time.perf_counter()
    cfg = SamplerConfig("sobol", 0, SPP)
    for name, j, d in (("volpath_bench", job, depth),
                       ("smoke_glass", sjob, sdepth)):
        j.film_width = j.film_height = W
        cam = cli.build_camera(j, W, H, device)
        cli.run_job(j, spp=1, max_rays_per_pass=RAYS_PER_PASS)
        torch.cuda.synchronize()
        passes = SPP * (-(-W * H // RAYS_PER_PASS))
        t1 = time.perf_counter()
        (f, _), counts = run_path(
            f"{name} full width",
            lambda: cli.run_job(j, spp=SPP, max_rays_per_pass=RAYS_PER_PASS),
            volpath_launches(d, passes), j.scene)
        ms = (time.perf_counter() - t1) * 1e3 / passes
        img = filmmod.develop_spectral(f)
        check_image(img, f"{name} full width")
        prof = pass_profile(j.scene, cam, cfg,
                            trace=volpath.make_trace_volpath(j), depth=d)
        idle = ("not measured" if prof is None
                else f"{1 - prof[0] / ms:.3f}")
        extra = ""
        if name == "smoke_glass":
            walks = kw.volpath_walk_batches(j, cam, cfg, W, H,
                                            RAYS_PER_PASS, d)
            extra = "; bounce-1 walk " + _walk_active(walks, j.scene)
            # (e) K1 and K2 against their plain versions on the walk's
            # first two crossings
            _compare_walks(j.scene, walks, ("walk1", "walk2"), "volpath_",
                           card, res)
        else:
            # (e) and on volpath_bench's first crossing, whose lanes hit
            # the fog box's triangles
            _compare_walks(j.scene, kw.volpath_walk_batches(
                j, cam, cfg, W, H, RAYS_PER_PASS, d, crossings=(1,)),
                ("walk1",), "volpath_bench_", card, res)
        print(f"phase 22c {name} {W}x{H} {SPP} spp depth {d}: {ms:.2f} "
              f"ms/pass, image mean {img.mean().item():.6f}, {_prof(prof)}"
              f", idle share {idle}, K1 / K2 {counts['dense_queue'] // passes}"
              f" / {counts['dense_loop'] // passes} a pass{extra} on {card}")
    # (e) and on the walk of kernel_workloads.shells_scene, whose lanes
    # cross a box's triangles at every one of the 8 steps
    shells = PbrtAPI(device).parse_string(kw.shells_scene(W))
    cam = cli.build_camera(shells, W, H, device)
    walks = kw.volpath_walk_batches(shells, cam, cfg, W, H, RAYS_PER_PASS, 1,
                                    crossings=range(1, WALK_CROSSINGS + 1),
                                    bounce=0)
    live = [int((tmax > 0).sum()) for _, tmax, _ in walks.values()]
    check(min(live) > RAYS_PER_PASS // 4 and len(set(live)) == 1,
          f"shells: live walk lanes {live}")
    print(f"phase 22e shells {W}x{H}: bounce-0 walk "
          + _walk_active(walks, shells.scene))
    _compare_walks(shells.scene, walks, ("walk2", "walk5", "walk8"),
                   "volpath_shells_", card, res)
    t_full = time.perf_counter() - t0
    # (d) the card against the CPU
    t0 = time.perf_counter()
    compare_cpu([("volpath_bench", media_32(VOL_SCENE)),
                 ("smoke_glass", media_32(SMOKE_SCENE)),
                 ("volpath_bench, the scene's medium",
                  media_32(VOL_SCENE, bound=False)),
                 ("smoke_glass, the scene's medium",
                  media_32(SMOKE_SCENE, bound=False))])
    print(f"phase 22 media pass; wall s gates {t_gates:.1f}, full width "
          f"{t_full:.1f}, GPU vs CPU {time.perf_counter() - t0:.1f}")


# phase 23: the other single-pass integrators on cornell_bench.pbrt, the
# integrator overridden: (name, integrator parameters, K1 / K2 calls a
# pass at depth 5)
OTHER_INTEGRATORS = (
    ("whitted", {}, 2 * DEPTH + 1),
    ("ambientocclusion", {}, 2),
    ("directlighting", {"strategy": "all"}, 2))


def _bench_as(kind, params, dev, res=None):
    job = parse_scene(BENCH_SCENE, device=dev)
    job.integrator_kind = kind
    job.integrator_params.update(params)
    if res is not None:
        job.film_width = job.film_height = res
    return job


def phase23(run_path, card, device):
    """whitted, ambient occlusion and directlighting (module docstring)."""
    t0 = time.perf_counter()
    for kind, params, calls in OTHER_INTEGRATORS:
        job = _bench_as(kind, params, device, W)
        cli.run_job(job, spp=1)
        torch.cuda.synchronize()
        passes = GATE_SPP * (-(-W * H // (1 << 18)))
        t1 = time.perf_counter()
        (film, _), counts = run_path(
            kind, lambda: cli.run_job(job, spp=GATE_SPP),
            {"dense_queue": calls * passes, "dense_queue_cull": 0,
             "dense_loop": calls * passes, "dense_loop_motion": 0},
            job.scene)
        ms = (time.perf_counter() - t1) * 1e3 / passes
        img = filmmod.develop_spectral(film)
        check_image(img, kind)
        cam = cli.build_camera(job, W, H, device)
        trace, tkw, depth = dispatch.integrator_trace(
            job, cam, W, H, job.integrator_params["maxdepth"])
        prof = pass_profile(job.scene, cam, SamplerConfig("sobol", 0, SPP),
                            trace=functools.partial(
                                trace or path.trace_paths, **tkw),
                            depth=depth)
        print(f"phase 23 {kind} {params} cornell_bench.pbrt {W}x{H} "
              f"{GATE_SPP} spp: {ms:.2f} ms/pass, image mean "
              f"{img.mean().item():.6f}, {_prof(prof)}, launches {counts} "
              f"on {card}")
    compare_cpu([(kind, lambda dev, k=kind, p=params: cli.run_job(
        _bench_as(k, p, dev, 32), spp=2)[0])
        for kind, params, _ in OTHER_INTEGRATORS])
    print(f"phase 23 whitted, ao, directlighting pass; wall s "
          f"{time.perf_counter() - t0:.1f}")


# phase 24: the shapes cell, written into the gitignored output
# directory, and its CLI checks' size (e)
SHAPES_DIR = os.path.join(ROOT, "chiprun_out", "shapes_scene")
SHAPES_CLI_RES = 64
SHAPES_INSTANCES = 6


def shapes_32(dev):
    job = parse_scene(os.path.join(SHAPES_DIR, "shapes.pbrt"), device=dev)
    job.film_width = job.film_height = 32
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def _shapes_cli(run_path, sc, tag, edit, spp, calls, d):
    """The CLI on a copy of the cell's file (scene sc) at SHAPES_CLI_RES,
    the text edited by `edit`; counted as phase 5 is (`calls` K1 / K2
    calls a pass).  Returns the .dat's raw sums [H,W,31]."""
    src = open(os.path.join(d, "shapes.pbrt")).read().replace(
        f"[{W}]", f"[{SHAPES_CLI_RES}]")
    scene = os.path.join(d, f"shapes_{tag}.pbrt")
    with open(scene, "w") as f:
        f.write(edit(src))
    out = os.path.join(d, f"shapes_{tag}.exr")
    passes = spp * (-(-SHAPES_CLI_RES ** 2 // (1 << 18)))
    expect = {"dense_queue": calls * passes, "dense_queue_cull": 0,
              "dense_loop": calls * passes, "dense_loop_motion": 0}
    code, _ = run_path(f"shapes CLI {tag}", lambda: cli.main(
        [scene, "--quiet", "--spp", str(spp), "-o", out]), expect, sc)
    check(code == 0, f"shapes CLI {tag}: exit code {code}")
    return filmio.read_dat(os.path.join(d, f"shapes_{tag}.dat"))[0]


def phase24(run_path, card, device, res):
    """The shapes cell (module docstring)."""
    t0 = time.perf_counter()
    scene_path = shapes_scene.write_shapes_scene(SHAPES_DIR)
    t_write = time.perf_counter() - t0
    t1 = time.perf_counter()
    job = parse_scene(scene_path, device=device)
    torch.cuda.synchronize()
    t_parse = time.perf_counter() - t1
    sc = job.scene
    n_tri = int((sc.prim_type == 0).sum())
    C, chunk = sc.dense_w.shape[0], sc.dense_chunk
    blobs = [i for i, n in job.instance_names.items() if n == "blob"]
    check(sc.n_quadrics == 5 and sc.clip_quadrics and len(blobs) ==
          SHAPES_INSTANCES and chunk == 512 and C > dense.QUEUE_RANK_MAX,
          f"shapes cell: {sc.n_quadrics} quadrics, {len(blobs)} "
          f"instances, chunk {chunk}, C {C}")
    print(f"phase 24a shapes cell {scene_path}: {n_tri} triangles, "
          f"{sc.n_quadrics} quadrics, {len(blobs)} instances, C={C} chunks "
          f"of {chunk}, dense table {nbytes(sc.dense_w) / 2**20:.2f} MiB "
          f"(boxes {nbytes(sc.dense_cb) / 2**10:.1f} KiB), written in "
          f"{t_write:.2f} s, parsed + built in {t_parse:.2f} s on {card}")

    # (b) K1 and K2 on the cell's batches
    t0 = time.perf_counter()
    cam = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, SPP)
    strategy = dispatch.light_strategy(job.integrator_params)
    batches = kw.main_path_batches(sc, cam, cfg, W, H, RAYS_PER_PASS, DEPTH,
                                   light_strategy=strategy)
    batches["bitonic"] = kw.bitonic_batch(sc, RAYS_PER_PASS)
    bitonic = {}
    for name, (r16, tmax, _) in batches.items():
        _, na = dense.tile_chunk_lists(r16, tmax, sc.dense_cb)
        bitonic[name] = (int((na > dense.QUEUE_RANK_MAX).sum()),
                         na.shape[0], int(na.max()))
    print("phase 24b tiles whose hit chunks K1 sorts bitonically (A > "
          f"{dense.QUEUE_RANK_MAX}), of all tiles, largest A: " + ", ".join(
              f"{k} {v[0]} of {v[1]} ({v[2]})" for k, v in bitonic.items()))
    check(bitonic["bitonic"][0] > 0, "no tile took K1's bitonic branch")
    sres = compare_kernels(sc, {f"shapes_{k}": v for k, v in batches.items()},
                           card, "dense_loop", seams=True,
                           skips=SHAPES_SKIPS, t_share=SHAPES_T_SHARE)
    for k, v in sres.items():
        res[k].update(v)
    t_kernels = time.perf_counter() - t0

    # (c) the full-size render through the CLI's run_job
    t0 = time.perf_counter()
    passes = SPP * (-(-W * H // RAYS_PER_PASS))
    cli.run_job(job, spp=1, max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = Stats()
    t1 = time.perf_counter()
    (film, _), counts = run_path(
        "shapes render",
        lambda: cli.run_job(job, spp=SPP, max_rays_per_pass=RAYS_PER_PASS,
                            stats=stats),
        {"dense_queue": (DEPTH + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * passes, "dense_loop_motion": 0}, sc)
    dt = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    ms = dt * 1e3 / passes
    img = filmmod.develop_spectral(film)
    check_image(img, "shapes render")
    prof = pass_profile(sc, cam, cfg, trace=functools.partial(
        path.trace_paths, light_strategy=strategy))
    idle = "not measured" if prof is None else f"{1 - prof[0] / ms:.3f}"
    print(f"phase 24c shapes render {W}x{H} {SPP} spp depth {DEPTH}: "
          f"{passes} passes, {ms:.2f} ms/pass, {stat_rays(stats)} rays, "
          f"{stat_rays(stats) / dt:.4e} rays/s, image mean "
          f"{img.mean().item():.6f}, {_prof(prof)}, idle share {idle}, "
          f"peak device memory {peak / 2**20:.1f} MiB above the scene's "
          f"{base / 2**20:.1f} MiB, launches {counts} on {card}")
    t_render = time.perf_counter() - t0

    # (d) the card against the CPU
    t0 = time.perf_counter()
    compare_cpu([("shapes", shapes_32)])
    t_cpu = time.perf_counter() - t0

    # (e) the CLI: a crop window, a luminance clamp, the metadata ids
    t0 = time.perf_counter()
    d = SHAPES_DIR
    full = _shapes_cli(run_path, sc, "full", lambda t: t, GATE_SPP,
                       DEPTH + 1, d)
    crop = _shapes_cli(run_path, sc, "crop", lambda t: t.replace(
        'Film "image"', 'Film "image" "float cropwindow" [0.2 0.75 0.1 0.6]'),
        GATE_SPP, DEPTH + 1, d)
    n = SHAPES_CLI_RES
    inside = np.zeros((n, n), bool)
    inside[int(np.ceil(0.1 * n)):int(np.ceil(0.6 * n)),
           int(np.ceil(0.2 * n)):int(np.ceil(0.75 * n))] = True
    lf, lc = full.sum(-1), crop.sum(-1)
    out_zero = bool((lc[~inside] == 0).all())
    mean_rel = abs(lc[inside].mean() / lf[inside].mean() - 1.0)
    close = (np.abs(lc - lf) <= 1e-2 * np.abs(lf))[inside].mean()
    print(f"phase 24e CLI cropwindow [0.2 0.75 0.1 0.6] at {n}x{n}: "
          f"{int(inside.sum())} pixels rendered, outside all 0 {out_zero}, "
          f"inside mean vs the full render's rel {mean_rel:.3e}, pixels "
          f"within 1e-2 {close:.4f}")
    check(out_zero, "cropwindow: a pixel outside the crop is not 0")
    check(mean_rel < 0.01 and close >= 0.95, "cropwindow: the crop's "
          "pixels differ from the full render's")
    cap = 0.5
    clamp = _shapes_cli(run_path, sc, "clamp", lambda t: t.replace(
        'Film "image"', f'Film "image" "float maxsampleluminance" [{cap}]'),
        GATE_SPP, DEPTH + 1, d)
    yf, yc = (_luminance(x) for x in (full, clamp))
    print(f"phase 24e CLI maxsampleluminance {cap}: brightest pixel "
          f"{yc.max():.4f} (limit {GATE_SPP} spp x {cap}), full render's "
          f"{yf.max():.4f}; pixels darkened {(yc < yf * 0.999).mean():.4f}")
    check(yc.max() <= GATE_SPP * cap * (1 + 1e-4), "maxsampleluminance: a "
          "pixel above the clamp")
    check(bool((yc < yf * 0.999).any()), "maxsampleluminance: nothing "
          "clamped")
    meta = _shapes_cli(run_path, sc, "mesh", lambda t: t.replace(
        'Integrator "path" "integer maxdepth" [5]',
        'Integrator "metadata" "string strategy" "mesh"'), 1, 1, d)
    ids = set(np.rint(meta[..., 0]).astype(int).ravel().tolist())
    walls = {2, 3, 4, 5}
    print(f"phase 24e CLI metadata mesh ids: {sorted(ids)}; blob instances "
          f"{blobs}")
    check(set(blobs) <= ids and walls <= ids, "metadata: an instance or a "
          "wall has no id of its own in the image")
    print(f"phase 24 shapes pass; wall s write + parse {t_write + t_parse:.1f}"
          f", kernels {t_kernels:.1f}, render {t_render:.1f}, GPU vs CPU "
          f"{t_cpu:.1f}, CLI {time.perf_counter() - t0:.1f}")
    return sc, cam, cfg, strategy


# phase 25: the walk routes' cells (PERF.md section 4), written into the
# gitignored output directory: (tools/shapes_scene.py arguments, the
# route, resolution, spp, the walk kernel)
WALK_DIR = os.path.join(ROOT, "chiprun_out", "walk_cells")
WALK_CELLS = kw.WALK_CELLS
# the walk kernels' rows of the kernels line: (row, cell, batch)
WALK_ROWS = kw.WALK_ROWS
WALK_SOURCE = "pbrt_tpu_torch/csrc/accel_walk.cu"
# the XLA loops each walk replaces (no pl.pallas_call)
WALK_REPLACES = {"bvh_walk": "pbrt_tpu/ops/intersect.py:591",
                 "bvh_walk_motion": "pbrt_tpu/ops/intersect.py:591",
                 "kd_walk": "pbrt_tpu/ops/intersect.py:656",
                 "kd_walk_motion": "pbrt_tpu/ops/intersect.py:656"}
# the shapes cell's passes measured in (d)
WALK_PASSES = 3


def compare_walk(sc, name, args, card):
    """A walk kernel against its plain version on one recorded batch:
    (t, prim) equal bit for bit on every lane, or prim of another
    triangle at a tie; timed, and bounded by the plain version's counts
    (kernel_workloads.walk_bound).  Returns the record."""
    kd = sc.use_kd
    run_k = functools.partial(
        accel_walk.kd_walk if kd else accel_walk.bvh_walk, **args)
    run_p = functools.partial(
        accel_walk.kd_walk_plain if kd else accel_walk.bvh_walk_plain, **args)
    t_k, p_k = run_k()
    t_p, p_p, counts = run_p(counts=True)
    same = (p_k == p_p) & (t_k.view(torch.int32) == t_p.view(torch.int32))
    lanes = torch.nonzero(~same)[:, 0]
    tie = kw.walk_ties(sc, args["o"], args["d"], args.get("time"), lanes,
                       p_k, p_p)
    anyhit = args.get("anyhit")
    n_any = 0 if anyhit is None else int(anyhit.sum())
    found = (p_k >= 0).float().mean().item()
    both = (p_k == p_p) & (p_k >= 0)
    rec = dict(
        max_abs_err=((t_k - t_p)[both].abs().max().item()
                     if bool(both.any()) else 0.0),
        ms=kw.time_ms(run_k, 20, sc.device), device=kw.device_ms(run_k),
        # (the counts call above warmed the plain version)
        plain_ms=kw.time_ms(run_p, 1, sc.device, warmup=False),
        bound=kw.walk_bound(args, counts, kd),
        visits_mean=counts.visits.float().mean().item(),
        visits_max=int(counts.visits.max()),
        tests_mean=counts.tests.float().mean().item(),
        nodes=counts.nodes, tris=counts.tris, B=int(p_k.shape[0]))
    # the batch's 1% of lanes with the most node visits alone, and the
    # other 99%: does the longest chain set the time?
    B = rec["B"]
    top = torch.topk(counts.visits, max(1, B // 100)).indices
    rest = torch.ones(B, dtype=torch.bool, device=sc.device)
    rest[top] = False
    # lanes of the whole batch that differed at a tie
    tied = torch.zeros(B, dtype=torch.bool, device=sc.device)
    tied[lanes] = tie
    for part, idx in (("top1", top), ("rest", torch.nonzero(rest)[:, 0])):
        sub = {k: (v[idx].contiguous() if k in kw.WALK_RAY_ARGS
                   and v is not None else v) for k, v in args.items()}
        run_s = functools.partial(run_k.func, **sub)
        t_s, p_s = run_s()
        same_s = (p_s == p_p[idx]) & (t_s.view(torch.int32)
                                      == t_p[idx].view(torch.int32))
        check(bool((same_s | tied[idx]).all()), f"walk {name} {part}: "
              "lanes differ from the plain version without a tie")
        rec[f"device_{part}"] = kw.device_ms(run_s)
    dev = rec["device"]
    rec["us_a_step"] = (None if dev is None
                        else dev[0] * 1e3 / rec["visits_max"])
    step = ("not measured" if rec["us_a_step"] is None
            else f"{rec['us_a_step']:.4f}")
    print(f"phase 25b {name}: B={rec['B']} any-hit lanes={n_any} found="
          f"{found:.4f}; lanes not bit for bit equal to the plain version "
          f"{len(lanes)}, of them ties {int(tie.sum())}; node visits a lane "
          f"mean {rec['visits_mean']:.1f} max {rec['visits_max']}, triangle "
          f"tests a lane {rec['tests_mean']:.1f}, distinct nodes "
          f"{counts.nodes} and triangles {counts.tris} read; kernel "
          f"{_dev(rec)} ms device, {rec['ms']:.4f} ms events, plain "
          f"{rec['plain_ms']:.2f} ms, bound {rec['bound'][0]:.5f} ms "
          f"({rec['bound'][1]}); the 1% longest lanes alone "
          f"{_dev({'device': rec['device_top1']})} ms device, the other "
          f"99% {_dev({'device': rec['device_rest']})}; {step} us a step of "
          f"the longest chain on {card}")
    check(bool(tie.all()), f"walk {name}: {int((~tie).sum())} lanes differ "
          "from the plain version without a tie")
    check(found > 0.05, f"walk {name}: found share {found}")
    return rec


def _leaf_position(sc):
    """[P] each primitive's position in its BVH leaf (leaf order)."""
    bits = sc.bvh_packed[:, 6].contiguous().view(torch.int32)
    leaf = bits >= 0
    off, cnt = (bits[leaf] >> 5).long(), (bits[leaf] & 31).long()
    pos = torch.zeros(sc.prim_type.shape[0], dtype=torch.long,
                      device=sc.device)
    for k in range(int(cnt.max())):
        m = cnt > k
        pos[off[m] + k] = k
    return pos


def kd_against_bvh(sc, name, args):
    """(c): kd_walk against bvh_walk on one batch of a kd cell (which
    holds both trees): closest-hit lanes of another prim must be ties or
    large-leaf lanes, ROADMAP Queue 3 (v) (the kd prim sits past max_leaf
    in its BVH leaf, and the BVH found nothing nearer); any-hit lanes
    compare found only, the same way.  Each such lane is named."""
    t_kd, p_kd = accel_walk.kd_walk(**args)
    bargs = {k: v for k, v in args.items()
             if k in kw.WALK_RAY_ARGS + ("tri_packed", "tri_motion")
             and k != "tmax"}
    t_b, p_b = accel_walk.bvh_walk(packed=sc.bvh_packed, links=sc.bvh_links,
                                   max_leaf=sc.max_leaf, **bargs)
    anyhit = args.get("anyhit")
    anyhit = (torch.zeros_like(p_kd, dtype=torch.bool) if anyhit is None
              else anyhit)
    differ = torch.where(anyhit, (p_kd >= 0) != (p_b >= 0), p_kd != p_b)
    lanes = torch.nonzero(differ)[:, 0]
    tie = kw.walk_ties(sc, args["o"], args["d"], args.get("time"), lanes,
                       p_kd, p_b) & ~anyhit[lanes]
    pos = _leaf_position(sc)
    skipped = ((p_kd[lanes] >= 0)
               & (pos[p_kd[lanes].clamp(min=0).long()] >= sc.max_leaf)
               & ((p_b[lanes] < 0) | (t_kd[lanes] < t_b[lanes])))
    for i, lane in enumerate(lanes.tolist()):
        why = ("a tie" if tie[i] else "Queue 3 (v): the BVH leaf's "
               f"position {int(pos[p_kd[lane].clamp(min=0)])} is past "
               "max_leaf" if skipped[i] else "NOT EXPLAINED")
        print(f"phase 25c {name} lane {lane}: kd prim {int(p_kd[lane])} t "
              f"{t_kd[lane].item():.8g}, BVH prim {int(p_b[lane])} t "
              f"{t_b[lane].item():.8g}{' (any-hit)' if anyhit[lane] else ''}"
              f": {why}")
    print(f"phase 25c {name}: kd against BVH on {len(p_kd)} lanes: "
          f"{len(lanes)} differ, ties {int(tie.sum())}, Queue 3 (v) "
          f"{int((skipped & ~tie).sum())}")
    check(bool((tie | skipped).all()), f"kd against BVH {name}: a lane "
          "differs without a tie or a Queue 3 (v) leaf")


def dense_crack_crosscheck(sc, cam, cfg, strategy):
    """The dense route's crack (ROADMAP Queue 3): phase 24's shapes cell,
    its camera and bounce-1 intersect calls through K1 / K2 and through
    bvh_walk (the same SceneData with use_dense false).  Prints the lanes
    the two answer differently, each with its position in K2's sorted
    batch and why: a tie, the walk nearer (K2 passed the walk's
    triangle: a crack or a graze of the dense table), or K2 nearer."""
    calls = []
    inner = isect.intersect

    def record(scene, ray, presorted=False, anyhit_mask=None):
        calls.append((ray, presorted, anyhit_mask))
        return inner(scene, ray, presorted=presorted,
                     anyhit_mask=anyhit_mask)

    def run():
        ids = torch.arange(RAYS_PER_PASS, device=sc.device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            cam, W, H, cfg, ids, 0)
        path.trace_paths(sc, ray, pid, sidx, cfg, max_depth=1,
                         light_strategy=strategy)

    isect.intersect = record
    try:
        run()
    finally:
        isect.intersect = inner
    walk_sc = dataclasses.replace(sc, use_dense=False)
    for name, (ray, presorted, amask) in zip(("camera", "bounce1"), calls):
        t_d, p_d, f_d = inner(sc, ray, presorted=presorted,
                              anyhit_mask=amask)
        t_w, p_w, f_w = inner(walk_sc, ray, anyhit_mask=amask)
        given = amask
        amask = (torch.zeros_like(f_d) if amask is None else amask)
        differ = torch.where(amask, f_d != f_w, p_d != p_w)
        lanes = torch.nonzero(differ)[:, 0]
        # each lane's position in K2's coherence-sorted batch
        t_init, _ = isect._quadric_prehit(sc, ray)
        order = (torch.arange(len(t_init), device=sc.device) if presorted
                 else isect._coherence_order(sc, ray.o, ray.d, t_init,
                                             given))
        pos = torch.empty_like(order)
        pos[order] = torch.arange(len(order), device=sc.device)
        tie = kw.walk_ties(sc, ray.o, ray.d, None, lanes, p_d,
                           p_w) & ~amask[lanes]
        kinds = {"tie": 0, "walk nearer": 0, "K2 nearer": 0, "any-hit": 0}
        for i, lane in enumerate(lanes.tolist()):
            if amask[lane]:
                why = "any-hit"
            elif tie[i]:
                why = "tie"
            elif not f_d[lane] or (f_w[lane] and t_w[lane] < t_d[lane]):
                why = "walk nearer"
            else:
                why = "K2 nearer"
            kinds[why] += 1
            print(f"phase 25 crack cross-check {name} lane {lane} (K2's "
                  f"sorted lane {int(pos[lane])}): K2 prim {int(p_d[lane])} "
                  f"t {t_d[lane].item():.8g}, BVH walk prim "
                  f"{int(p_w[lane])} t {t_w[lane].item():.8g}: {why}")
        # the whole intersect call by each route on this batch
        calls_ms = {}
        for route, scene in (("dense", sc), ("BVH walk", walk_sc)):
            def call():
                return inner(scene, ray, presorted=presorted,
                             anyhit_mask=amask)
            calls_ms[route] = (kw.time_ms(call, 10, sc.device),
                               kw.device_ms(call))
        print(f"phase 25 crack cross-check {name}: {len(lanes)} of "
              f"{len(f_d)} lanes differ between K2 and the BVH walk: "
              + ", ".join(f"{k} {v}" for k, v in kinds.items())
              + "; one intersect call " + ", ".join(
                  f"{r} {m:.4f} ms events, " + (
                      "device not measured" if d is None else
                      f"{d[0]:.4f} ms device in {d[1]:.0f} kernels")
                  for r, (m, d) in calls_ms.items()))


def phase25(run_walk, card, device, res, shapes=None):
    """The walk routes (module docstring): (a) the cells, (b) each walk
    against its plain version, (c) kd against BVH, (d) the renders, (e)
    the card against the CPU; shapes: phase 24's (scene, camera, cfg,
    strategy) for the dense route's crack cross-check."""
    jobs, batches = {}, {}
    t_setup = time.perf_counter()
    for cell, (opts, route, r, spp, kern) in WALK_CELLS.items():
        t0 = time.perf_counter()
        scene_path = shapes_scene.write_shapes_scene(
            os.path.join(WALK_DIR, cell), res=r, spp=spp, **opts)
        t_write = time.perf_counter() - t0
        t1 = time.perf_counter()
        job = parse_scene(scene_path, device=device)
        torch.cuda.synchronize()
        t_parse = time.perf_counter() - t1
        sc = job.scene
        n_tri = int((sc.prim_type == 0).sum())
        walk_mib = nbytes(sc.bvh_packed, sc.bvh_links,
                          sc.tri_packed) / 2**20
        if sc.has_animated_mesh:
            walk_mib += nbytes(sc.tri_motion) / 2**20
        kd_txt = "no kd-tree"
        if sc.use_kd:
            walk_mib += nbytes(sc.kd_packed, sc.kd_prim_idx) / 2**20
            M, P = sc.kd_prim_idx.shape[0], sc.prim_type.shape[0]
            kd_txt = (f"kd nodes {sc.kd_packed.shape[0]}, kd list entries "
                      f"{M} ({M / P:.3f} a primitive, {M - P} duplicated), "
                      f"largest leaf {sc.kd_max_leaf}")
        all_mib = nbytes(*(v for v in vars(sc).values()
                           if torch.is_tensor(v))) / 2**20
        print(f"phase 25a {cell} {scene_path}: {n_tri} triangles, "
              f"{sc.n_quadrics} quadrics, route {cli.route_name(sc)}, BVH "
              f"nodes {sc.n_nodes} ({sc.n_nodes / sc.prim_type.shape[0]:.3f}"
              f" a primitive), {kd_txt}; walk tables {walk_mib:.2f} MiB, all "
              f"scene tensors {all_mib:.2f} MiB; written in {t_write:.2f} s, "
              f"parsed + built in {t_parse:.2f} s on {card}")
        check(cli.route_name(sc) == route and sc.dense_w is None
              and not sc.use_dense and sc.n_quadrics == 5,
              f"{cell}: route {cli.route_name(sc)}, dense table "
              f"{sc.dense_w is not None}")
        check(sc.has_animated_mesh == kern.endswith("_motion"),
              f"{cell}: animated mesh {sc.has_animated_mesh}")
        jobs[cell] = job
        cam = cli.build_camera(job, r, r, device)
        strategy = dispatch.light_strategy(job.integrator_params)
        batches[cell] = kw.accel_batches(
            sc, cam, SamplerConfig("sobol", 0, spp), r, r,
            min(r * r, RAYS_PER_PASS), DEPTH, light_strategy=strategy)
    print(f"phase 25a cells written, parsed and their batches recorded in "
          f"{time.perf_counter() - t_setup:.1f} s")

    # (b) each walk kernel against its plain version
    t0 = time.perf_counter()
    for row, cell, batch in WALK_ROWS:
        res[row] = compare_walk(jobs[cell].scene, row, batches[cell][batch],
                                card)
    for fn_name, v in sorted(cuda_kernels.ptxas_report().items()):
        if "walk" in fn_name:
            print(f"phase 25b ptxas {fn_name}: {v}")
    t_kernels = time.perf_counter() - t0

    # (c) kd against BVH on the kd cells
    for cell, batch in (("shapes_kd", "camera"), ("shapes_kd", "bounce1"),
                        ("shapes_kd_motion", "bounce1")):
        kd_against_bvh(jobs[cell].scene, f"{cell}_{batch}",
                       batches[cell][batch])

    # (d) the renders: shapes_1m over WALK_PASSES passes and one profiled;
    # the other cells one pass each
    t0 = time.perf_counter()
    job = jobs["shapes_1m"]
    sc = job.scene
    cli.run_job(job, spp=1, max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = Stats()
    t1 = time.perf_counter()
    (film, _), counts = run_walk(
        "shapes_1m render", lambda: cli.run_job(
            job, spp=WALK_PASSES, max_rays_per_pass=RAYS_PER_PASS,
            stats=stats), {"bvh_walk": (DEPTH + 1) * WALK_PASSES})
    dt = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    ms = dt * 1e3 / WALK_PASSES
    img = filmmod.develop_spectral(film)
    check_image(img, "shapes_1m render")
    cam = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, 4)
    prof = pass_profile(sc, cam, cfg, trace=functools.partial(
        path.trace_paths,
        light_strategy=dispatch.light_strategy(job.integrator_params)))
    idle = "not measured" if prof is None else f"{1 - prof[0] / ms:.3f}"
    print(f"phase 25d shapes_1m render {W}x{H} {WALK_PASSES} passes depth "
          f"{DEPTH}: {ms:.2f} ms/pass, {stat_rays(stats)} rays, "
          f"{stat_rays(stats) / dt:.4e} rays/s, image mean "
          f"{img.mean().item():.6f}, {_prof(prof)}, idle share {idle}, peak "
          f"device memory {peak / 2**20:.1f} MiB above the scene's "
          f"{base / 2**20:.1f} MiB, launches {counts} on {card}")
    for cell in ("shapes_motion", "shapes_kd", "shapes_kd_motion"):
        j = jobs[cell]
        kern = WALK_CELLS[cell][4]
        t1 = time.perf_counter()
        (f, _), counts = run_walk(
            f"{cell} render", lambda: cli.run_job(
                j, spp=1, max_rays_per_pass=RAYS_PER_PASS),
            {kern: DEPTH + 1})
        dt = time.perf_counter() - t1
        im = filmmod.develop_spectral(f)
        check_image(im, f"{cell} render")
        print(f"phase 25d {cell} render {j.film_width}x{j.film_height} one "
              f"pass depth {DEPTH}: {dt * 1e3:.2f} ms, image mean "
              f"{im.mean().item():.6f}, launches {counts} on {card}")
    t_render = time.perf_counter() - t0

    # (e) the card against the CPU on shapes_1m at 32x32
    t0 = time.perf_counter()

    def shapes_1m_32(dev):
        j = (dataclasses.replace(job) if dev == "cuda" else parse_scene(
            os.path.join(WALK_DIR, "shapes_1m", "shapes.pbrt"), device=dev))
        j.film_width = j.film_height = 32
        return cli.run_job(j, spp=2, max_depth=DEPTH)[0]

    compare_cpu([("shapes_1m", shapes_1m_32)])
    t_cpu = time.perf_counter() - t0

    if shapes is not None:
        dense_crack_crosscheck(*shapes)
    print(f"phase 25 walks pass; wall s kernels {t_kernels:.1f}, render "
          f"{t_render:.1f}, GPU vs CPU {t_cpu:.1f}")


# phase 26: the rest of the materials (PERF.md section 4): the skin scene,
# written into the gitignored output directory, and the probe batches
# whose kernels are held to their plain versions (b)
SKIN_DIR = os.path.join(ROOT, "chiprun_out", "skin_scene")
# closest-hit probe lanes of a batch whose triangle may differ from the
# plain version's without a tie, each explained by dense.loop_prim_skipped
# (a crack between the two faces of a fiber's or a block's edge)
SKIN_SKIPS = 2
# tests/test_bssrdf.py's scenes, larger: (d)
SSS_SPHERE = """
Integrator "path" "integer maxdepth" [5]
Sampler "sobol" "integer pixelsamples" [8]
Film "image" "integer xresolution" [64] "integer yresolution" [64]
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
  Translate 0 4 4
  LightSource "point" "color I" [60 60 60]
AttributeEnd
Material "subsurface" "color sigma_a" [{a} {a} {a}]
         "color sigma_s" [{s} {s} {s}] "float eta" [1.33]
Shape "sphere" "float radius" [1]
WorldEnd
"""
SSS_SLAB = """
Integrator "{kind}" "integer maxdepth" [6]
Sampler "sobol" "integer pixelsamples" [16]
Film "image" "integer xresolution" [64] "integer yresolution" [64]
LookAt 0 3 0  0 0 0  0 0 1
Camera "perspective" "float fov" [35]
WorldBegin
AttributeBegin
  Translate 0 8 0
  LightSource "point" "color I" [100 100 100]
AttributeEnd
Material "subsurface" "color sigma_a" [0.05 0.05 0.05]
         "color sigma_s" [12 12 12] "float eta" [1.33]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-20 0 -20  -20 0 20  20 0 20  20 0 -20]
WorldEnd
"""


def _slab_stack(res=64, spp=2):
    """tests/test_bssrdf.py::_render_slabs's three stacked slabs."""
    slabs = "\n".join(
        f'AttributeBegin\nTranslate 0 {0.12 * i} 0\n'
        f'Shape "trianglemesh" "integer indices" [0 1 2 2 3 0'
        f' 4 6 5 4 7 6]\n'
        f'  "point P" [-4 0 -4  -4 0 4  4 0 4  4 0 -4'
        f'  -4 -0.05 -4  -4 -0.05 4  4 -0.05 4  4 -0.05 -4]\n'
        f'AttributeEnd' for i in range(3))
    return f"""
Integrator "path" "integer maxdepth" [5]
Sampler "sobol" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
LookAt 0 3 0.01  0 0 0  0 0 1
Camera "perspective" "float fov" [35]
WorldBegin
AttributeBegin
  Translate 0 8 0
  LightSource "point" "color I" [100 100 100]
AttributeEnd
Material "subsurface" "color sigma_a" [0.05 0.05 0.05]
         "color sigma_s" [6 6 6] "float eta" [1.33]
{slabs}
WorldEnd
"""


def skin_32(dev):
    job = parse_scene(os.path.join(SKIN_DIR, "skin.pbrt"), device=dev)
    job.film_width = job.film_height = 32
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def _probe_calls(passes, depth=DEPTH):
    """K1 / K2 calls of a main-path pass in a scene with subsurface
    materials: the camera's, then each bounce's probe passes and its
    trace_pair."""
    return 1 + depth * (passes + 1)


def _sss_gates(run_path, card, device):
    """(d): tests/test_bssrdf.py's three physical checks at a larger size
    on the card."""
    means = {}
    for name, a, s_ in (("bright", 0.02, 8.0), ("dark", 4.0, 0.5)):
        job = PbrtAPI(device).parse_string(SSS_SPHERE.format(a=a, s=s_))
        (film, _), _ = run_path(
            f"subsurface sphere {name}", lambda: cli.run_job(job),
            {"dense_queue": _probe_calls(path.SSS_PROBE_PASSES) * job.spp,
             "dense_queue_cull": 0,
             "dense_loop": _probe_calls(path.SSS_PROBE_PASSES) * job.spp,
             "dense_loop_motion": 0}, job.scene)
        rgb = filmmod.develop_rgb(film)
        check(bool(torch.isfinite(rgb).all()) and bool((rgb >= 0).all()),
              f"subsurface sphere {name}: non-finite or negative")
        means[name] = (rgb.mean().item(), rgb.max().item())
    ratio = means["bright"][0] / max(means["dark"][0], 1e-6)
    print(f"phase 26d subsurface sphere 64x64 8 spp: bright mean "
          f"{means['bright'][0]:.6f} (max {means['bright'][1]:.3f}), dark "
          f"{means['dark'][0]:.6f}: ratio {ratio:.2f} (> 4)")
    check(ratio > 4 and means["bright"][1] < 1e3,
          f"subsurface sphere: bright / dark {ratio}")
    flat = {}
    for kind in ("path", "whitted"):
        job = PbrtAPI(device).parse_string(SSS_SLAB.format(kind=kind))
        film, _ = cli.run_job(job)
        img = filmmod.develop_rgb(film)
        check(bool(torch.isfinite(img).all()), f"slab {kind}: not finite")
        n = img.shape[0]
        flat[kind] = img[n // 4:3 * n // 4, n // 4:3 * n // 4].mean().item()
    r = flat["path"] / max(flat["whitted"], 1e-9)
    print(f"phase 26d flat slab 64x64 16 spp: probe {flat['path']:.6f}, "
          f"diffusion limit (whitted) {flat['whitted']:.6f}: ratio {r:.4f} "
          "(0.5-2)")
    check(0.5 < r < 2.0, f"flat slab: probe / diffusion limit {r}")
    # the three-slab chain: a probe straight down walks every hit
    job = PbrtAPI(device).parse_string(_slab_stack())
    sc = job.scene
    g = torch.linspace(-3.0, 3.0, 256, device=device)
    gx, gz = torch.meshgrid(g, g, indexing="ij")
    o = torch.stack([gx.reshape(-1), torch.ones_like(gx).reshape(-1),
                     gz.reshape(-1)], -1)
    d = torch.tensor([0.0, -1.0, 0.0], device=device).expand_as(o)
    counts = {}
    for passes in (2, 4, 8):
        cur, remaining = o, torch.full((o.shape[0],), 3.0, device=device)
        n = torch.zeros(o.shape[0], dtype=torch.int64, device=device)
        for _ in range(passes):
            t, prim, found = isect.intersect(sc, geom.Ray.make(
                cur, d, tmax=remaining))
            pm = sc.prim_material[prim.clamp(min=0).long()]
            n += (found & (pm >= 0)).long()
            step = torch.where(found, t * 1.0002 + 1e-4, 0.0)
            cur = cur + step[:, None] * d
            remaining = torch.where(found, remaining - step, -1.0)
        counts[passes] = int(n.max())
    old = path.SSS_PROBE_PASSES
    path.SSS_PROBE_PASSES = 2
    try:
        (film, _), c = run_path(
            "three slabs, 2 probe passes", lambda: cli.run_job(job, spp=2),
            {"dense_queue": _probe_calls(2) * 2, "dense_queue_cull": 0,
             "dense_loop": _probe_calls(2) * 2, "dense_loop_motion": 0}, sc)
    finally:
        path.SSS_PROBE_PASSES = old
    check_image(filmmod.develop_spectral(film), "three slabs")
    print(f"phase 26d three slabs, {o.shape[0]} probes straight down: "
          f"most hits {counts} by passes (2: 2, 4: >= 3, 8: <= 6); the "
          f"render at 2 probe passes launches {c}")
    check(counts[2] == 2 and counts[4] >= 3 and counts[8] <= 6,
          f"three-slab chain: {counts}")


def phase26(run_path, card, device, res):
    """The rest of the materials (module docstring): (a) the skin scene
    through the CLI, (b) K1 and K2 on its probe batches, (c) the card
    against the CPU, (d) tests/test_bssrdf.py's checks."""
    t0 = time.perf_counter()
    scene_path = skin_scene.write_skin_scene(SKIN_DIR)
    job = parse_scene(scene_path, device=device)
    torch.cuda.synchronize()
    t_parse = time.perf_counter() - t0
    sc = job.scene
    n_tri = int((sc.prim_type == 0).sum())
    check(sc.use_dense and sc.has_sss and sc.has_hair and sc.has_fourier
          and sc.has_ptex, "skin scene: a material family or the dense "
          "route is missing")
    P = path.SSS_PROBE_PASSES
    calls = _probe_calls(P)
    print(f"phase 26a skin scene {scene_path}: {n_tri} triangles, C="
          f"{sc.dense_w.shape[0]} chunks of {sc.dense_chunk}, families "
          f"{sc.mat_families}, {sc.bssrdf_profile.shape[0]} BSSRDF tables, "
          f"{sc.fourier_grid.shape[0]} fourier lattice, written, parsed + "
          f"built in {t_parse:.2f} s; {P} probe passes, {calls} K1 and K2 "
          "calls a pass")
    passes = SPP * (-(-W * H // RAYS_PER_PASS))
    cli.run_job(job, spp=1, max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    stats = Stats()
    t1 = time.perf_counter()
    (film, _), counts = run_path(
        "skin render",
        lambda: cli.run_job(job, spp=SPP, max_rays_per_pass=RAYS_PER_PASS,
                            stats=stats),
        {"dense_queue": calls * passes, "dense_queue_cull": 0,
         "dense_loop": calls * passes, "dense_loop_motion": 0}, sc)
    dt = time.perf_counter() - t1
    ms = dt * 1e3 / passes
    img = filmmod.develop_spectral(film)
    check_image(img, "skin render")
    cam = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, SPP)
    strategy = dispatch.light_strategy(job.integrator_params)
    prof = pass_profile(sc, cam, cfg, trace=functools.partial(
        path.trace_paths, light_strategy=strategy))
    idle = "not measured" if prof is None else f"{1 - prof[0] / ms:.3f}"
    print(f"phase 26a skin render {W}x{H} {SPP} spp depth {DEPTH}: "
          f"{passes} passes, {ms:.2f} ms/pass, {stat_rays(stats)} rays "
          f"(probe lanes in the closest-hit count), "
          f"{stat_rays(stats) / dt:.4e} rays/s, image mean "
          f"{img.mean().item():.6f}, {_prof(prof)}, idle share {idle}, "
          f"launches {counts} on {card}")
    t_render = time.perf_counter() - t0

    # (b) K1 and K2 on the first and last probe pass of bounces 0 and 1
    t0 = time.perf_counter()
    batches = kw.sss_probe_batches(sc, cam, cfg, W, H, RAYS_PER_PASS, DEPTH,
                                   light_strategy=strategy)
    for k, (r16, tmax, _) in batches.items():
        print(f"phase 26b probe batch {k}: {int((tmax > 0).sum())} live "
              f"lanes of {tmax.shape[0]}")
    pres = compare_kernels(sc, {f"skin_probe_{k}": v
                                for k, v in batches.items()},
                           card, "dense_loop", seams=True, skips=SKIN_SKIPS)
    for k, v in pres.items():
        res[k].update(v)
    rep = kw.probe_repeats(sc, cam, cfg, W, H, RAYS_PER_PASS, DEPTH,
                           light_strategy=strategy)
    print("phase 26b probe lanes whose pass k+1 returned pass k's triangle "
          "(the march step re-hit it), by bounce: " + ", ".join(
              f"{b}: {s_} of {n} live" for b, (s_, n) in rep.items()))
    t_kernels = time.perf_counter() - t0

    # (c) the card against the CPU
    t0 = time.perf_counter()
    compare_cpu([("skin", skin_32)])
    t_cpu = time.perf_counter() - t0

    # (d) tests/test_bssrdf.py's three scenes, larger
    t0 = time.perf_counter()
    _sss_gates(run_path, card, device)
    print(f"phase 26 materials pass; wall s write + parse + render "
          f"{t_render:.1f}, kernels {t_kernels:.1f}, GPU vs CPU {t_cpu:.1f}"
          f", bssrdf gates {time.perf_counter() - t0:.1f}")


# phase 27: the light-side integrators (PERF.md section 4); the closure
# gates' limits (tests/test_bdpt.py's, tests/test_lighttracer.py's
# test_mlt_matches_forward) and MLT's card against CPU limit (c, d)
BDPT_GAP = 0.06
MLT_GAP = 0.10
MLT_CPU_GAP = 0.05
MLT_32 = (256, 1024, 16)
LIGHT_SKIPS = 2
LIGHT_SIDE_SPP = 4


def light_side_units(kind, spp, depth, res):
    """(units, K1 / K2 calls) of a light-side render of cornell_bench at
    res x res: passes (lighttracer, bdpt), iterations (sppm) or path
    evaluations (mlt: the bootstrap, the seeds, a mutation step each)."""
    if kind == "lighttracer":
        return spp, spp * 2 * depth
    if kind == "bdpt":
        n = spp * -(-res * res // bdpt.RAYS_PER_PASS)
        return n, n * ((depth + 1) + depth + len(bdpt.strategies(
            depth + 2, depth + 1, depth + 2, 1)))
    if kind == "sppm":
        n = max(spp, 4)
        return n, n * (3 * depth + 1)
    n = 2 + max(spp, 8) * 8
    return n - 2, n * (depth + 1)


def _light_32(kind, dev):
    job = _bench_as(kind, {}, dev, 32)
    return cli.run_job(job, spp=2, max_depth=DEPTH)[0]


def mlt_32(dev):
    """mlt.render_mlt of cornell_bench at 32x32 with MLT_32's (chains,
    bootstrap paths, mutations a chain): the host's launches bind both
    devices, so fewer than run_job's 64 mutations."""
    job = _bench_as("mlt", {}, dev, 32)
    chains, boot, mutations = MLT_32
    return mlt.render_mlt(job.scene, cli.build_camera(job, 32, 32, dev), 32,
                          32, n_chains=chains, mutations_per_chain=mutations,
                          n_bootstrap=boot, max_depth=DEPTH)[0]


def phase27(run_path, card, device, res):
    """The light-side integrators (module docstring): (a) the renders,
    (b) the closure gates, (c) the kernels on their batches, (d) the card
    against the CPU."""
    t0 = time.perf_counter()
    pjob = _bench_as("path", {}, device, W)
    ppasses = LIGHT_SIDE_SPP * -(-W * H // (1 << 18))
    (pfilm, _), _ = run_path(
        "light-side reference path", lambda: cli.run_job(
            pjob, spp=LIGHT_SIDE_SPP, max_depth=DEPTH),
        {"dense_queue": (DEPTH + 1) * ppasses, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * ppasses, "dense_loop_motion": 0},
        pjob.scene)
    p_mean = filmmod.develop_spectral(pfilm).mean().item()
    cam = cli.build_camera(pjob, W, H, device)
    cfg = SamplerConfig("sobol", 0, LIGHT_SIDE_SPP)
    means = {}
    plain_gather = sppm.gather_plain
    for kind in dispatch.LIGHT_SIDE:
        job = _bench_as(kind, {}, device, W)
        units, calls = light_side_units(kind, LIGHT_SIDE_SPP, DEPTH, W)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # G1 a photon bounce on the card, and never the plain loop
        sppm.gather_plain = _refuse_plain_gather
        sppm.LAUNCHES["sppm_gather"] = 0
        t1 = time.perf_counter()
        try:
            (film, _), counts = run_path(
                f"{kind} render", lambda: cli.run_job(
                    job, spp=LIGHT_SIDE_SPP, max_depth=DEPTH),
                {"dense_queue": calls, "dense_queue_cull": 0,
                 "dense_loop": calls, "dense_loop_motion": 0}, job.scene)
        finally:
            sppm.gather_plain = plain_gather
        wall = time.perf_counter() - t1
        g1 = sppm.LAUNCHES["sppm_gather"]
        expect = units * (DEPTH - 1) if kind == "sppm" else 0
        check(g1 == expect, f"{kind} render: {g1} sppm_gather launches, "
              f"expected {expect}")
        counts = dict(counts, sppm_gather=g1)
        if kind == "sppm":
            g1_launches = g1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        img = filmmod.develop_spectral(film)
        check_image(img, f"{kind} render")
        means[kind] = img.mean().item()
        ms = wall * 1e3 / units
        rays = bdpt.RAYS_PER_PASS if kind == "bdpt" else (
            4096 if kind == "mlt" else W * H)
        # one unit alone (mlt's bootstrap runs outside it), profiled, then
        # timed on the host's clock; the idle share is read against it
        one = launch_components.light_side_unit(kind, job.scene, cam, cfg,
                                                W, H, DEPTH, rays)
        prof = unit_profile(one)
        t1 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
        idle = ("not measured" if prof is None
                else f"{1 - prof[0] / one_ms:.3f}")
        unit = {"lighttracer": "photon pass", "bdpt": "pass",
                "sppm": "iteration", "mlt": "mutation step"}[kind]
        print(f"phase 27a {kind} cornell_bench.pbrt {W}x{H} depth {DEPTH}: "
              f"wall {wall:.2f} s, render wall / ({units} x {unit}) "
              f"{ms:.2f} ms{' (bootstrap included)' if kind == 'mlt' else ''}"
              f", one {unit} alone {one_ms:.2f} ms, "
              f"{_prof(prof).replace('a pass', 'a ' + unit)}, idle share "
              f"{idle} (of the one alone), peak memory {peak:.3f} GiB, "
              f"image mean "
              f"{means[kind]:.6f} (path {p_mean:.6f}: ratio "
              f"{means[kind] / p_mean:.4f}), launches {counts} on {card}")
    gaps = {k: abs(means[k] / p_mean - 1.0) for k in means}
    print(f"phase 27b image means against path's {p_mean:.6f} at "
          f"{LIGHT_SIDE_SPP} spp: " + ", ".join(
              f"{k} {means[k] / p_mean:.4f}" for k in means)
          + f" (bdpt within {BDPT_GAP}, mlt within {MLT_GAP}; lighttracer "
          "and sppm not gated)")
    check(gaps["bdpt"] < BDPT_GAP, f"bdpt: image mean off path's by "
          f"{gaps['bdpt']}")
    check(gaps["mlt"] < MLT_GAP, f"mlt: image mean off path's by "
          f"{gaps['mlt']}")
    t_render = time.perf_counter() - t0

    # (c) K1 and K2 on the light-side batches
    t0 = time.perf_counter()
    sc = pjob.scene
    batches = {f"bdpt_{k}": v for k, v in kw.bdpt_batches(
        sc, cam, cfg, W, H, bdpt.RAYS_PER_PASS, DEPTH).items()}
    batches["sppm_photon"] = kw.photon_batch(sc, cfg, W * H, DEPTH)
    for k, (r16, tmax, _) in batches.items():
        print(f"phase 27c batch {k}: {int((tmax > 0).sum())} live lanes of "
              f"{tmax.shape[0]}, {int((r16[:, 12] > 0.5).sum())} any-hit")
    for k, v in compare_kernels(sc, batches, card, "dense_loop", seams=True,
                                skips=LIGHT_SKIPS).items():
        res[k].update(v)
    t_kernels = time.perf_counter() - t0

    # (d) the card against the CPU
    t0 = time.perf_counter()
    compare_cpu([(k, functools.partial(_light_32, k))
                 for k in ("lighttracer", "bdpt", "sppm")])
    g, c = (mlt_32(dev).mean().item() for dev in ("cuda", "cpu"))
    print(f"GPU vs CPU mlt 32x32 ({MLT_32[0]} chains, {MLT_32[1]} bootstrap "
          f"paths, {MLT_32[2]} mutations): mean {g:.6f} vs {c:.6f} (rel "
          f"{abs(g / c - 1):.3e}, limit {MLT_CPU_GAP})")
    check(abs(g / c - 1) < MLT_CPU_GAP, f"mlt: GPU/CPU mean {g} vs {c}")
    print(f"phase 27 light-side integrators pass; wall s renders + gates "
          f"{t_render:.1f}, kernels {t_kernels:.1f}, GPU vs CPU "
          f"{time.perf_counter() - t0:.1f}")
    return g1_launches


def _refuse_plain_gather(*args):
    raise AssertionError("sppm.gather_plain ran on a card render")


GATHER_RES = 362      # the benchmark's cornell.sppm-362
GATHER_SOURCE = "pbrt_tpu_torch/csrc/sppm_gather.cu"
# the XLA chunk loop G1 replaces (no pl.pallas_call)
GATHER_REPLACES = "pbrt_tpu/integrators/sppm.py:161"
GATHER_TAU_REL = 1e-5


def phase27_gather(device, card):
    """(e) G1, SPPM's photon gather kernel, against gather_plain (module
    docstring).  Returns the kernels line's measurements of G1."""
    t0 = time.perf_counter()
    job = _bench_as("sppm", {}, device, GATHER_RES)
    cam = cli.build_camera(job, GATHER_RES, GATHER_RES, device)
    V = GATHER_RES * GATHER_RES
    sppm.LAUNCHES["sppm_gather"] = 0
    calls = kw.gather_batches(
        job.scene, cam, SamplerConfig("sobol", 0, LIGHT_SIDE_SPP),
        GATHER_RES, GATHER_RES, V, DEPTH,
        float(job.scene.world_radius) * 0.01)
    check(len(calls) == DEPTH - 1
          and sppm.LAUNCHES["sppm_gather"] == DEPTH - 1,
          f"sppm gather: {len(calls)} calls, "
          f"{sppm.LAUNCHES['sppm_gather']} launches")
    abs_err = rel_err = 0.0
    for b, args in enumerate(calls, 1):
        tau_ref, M_ref = sppm.gather_plain(*args)
        tau, M = sppm.gather(*args)
        differ = (M != M_ref).nonzero().flatten()
        near = kw.gather_near_ties(*args[:5], rows=differ)
        same = M == M_ref
        err = (tau - tau_ref).abs()[same]
        rel = (err / tau_ref.abs()[same].clamp_min(1e-30)).max().item()
        abs_err, rel_err = max(abs_err, err.max().item()), max(rel_err, rel)
        hits = int((M_ref - args[7]).sum().item())
        print(f"phase 27e gather bounce {b}: {int(args[4].sum())} live "
              f"photons of {args[3].shape[0]}, {hits} hits on "
              f"{int(args[1].sum())} valid points of {V}; M differs on "
              f"{differ.numel()} points ({int(near.sum())} with a pair "
              f"within 4 ulp of r2), tau_add max rel {rel:.3e} (limit "
              f"{GATHER_TAU_REL}) on {card}")
        check(bool(near.all()), f"sppm gather bounce {b}: M differs off a "
              "near tie")
        check(rel <= GATHER_TAU_REL, f"sppm gather bounce {b}: tau_add "
              f"rel {rel}")
    args = calls[0]
    C = sppm.PHOTON_CHUNK
    chunk = args[:3] + tuple(a[:C] for a in args[3:6]) + args[6:]
    kernel = _device_time(lambda: sppm.gather(*args))
    plain = _device_time(lambda: sppm.gather_plain(*chunk))
    event = kw.time_ms(lambda: sppm.gather(*args), 4, device)
    check(kernel is not None, "sppm gather: no device time of the kernel "
          "(no trace held it, and the held stream ran dry)")
    check(kernel[1] in (None, 1.0), f"sppm gather: {kernel[1]} kernels a "
          "call, expected 1")
    P = args[3].shape[0]
    bound = kw.gather_bound(V, P)
    try:
        regs = next((v for k, v in cuda_kernels.ptxas_report().items()
                     if "sppm_gather_kernel" in k), {})
    except FileNotFoundError:
        regs = "not reported (the library was built by another process)"
    plain_ms = None if plain is None else plain[0] * P / C
    print(f"phase 27e gather {V} x {P} (bounce 1's call): kernel "
          f"{kernel[0]:.3f} ms device ({kernel[2]}; events "
          f"{event:.3f} ms), plain "
          + ("not measured" if plain is None else
             f"{plain_ms:.2f} ms (one {C}-photon chunk {plain[0]:.4f} ms "
             f"device ({plain[2]}) x {P / C:.2f})")
          + f", bound {bound:.3f} ms (operations: {V * P:.4g} pairs x "
          f"{kw.GATHER_PAIR_INSTR} f32 instructions at 33.5e12/s), share "
          f"{bound / kernel[0]:.1%}, ptxas {regs}, launches in this phase "
          f"{sppm.LAUNCHES['sppm_gather']} on {card}")
    print(f"phase 27e sppm gather pass; wall s "
          f"{time.perf_counter() - t0:.1f}")
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": event, "device_ms": kernel[0], "device_ms_from": kernel[2],
            "plain_ms": plain_ms, "bound_ms": bound,
            "registers": regs.get("registers") if isinstance(regs, dict)
            else None,
            "launches_harnesses": sppm.LAUNCHES["sppm_gather"]}


def _device_time(fn):
    """(device ms a call, kernels a call or None, how it was read) of fn():
    the profiler's kernel times (kernel_workloads.device_ms); if no trace
    held a kernel, CUDA events on a stream held until every call was
    queued (kernel_workloads.queued_ms), which time the calls back to
    back on the card.  None if neither read."""
    prof = kw.device_ms(fn, reps=4, traces=6)
    if prof is not None:
        return prof[0], prof[1], "profiler"
    q = kw.queued_ms(fn, 4)
    return None if q is None else (q, None, "events on a held stream")


def _rel_max(a, b):
    """Largest |a - b| over b's largest magnitude."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _card_main(argv):
    """The CLI's main on the card; returns its stdout (also printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, f"main {argv}: non-zero return")
    torch.cuda.synchronize()
    return buf.getvalue()


def _counter(text, name):
    for line in text.splitlines():
        if line.strip().startswith(name):
            return int(line.split()[-1].replace(",", ""))
    raise AssertionError(f"the stats report has no {name!r}")


def phase28a(run_path, card, device, scene, camera, cfg, tmp):
    """Checkpoint and resume (module docstring)."""
    def fresh():
        return filmmod.make_film(W, H, "gaussian", device=device)
    whole = path.render(scene, camera, fresh(), cfg, SPP, max_depth=DEPTH,
                        max_rays_per_pass=RAYS_PER_PASS)
    cp = os.path.join(tmp, "film.ckpt")
    part = path.render(scene, camera, fresh(), cfg, 2, max_depth=DEPTH,
                       max_rays_per_pass=RAYS_PER_PASS, checkpoint_path=cp,
                       checkpoint_every=0.0)
    torch.cuda.synchronize()
    fp = ckpt.render_fingerprint(scene, cfg, SPP, DEPTH, W, H)
    t0 = time.perf_counter()
    ckpt.save(cp, part, 2, fp)
    save_ms = (time.perf_counter() - t0) * 1e3
    mib = os.path.getsize(cp) / 2 ** 20
    probe = fresh()
    t0 = time.perf_counter()
    _, done = ckpt.load(cp, probe, fp)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(done == 2, f"checkpoint: resumed at {done} spp, expected 2")
    calls = (DEPTH + 1) * (SPP - 2) * (-(-W * H // RAYS_PER_PASS))
    out, counts = run_path(
        "resumed render", lambda: path.render(
            scene, camera, fresh(), cfg, SPP, max_depth=DEPTH,
            max_rays_per_pass=RAYS_PER_PASS, checkpoint_path=cp,
            checkpoint_every=1e9),
        {"dense_queue": calls, "dense_queue_cull": 0, "dense_loop": calls,
         "dense_loop_motion": 0}, scene)
    errs = {k: _rel_max(getattr(out, k), getattr(whole, k))
            for k in ("weighted", "weight", "raw")}
    print(f"phase 28a checkpoint Cornell {W}x{H} {SPP} spp depth {DEPTH}: "
          f"resumed at 2 spp, launches {counts}; max |resumed - whole| / "
          f"max |whole|: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
          + f" (limit 1e-5); save {save_ms:.2f} ms, load {load_ms:.2f} ms, "
          f"file {mib:.3f} MiB on {card}")
    for k, v in errs.items():
        check(v <= 1e-5, f"checkpoint resume: {k} off by {v} of its max")


def phase28b(run_path, card, device, tmp):
    """The CLI with --checkpoint and the stats report (module
    docstring)."""
    job = parse_scene(BENCH_SCENE, device=device)
    calls = (DEPTH + 1) * GATE_SPP * (-(-W * H // (1 << 18)))
    cp = os.path.join(tmp, "cli.ckpt")
    outs = [os.path.join(tmp, f"cli{i}.exr") for i in range(2)]

    def argv(i):
        return [BENCH_SCENE, "--spp", str(GATE_SPP), "--checkpoint", cp,
                "-o", outs[i]]
    text, counts = run_path(
        "CLI with a checkpoint", lambda: _card_main(argv(0)),
        {"dense_queue": calls, "dense_queue_cull": 0, "dense_loop": calls,
         "dense_loop_motion": 0}, job.scene)
    print(text.rstrip())
    cam_rays = _counter(text, "Camera rays traced")
    tests = (_counter(text, "Regular ray intersection tests")
             + _counter(text, "Shadow ray intersection tests"))
    film = filmmod.make_film(W, H, job.filter_name, device=device,
                             **{k: v for k, v in job.filter_params.items()
                                if k != "radius"})
    _, n_rays = dispatch.render_with_integrator(
        job, cli.build_camera(job, W, H, device), film,
        SamplerConfig(job.sampler_kind, 0, GATE_SPP), GATE_SPP,
        job.integrator_params["maxdepth"], count_rays=True)
    text2, counts2 = run_path(
        "CLI on a completed checkpoint", lambda: _card_main(argv(1)),
        {"dense_queue": 0, "dense_queue_cull": 0, "dense_loop": 0,
         "dense_loop_motion": 0}, job.scene)
    same = all(open(outs[0][:-4] + e, "rb").read()
               == open(outs[1][:-4] + e, "rb").read()
               for e in (".exr", ".dat"))
    print(f"phase 28b CLI cornell_bench.pbrt {W}x{H} {GATE_SPP} spp with "
          f"--checkpoint: camera rays {cam_rays} (expected {W * H * GATE_SPP})"
          f", regular + shadow tests {tests} against count_rays' {n_rays}; "
          f"launches {counts}; on the completed checkpoint {counts2}, "
          f"outputs equal {same} on {card}")
    check(cam_rays == W * H * GATE_SPP, f"CLI stats: {cam_rays} camera rays")
    check(tests == n_rays, f"CLI stats: {tests} ray tests, count_rays "
          f"{n_rays}")
    check(same, "CLI on a completed checkpoint wrote other outputs")
    check("Camera rays traced" not in text2,
          "CLI on a completed checkpoint rendered")


def phase28c(card, device, tmp):
    """The render split over two ranks on this card (module docstring)."""
    out = os.path.join(tmp, "ranks.npz")
    spp = 2
    cmd = [sys.executable, "-m", "pbrt_tpu_torch.parallel.multihost",
           "--init-method", f"file://{os.path.join(tmp, 'init')}",
           "--world-size", "2", "--backend", "gloo", "--size", str(W),
           "--spp", str(spp), "--depth", str(DEPTH), "--tessellate",
           "--warmup", "1", "--out", out]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, t in zip(procs, texts):
        check(p.returncode == 0, f"multihost rank failed:\n{t[-3000:]}")
    scene, cam_ctor = flagship.cornell(device=device)
    one = path.render(scene, cam_ctor(W, H),
                      filmmod.make_film(W, H, "box", device=device),
                      SamplerConfig("sobol", 0, spp), spp, max_depth=DEPTH,
                      max_rays_per_pass=W * H)
    with np.load(out) as z:
        ranks = dataclasses.replace(one, **{
            k: torch.from_numpy(z[k]).to(device)
            for k in ("weighted", "weight", "raw", "splat")})
    a = filmmod.develop_spectral(ranks).cpu().numpy()
    b = filmmod.develop_spectral(one).cpu().numpy()
    mean_gap = abs(a.mean() / b.mean() - 1.0)
    la, lb = a.sum(-1), b.sum(-1)
    close = float((np.abs(la - lb) <= 1e-4 * np.abs(lb)).mean())
    for t in texts:
        for line in t.splitlines():
            if line.startswith(("rank ", "MULTIHOST_OK")):
                print("  " + line)
    print(f"phase 28c two gloo ranks on one card (CUDA tensors), Cornell "
          f"{W}x{H} {spp} spp depth {DEPTH}, {W * H // 2} rays a rank a "
          f"pass: image mean off one process's by {mean_gap:.3e} (limit "
          f"1e-5), pixels within 1e-4 {close:.6f} (>= 0.999); both ranks' "
          f"wall {wall:.1f} s; NCCL not run: it waits for a machine with "
          f"two cards (NCCL refuses two ranks on one device) on {card}")
    check(mean_gap <= 1e-5, f"two ranks: image mean off by {mean_gap}")
    check(close >= 0.999, f"two ranks: only {close} of pixels within 1e-4")


def phase28d(card):
    """bsdftest on the card (module docstring)."""
    fails = []
    for m in sorted(bsdftest.MATERIALS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bsdftest.main(["--material", m, "--samples", "100000"])
        # its report on one line: valid, albedo, transmitted, the
        # sample / evaluation differences, PASS or FAIL
        print("  " + " | ".join(x.strip() for x in
                                buf.getvalue().splitlines()))
        if rc != 0:
            fails.append(m)
    print(f"phase 28d bsdftest, {len(bsdftest.MATERIALS)} materials at "
          f"100,000 samples on {card}: failed {fails or 'none'}")
    check(not fails, f"bsdftest failed: {fails}")


def phase28(run_path, card, device, scene, camera, cfg):
    """Checkpoint, the CLI's stats, ranks, bsdftest (module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("28a", lambda: phase28a(run_path, card, device, scene,
                                         camera, cfg, tmp)),
                ("28b", lambda: phase28b(run_path, card, device, tmp)),
                ("28c", lambda: phase28c(card, device, tmp)),
                ("28d", lambda: phase28d(card))):
            t0 = time.perf_counter()
            fn()
            print(f"phase {name} wall s {time.perf_counter() - t0:.1f}")


def walk_rows(res, launches):
    """The walk kernels' rows of the kernels line (WALK_ROWS), each with
    its kernel's launches on phase 25's render paths."""
    rows = []
    for row, cell, batch in WALK_ROWS:
        r, kern = res[row], WALK_CELLS[cell][4]
        rows.append({
            "name": row, "route": "cuda", "source": WALK_SOURCE,
            "replaces": WALK_REPLACES[kern], "launches": launches[kern],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": _ms(r["device"]), "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "kernel": kern, "cell": cell,
            "batch_rays": r["B"], "node_visits_mean": r["visits_mean"],
            "node_visits_max": r["visits_max"],
            "tri_tests_mean": r["tests_mean"], "nodes_read": r["nodes"],
            "tris_read": r["tris"],
            "device_ms_top1": _ms(r["device_top1"]),
            "device_ms_rest": _ms(r["device_rest"]),
            "us_a_step_longest": r["us_a_step"]})
    return rows


def _luminance(raw):
    """Per-pixel luminance [H,W] of a .dat's raw sums."""
    return np.asarray(raw, np.float64) @ spectrum.CIE_Y * (
        spectrum.BIN_WIDTH / spectrum.CIE_Y_INTEGRAL)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    check(torch.cuda.device_count() == 1,
          f"chip_smoke drives one card; {torch.cuda.device_count()} are "
          "visible (set CUDA_VISIBLE_DEVICES to one)")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    # the plain versions' matmuls must be true f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    _, build_s, log = cuda_kernels.build()
    cuda_kernels.library()
    print(f"phase 2 build: {build_s:.2f} s (one nvcc, sm_90a; kernels "
          "dense_queue (its lists and its cull alone), dense_loop (5 "
          "modes and the tile dump), dense_loop_motion, bvh_walk and "
          "kd_walk (static and motion), sppm_gather)")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry",
                                   "spill")):
            print("  ptxas: " + line.strip())

    # --- phases 3-4: kernels against their plain versions ---
    scene, cam_ctor = flagship.cornell(device=device)
    camera = cam_ctor(W, H)
    cfg = SamplerConfig("sobol", 0, SPP)
    batches = kw.main_path_batches(scene, camera, cfg, W, H, RAYS_PER_PASS,
                                   DEPTH)
    res = compare_kernels(scene, batches, card, "dense_loop")
    mjob = parse_scene(MOTION_SCENE, device=device)
    check(mjob.scene.dense_motion and mjob.scene.has_animated_quads,
          "the motion scene did not parse as moving")
    mcam = cli.build_camera(mjob, W, H, device)
    mres = compare_kernels(mjob.scene, kw.main_path_batches(
        mjob.scene, mcam, cfg, W, H, RAYS_PER_PASS, DEPTH), card,
        "dense_loop_motion")
    res["dense_loop_motion"] = mres["dense_loop_motion"]
    res["dense_queue_motion"] = mres["dense_queue"]
    res["dense_queue_cull_motion"] = mres["dense_queue_cull"]
    compare_list_cases(device)
    print("phase 3-4 kernels agree with their plain versions")

    passes = SPP * (-(-W * H // RAYS_PER_PASS))
    launches = {k: 0 for k in KERNELS}
    # the merge keys' fills, by the K2 that took them
    init_launches = {"dense_loop": 0, "dense_loop_motion": 0}

    def run_path(what, fn, expect, sc):
        k2 = "dense_loop_motion" if sc.dense_motion else "dense_loop"
        calls = expect[k2]
        # one fill of the merge keys per K2 call where lists can be split
        expect = dict(expect, dense_loop_init=calls if dense.loop_blocks(
            sc.dense_w.shape[0]) > 1 else 0)
        dense.reset_launch_counts()
        accel_walk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(dense.LAUNCHES)
        check_launches(counts, expect, what)
        check_launches(accel_walk.LAUNCHES, dict.fromkeys(
            accel_walk.LAUNCHES, 0), what)
        for k in KERNELS:
            launches[k] += counts[k]
        init_launches[k2] += counts["dense_loop_init"]
        return out, counts

    # --- phase 5: the Cornell model through render ---
    path.render(scene, camera, filmmod.make_film(W, H, "gaussian",
                                                 device=device),
                cfg, 1, max_depth=DEPTH, max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (film, n_rays), counts = run_path(
        "Cornell render",
        lambda: path.render(scene, camera,
                            filmmod.make_film(W, H, "gaussian",
                                              device=device),
                            cfg, SPP, max_depth=DEPTH,
                            max_rays_per_pass=RAYS_PER_PASS,
                            count_rays=True),
        {"dense_queue": (DEPTH + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * passes, "dense_loop_motion": 0}, scene)
    dt = time.perf_counter() - t0
    check_image(filmmod.develop_spectral(film), "Cornell render")
    print(f"phase 5 Cornell render {W}x{H} {SPP} spp depth {DEPTH}: "
          f"{passes} passes, {dt * 1e3 / passes:.2f} ms/pass, {n_rays} "
          f"rays, {n_rays / dt:.4e} rays/s, launches {counts} on {card}")

    # --- phase 6: the CLI on cornell_bench.pbrt against the reference ---
    job = parse_scene(BENCH_SCENE, device=device)
    gate_passes = GATE_SPP * (-(-W * H // (1 << 18)))
    stats = Stats()
    t0 = time.perf_counter()
    (gfilm, _), counts = run_path(
        "CLI reference gate",
        lambda: cli.run_job(job, spp=GATE_SPP, stats=stats),
        {"dense_queue": (DEPTH + 1) * gate_passes, "dense_queue_cull": 0,
         "dense_loop": (DEPTH + 1) * gate_passes, "dense_loop_motion": 0},
        job.scene)
    dt = time.perf_counter() - t0
    med, flat = reference_gate(gfilm, GATE_SPP)
    print(f"phase 6 CLI reference gate cornell_bench.pbrt {W}x{H} "
          f"{GATE_SPP} spp: median rel err of lit 16x16 blocks {med:.4f} "
          f"(< 0.08), band ratio flat within {flat:.4f} (< 0.05), "
          f"{dt:.2f} s, {stat_rays(stats)} rays, launches {counts} on "
          f"{card}")
    check(med < 0.08, f"reference gate: median block error {med}")
    check(flat < 0.05, f"reference gate: band ratio off by {flat}")

    # --- phase 7: the CLI on the motion scene, full width ---
    cli.run_job(mjob, spp=1, max_depth=DEPTH,
                max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    stats = Stats()
    t0 = time.perf_counter()
    (mfilm, _), counts = run_path(
        "motion render",
        lambda: cli.run_job(mjob, spp=SPP, max_depth=DEPTH,
                            max_rays_per_pass=RAYS_PER_PASS, stats=stats),
        {"dense_queue": (DEPTH + 1) * passes, "dense_queue_cull": 0,
         "dense_loop": 0, "dense_loop_motion": (DEPTH + 1) * passes},
        mjob.scene)
    dt = time.perf_counter() - t0
    check_image(filmmod.develop_spectral(mfilm), "motion render")
    print(f"phase 7 motion render cornell_motion.pbrt {W}x{H} {SPP} spp "
          f"depth {DEPTH}: {passes} passes, {dt * 1e3 / passes:.2f} "
          f"ms/pass, {stat_rays(stats)} rays, {stat_rays(stats) / dt:.4e} "
          f"rays/s, launches {counts} on {card}")

    compare_cpu([("Cornell", cornell_32), ("motion", motion_32)])
    print("phase 8 GPU and CPU renders agree")

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "motion.exr")
        written = cli.write_outputs(mjob, mfilm, out, quiet=True)
        back, flag = filmio.read_dat(os.path.join(d, "motion.dat"))
        check(flag == "v3" and np.array_equal(
            back, mfilm.raw.cpu().numpy().astype(np.float64)),
            ".dat round trip")
        print("phase 9 wrote " + ", ".join(
            f"{os.path.basename(p)} {os.path.getsize(p)} B" for p in written)
            + "; .dat read back equal")

    harness = phase10(scene, card)

    # --- phase 11: the matched-RNG render against the reference binary ---
    rjob = parse_scene(REFRNG_SCENE, device=device)
    rcam = cli.build_camera(rjob, REF_W, REF_H, device)
    rbatches = kw.refpath_batches(rjob.scene, rcam, REF_W, REF_H, DEPTH)
    rres = compare_kernels(rjob.scene, {f"refpath_{k}": v
                                        for k, v in rbatches.items()},
                           card, "dense_loop", seams=True)
    for k, v in rres.items():
        for b, rec in v.items():
            res[k][b] = rec
    batch = rbatches["bounce1"][0].shape[0]
    for spp, fixture in REFRNG_FIXTURES:
        d = np.load(fixture)
        check(int(d["spp"]) == spp, f"{fixture}: spp {d['spp']}")
        rfilm = filmmod.make_film(REF_W, REF_H, "box", radius=(0.5, 0.5),
                                  device=device, pbrt_boundary=True)
        t0 = time.perf_counter()
        _, counts = run_path(
            f"matched-RNG render {spp} spp",
            lambda: refpath.render_ref(rjob.scene, rcam, rfilm, REF_W, REF_H,
                                       spp, max_depth=DEPTH),
            {"dense_queue": (DEPTH + 1) * spp, "dense_queue_cull": 0,
             "dense_loop": (DEPTH + 1) * spp, "dense_loop_motion": 0},
            rjob.scene)
        dt = time.perf_counter() - t0
        g = refrng_gate(rfilm, d["img"])
        print(f"phase 11 matched-RNG gate cornell_refrng.pbrt {REF_W}x"
              f"{REF_H} {spp} spp depth {DEPTH} vs "
              f"{os.path.basename(fixture)}: frac_close "
              f"{g['frac_close']:.6f} (> 0.98), median rel "
              f"{g['median_rel']:.3e} (< 1e-4), mean ratio off by "
              f"{g['mean_ratio']:.3e} (< 2e-3), band median "
              f"{g['band_median']:.3e} (< 1e-4); {spp} passes, "
              f"{dt * 1e3 / spp:.2f} ms/pass, intersect batch {batch} rays "
              f"after the camera's {REF_W * REF_H}, launches {counts} on "
              f"{card}")
        check(g["frac_close"] > 0.98, f"refrng {spp} spp: frac_close "
              f"{g['frac_close']}")
        check(g["median_rel"] < 1e-4, f"refrng {spp} spp: median rel "
              f"{g['median_rel']}")
        check(g["mean_ratio"] < 2e-3, f"refrng {spp} spp: mean ratio off "
              f"by {g['mean_ratio']}")
        check(g["band_median"] < 1e-4, f"refrng {spp} spp: band median "
              f"{g['band_median']}")

    # --- phase 12: the metadata integrator against the reference ---
    mdjob = parse_scene(META_SCENE, device=device)
    stats = Stats()
    t0 = time.perf_counter()
    (mdfilm, _), counts = run_path(
        "metadata render", lambda: cli.run_job(mdjob, stats=stats),
        {"dense_queue": 1, "dense_queue_cull": 0, "dense_loop": 1,
         "dense_loop_motion": 0}, mdjob.scene)
    dt = time.perf_counter() - t0
    centre, med, worst = metadata_gate(mdfilm)
    print(f"phase 12 metadata gate metadata_depth.pbrt 48x48 (depth): "
          f"centre pixel off by {centre:.3e} (< 5e-3), median 6x6-block "
          f"error {med:.3e} (< 1e-2), largest {worst:.3e} (< 3e-2), "
          f"{dt:.2f} s, launches {counts} on {card}")
    check(not stats.counters, "metadata: counted rays")
    check(centre < 5e-3, f"metadata gate: centre pixel off by {centre}")
    check(med < 1e-2, f"metadata gate: median block error {med}")
    check(worst < 3e-2, f"metadata gate: largest block error {worst}")

    # --- phase 13: spectralpath on the Cornell model, full width ---
    t0 = time.perf_counter()
    sfilm, counts = run_path(
        "spectralpath render",
        lambda: path.render(scene, camera,
                            filmmod.make_film(W, H, "gaussian",
                                              device=device),
                            cfg, SPP, max_depth=DEPTH,
                            max_rays_per_pass=RAYS_PER_PASS,
                            trace_fn=spectralpath.make_trace_spectral(
                                CA_BANDS, camera=camera)),
        {"dense_queue": CA_BANDS * (DEPTH + 1) * passes,
         "dense_queue_cull": 0,
         "dense_loop": CA_BANDS * (DEPTH + 1) * passes,
         "dense_loop_motion": 0}, scene)
    dt = time.perf_counter() - t0
    s_img = filmmod.develop_spectral(sfilm)
    check_image(s_img, "spectralpath render")
    s_img = s_img.cpu().numpy()
    p_img = filmmod.develop_spectral(film).cpu().numpy()
    gap = abs(s_img.mean() / p_img.mean() - 1.0)
    s_lum, p_lum = s_img.sum(-1), p_img.sum(-1)
    close = float((np.abs(s_lum - p_lum) <= 1e-2 * np.abs(p_lum)).mean())
    print(f"phase 13 spectralpath Cornell {W}x{H} {SPP} spp {CA_BANDS} "
          f"bands depth {DEPTH}: {passes} passes, {dt * 1e3 / passes:.2f} "
          f"ms/pass; image mean {s_img.mean():.6f} vs path.render's "
          f"{p_img.mean():.6f} (gap {gap:.3e}, limit 1e-2), pixels within "
          f"1e-2 {close:.4f} (>= 0.95), launches {counts} on {card}")
    check(gap < 1e-2, f"spectralpath: image mean off path's by {gap}")
    check(close >= 0.95, f"spectralpath: only {close} of pixels agree with "
          "path's within 1e-2")

    # --- phases 14-17: the lens cameras, the samplers, the filters ---
    tmpdir = tempfile.TemporaryDirectory()
    lens_phases(scene, camera, cfg, run_path, card, tmpdir.name)
    tmpdir.cleanup()

    # --- phases 18-19: the materials, textures and bump maps ---
    t0 = time.perf_counter()
    phase18(run_path, card, device)
    t18 = time.perf_counter() - t0
    phase19(card, device)
    print(f"phases 18-19 materials pass; wall s 18 {t18:.1f}, 19 "
          f"{time.perf_counter() - t0 - t18:.1f}")

    # --- phase 20: every light kind ---
    t0 = time.perf_counter()
    phase20(run_path, card, device, res)
    print(f"phase 20 lights pass; wall s {time.perf_counter() - t0:.1f}")

    # --- phase 21: differentiable rendering ---
    t0 = time.perf_counter()
    phase21(run_path, card, device, scene, camera)
    print(f"phase 21 gradients; wall s {time.perf_counter() - t0:.1f}")

    # --- phases 22-23: media and volpath; whitted, ao, directlighting ---
    t0 = time.perf_counter()
    phase22(run_path, card, device, res)
    print(f"phase 22 media; wall s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    phase23(run_path, card, device)
    print(f"phase 23 other integrators; wall s "
          f"{time.perf_counter() - t0:.1f}")

    # --- phase 24: every shape and the rest of the scene format ---
    t0 = time.perf_counter()
    shapes = phase24(run_path, card, device, res)
    print(f"phase 24 shapes; wall s {time.perf_counter() - t0:.1f}")

    # --- phase 25: scenes over the dense cap, the BVH and kd walks ---
    walk_launches = dict.fromkeys(accel_walk.LAUNCHES, 0)

    def run_walk(what, fn, expect):
        """run_path for the walk routes: expect {walk kernel: exact
        count}; no K1 or K2 launches."""
        dense.reset_launch_counts()
        accel_walk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(accel_walk.LAUNCHES)
        check_launches(dense.LAUNCHES, dict.fromkeys(dense.LAUNCHES, 0),
                       what)
        check_launches(counts, {k: expect.get(k, 0) for k in counts}, what)
        for k, n in counts.items():
            walk_launches[k] += n
        return out, counts

    t0 = time.perf_counter()
    phase25(run_walk, card, device, res, shapes)
    print(f"phase 25 walks; wall s {time.perf_counter() - t0:.1f}")

    # --- phase 26: subsurface, hair, fourier and ptex ---
    t0 = time.perf_counter()
    phase26(run_path, card, device, res)
    print(f"phase 26 materials; wall s {time.perf_counter() - t0:.1f}")

    # --- phase 27: lighttracer, bdpt, sppm and mlt ---
    t0 = time.perf_counter()
    g1_launches = phase27(run_path, card, device, res)
    g1 = phase27_gather(device, card)
    print(f"phase 27 light-side integrators; wall s "
          f"{time.perf_counter() - t0:.1f}")

    # --- phase 28: checkpoint, the CLI's stats, ranks, bsdftest ---
    t0 = time.perf_counter()
    phase28(run_path, card, device, scene, camera, cfg)
    print(f"phase 28 last modules; wall s {time.perf_counter() - t0:.1f}")

    rows = []
    for k, (src, rep) in KERNELS.items():
        r = res[k]
        # the cull alone runs on no render path: its launches are the
        # harnesses' (phase 10), as the harness rows' are
        row = {"name": k, "route": "cuda", "source": src, "replaces": rep,
               "launches": (harness["counts"][k] if k == "dense_queue_cull"
                            else launches[k]),
               "max_abs_err": max(v["max_abs_err"] for v in r.values()),
               "ms": r["bounce1"]["ms"],
               "device_ms": _ms(r["bounce1"]["device"]),
               "plain_ms": r["bounce1"]["plain_ms"],
               "bound_ms": r["bounce1"]["bound"][0],
               "bound_by": r["bounce1"]["bound"][1], "library_ms": None,
               "ms_camera": r["camera"]["ms"],
               "device_ms_camera": _ms(r["camera"]["device"]),
               "plain_ms_camera": r["camera"]["plain_ms"],
               "bound_ms_camera": r["camera"]["bound"][0],
               "kernels_per_call": (r["bounce1"]["device"] or (0, None))[1]}
        if k in ("dense_queue", "dense_queue_cull"):
            m = res[k + "_motion"]
            row.update(ms_motion_bounce1=m["bounce1"]["ms"],
                       ms_motion_camera=m["camera"]["ms"],
                       device_ms_motion_bounce1=_ms(m["bounce1"]["device"]),
                       device_ms_motion_camera=_ms(m["camera"]["device"]))
        if k == "dense_queue_cull":
            row["launches_main_paths"] = launches[k]
        if k in init_launches:
            sc = scene if k == "dense_loop" else mjob.scene
            row.update(
                slice_len=dense.LOOP_SLICE,
                blocks_per_tile=dense.loop_blocks(sc.dense_w.shape[0]),
                stages=1,
                launches_init=init_launches[k],
                tests_static_moving_bounce1=r["bounce1"]["tests"],
                tests_static_moving_camera=r["camera"]["tests"])
        # the matched-RNG pass's batches (phase 11), the lights pass's
        # (phase 20), the shadow walks' of smoke_glass, volpath_bench and
        # the shell scene (phase 22)
        for b in ("refpath_camera", "refpath_bounce1", "lights_camera",
                  "lights_bounce1", "volpath_walk1", "volpath_walk2",
                  "volpath_bench_walk1", "volpath_shells_walk2",
                  "volpath_shells_walk5", "volpath_shells_walk8",
                  "shapes_camera", "shapes_bounce1", "shapes_bitonic",
                  "skin_probe_b0_p0", "skin_probe_b0_p3",
                  "skin_probe_b1_p0", "skin_probe_b1_p3",
                  "bdpt_light", "bdpt_s2t2", "bdpt_t1", "sppm_photon"):
            if b in r:
                row.update({f"ms_{b}": r[b]["ms"],
                            f"device_ms_{b}": _ms(r[b]["device"]),
                            f"plain_ms_{b}": r[b]["plain_ms"],
                            f"bound_ms_{b}": r[b]["bound"][0]})
                if "active" in r[b]:
                    row[f"active_per_tile_{b}"] = r[b]["active"]
        if "active" in r["bounce1"]:
            row.update(active_per_tile_camera=r["camera"]["active"],
                       active_per_tile_bounce1=r["bounce1"]["active"])
        if k in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[k]
        row["launches_harnesses"] = harness["counts"][k]
        rows.append(row)
    rows += harness["rows"]
    rows += walk_rows(res, walk_launches)
    # G1: its launches are phase 27a's SPPM render's, its times phase 27e's
    rows.append(dict(
        {"name": "sppm_gather", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": GATHER_REPLACES, "launches": g1_launches,
         "bound_by": "operations", "library_ms": None}, **g1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
