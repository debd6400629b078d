"""The plain reference against a tiny render of the program on the CPU,
and what the reference may read and import."""

from __future__ import annotations

import ast
import glob
import os

import pytest
import torch

from benchmark import run
from benchmark.reference import compare, sampler
from benchmark.reference import scene as rscene

SCENES = {"path": "benchmark/scenes/cornell_bench.pbrt",
          "volpath": "benchmark/tests/data/smoke_glass.pbrt"}


def port_film(scene_file, W, spp, seed):
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.integrators import dispatch
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli

    job = parse_scene(os.path.join(run.ROOT, scene_file), device="cpu")
    film = filmmod.make_film(W, W, job.filter_name, device="cpu")
    dispatch.render_with_integrator(
        job, cli.build_camera(job, W, W, "cpu"), film,
        SamplerConfig(job.sampler_kind, seed, spp), spp,
        job.integrator_params["maxdepth"], max_rays_per_pass=W * W)
    return film


@pytest.mark.parametrize("integrator", ("path", "volpath"))
def test_reference_matches_a_tiny_render(integrator):
    W, spp, seed = 12, 2, 3_000_000_019
    film = port_film(SCENES[integrator], W, spp, seed)
    pixels = torch.arange(W * W)
    sc = rscene.parse(os.path.join(run.ROOT, SCENES[integrator]))
    ref, weight = compare.reference_film(
        sc, pixels, [compare.sample_counts(spp, W * W, W, W)], [seed], W, W,
        torch.device("cpu"), torch.float32, integrator)
    gap, share, mean = compare.render_numbers(
        film.raw.reshape(-1, 31), film.weight.reshape(-1), ref, weight)
    assert gap == 0.0
    assert share <= 0.02 and mean < 1e-3
    assert float(ref.sum()) > 0


def test_sampler_equals_the_programs_bit_for_bit():
    from pbrt_tpu_torch.core import rng
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig, sample_dim

    pix = torch.arange(0, 4096, 37)
    idx = torch.arange(pix.shape[0]) % 70
    for seed in (0, 2 ** 31 + 5, 4_000_000_019):
        cfg = SamplerConfig("sobol", seed, 16)
        for dim in (0, 1, 5, 17, 53, 1030):
            assert torch.equal(sampler.sample(pix, idx, dim, seed),
                               sample_dim(cfg, pix, idx, dim))
        assert torch.equal(sampler.uniform(pix, idx, 0x9008 + seed % 97),
                           rng.uniform_float(pix, idx, 0x9008 + seed % 97))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(run.BENCH_DIR, "reference", "*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("pbrt_tpu_torch", "pbrt_tpu", "jax",
                               "jaxlib", "flax"), (f, name)


def test_nothing_reads_the_jax_benchmark_or_the_archives():
    me = os.path.abspath(__file__)
    for f in glob.glob(os.path.join(run.BENCH_DIR, "**", "*.py"),
                       recursive=True):
        if os.path.abspath(f) == me or "_cache" in f:
            continue
        text = open(f).read()
        for word in ("bench.py", "_final", "_archive", "BENCH_r",
                     "MULTICHIP_r"):
            assert word not in text, (f, word)
