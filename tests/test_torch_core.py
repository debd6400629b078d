"""pbrt_tpu_torch core leaves against pbrt_tpu on the same inputs (CPU).

Tolerances: the counter-based RNG, the Owen scramble and the Sobol'
sampler are integer hashes and must be bit-exact; spectra and transforms
are f32/f64 host math and agree within 1e-6.
"""
import glob
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.core import spectrum as tspec
from pbrt_tpu_torch.core import transform as ttfm
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.samplers import samplers as tsamp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run torch on one intra-op thread (imported by
    every test_torch_* file).  Their tensors are small, and with several
    test workers on the machine a multi-threaded op waits for threads
    that the other workers' processes have descheduled, which made the
    port's tests several times slower under six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32's unit roundoff
U32 = 2.0 ** -24


def tensors_equal(x, y):
    """Equal values, or, for f32, equal bits: the BVH's packed rows hold
    int bits, NaN patterns among them, which torch.equal calls unequal."""
    return torch.equal(x, y) or (
        x.dtype == y.dtype == torch.float32
        and torch.equal(x.view(torch.int32), y.view(torch.int32)))


def rounding_bound(fn, sites, ulps, h=1e-7):
    """An f64 evaluation of an f32 formula and a per-element bound on how
    far an f32 evaluation of it may lie from that value.

    fn(pert) evaluates the formula in float64, scaling each named
    intermediate x by (1 + pert.get(name, 0)); `sites` names the
    intermediates whose f32 rounding the result is sensitive to (where a
    difference cancels, a steep function is applied, or a Newton solve
    stops).  The bound is `ulps` f32 roundings of each site, carried to
    the result by its f64 derivative (a forward difference of step h),
    plus `ulps` roundings of the result itself.  Returns (value, bound)."""
    base = fn({})
    sens = ulps * U32 * np.abs(base)
    for site in sites:
        sens = sens + ulps * U32 * np.abs(fn({site: h}) - base) / h
    return base, sens


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u32(seed, n):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # include the top of the range: padded pixel ids sit at 2^32 - 1
    x[:16] = np.arange(2 ** 32 - 16, 2 ** 32, dtype=np.uint64)
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_pcg_hash_bit_exact():
    x = _u32(0, 4096)
    assert np.array_equal(np.asarray(jrng.pcg_hash(jnp.asarray(x))),
                          trng.pcg_hash(_t(x)).numpy())


def test_hash_combine_bit_exact():
    a, b = _u32(1, 2048), _u32(2, 2048)
    ref = np.asarray(jrng.hash_combine(jnp.asarray(a), jnp.uint32(37),
                                       jnp.asarray(b)))
    assert np.array_equal(ref, trng.hash_combine(_t(a), 37, _t(b)).numpy())


def test_owen_scramble_bit_exact():
    """The Laine-Karras constants above 2^31 overflow a plain int64
    product; the port forms the low 32 bits from 16-bit halves."""
    x, seed = _u32(3, 4096), _u32(4, 4096)
    ref = np.asarray(jrng.owen_scramble(jnp.asarray(x), jnp.asarray(seed)))
    assert np.array_equal(ref, trng.owen_scramble(_t(x), _t(seed)).numpy())


@pytest.mark.parametrize("seed", [0, 7])
def test_sobol_sample_dim_bit_exact(seed):
    """A pixel x sample x dim grid, pixel ids up to 2^32 - 1."""
    pid = np.repeat(_u32(5, 64), 32)
    sidx = np.tile(np.arange(32, dtype=np.uint32) * 977, 64)
    jcfg = jsamp.SamplerConfig("sobol", seed, 32)
    tcfg = tsamp.SamplerConfig("sobol", seed, 32)
    for dim in (0, 1, 4, 5, 13, 49, 1023, 1024, 1500):
        ref = np.asarray(jsamp.sample_dim(jcfg, jnp.asarray(pid),
                                          jnp.asarray(sidx), dim))
        got = tsamp.sample_dim(tcfg, _t(pid), _t(sidx), dim).numpy()
        assert ref.dtype == got.dtype == np.float32
        assert np.array_equal(ref.view(np.uint32), got.view(np.uint32)), dim


def test_unported_sampler_raises():
    """Every sampler kind of pbrt_tpu is ported (test_torch_samplers.py);
    a kind that is none of them raises as pbrt_tpu's sample_dim does."""
    with pytest.raises(ValueError, match="unknown sampler pmj02bn"):
        tsamp.sample_dim(tsamp.SamplerConfig("pmj02bn", 0, 4),
                         torch.zeros(4, dtype=torch.int64),
                         torch.zeros(4, dtype=torch.int64), 0)


@pytest.mark.parametrize("kind", ["reflectance", "illuminant", "display"])
def test_from_rgb_np(kind):
    rgb = np.random.RandomState(6).rand(64, 3)
    np.testing.assert_allclose(tspec.from_rgb_np(rgb, kind),
                               jspec.from_rgb_np(rgb, kind),
                               rtol=1e-6, atol=1e-6)


def test_to_rgb_and_luminance():
    s = np.random.RandomState(7).rand(128, 31).astype(np.float32)
    np.testing.assert_allclose(tspec.to_rgb(torch.from_numpy(s)).numpy(),
                               np.asarray(jspec.to_rgb(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tspec.luminance(torch.from_numpy(s)).numpy(),
        np.asarray(jspec.luminance(jnp.asarray(s))), rtol=1e-6, atol=1e-6)


def test_transforms():
    pairs = [
        (ttfm.look_at([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1]),
         jtfm.look_at([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1])),
        (ttfm.perspective(50.0, 1e-2, 1000.0),
         jtfm.perspective(50.0, 1e-2, 1000.0)),
        (ttfm.translate(1, 2, 3) * ttfm.scale(.5, 2, 3),
         jtfm.translate(1, 2, 3) * jtfm.scale(.5, 2, 3)),
    ]
    p = np.random.RandomState(8).randn(32, 3)
    for t, j in pairs:
        np.testing.assert_allclose(t.m, j.m, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.m_inv, j.m_inv, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.apply_point(p), j.apply_point(p),
                                   rtol=1e-6, atol=1e-6)
        m = torch.as_tensor(t.m, dtype=torch.float32)
        pf = torch.as_tensor(p, dtype=torch.float32)
        np.testing.assert_allclose(
            ttfm.xform_point(m, pf).numpy(),
            np.asarray(jtfm.xform_point(jnp.asarray(t.m, jnp.float32),
                                        jnp.asarray(pf.numpy()))),
            rtol=1e-5, atol=1e-5)


def test_frames():
    v = np.random.RandomState(9).randn(256, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tv = torch.from_numpy(v)
    for a, b in zip(tgeom.coordinate_system(tv),
                    jgeom.coordinate_system(jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    ss, ts = tgeom.coordinate_system(tv)
    w = torch.from_numpy(np.random.RandomState(10).randn(256, 3)
                         .astype(np.float32))
    loc = tgeom.world_to_frame(ss, ts, tv, w)
    np.testing.assert_allclose(tgeom.frame_to_world(ss, ts, tv, loc).numpy(),
                               w.numpy(), atol=1e-5)


# an import statement, or an import by name, of jax, flax or pbrt_tpu
# (pbrt_tpu_torch is not pbrt_tpu)
_REFERENCE_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|pbrt_tpu)(?![\w])"
    r"|(?:import_module|__import__)\(\s*['\"](?:jax|flax|pbrt_tpu)(?![\w])",
    re.M)


def test_port_sources_name_no_jax():
    """No line of pbrt_tpu_torch/ or chip_smoke.py imports jax, flax or
    pbrt_tpu, not even inside a function that importing the module never
    runs (which test_port_imports_no_jax cannot see)."""
    files = sorted(glob.glob(os.path.join(REPO, "pbrt_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            text = f.read()
        bad += [(os.path.relpath(path, REPO), m.group(0).strip())
                for m in _REFERENCE_IMPORT.finditer(text)]
    assert not bad, bad
    assert _REFERENCE_IMPORT.search("    from pbrt_tpu.core import lds")
    assert _REFERENCE_IMPORT.search("import jax.numpy as jnp")
    assert _REFERENCE_IMPORT.search("importlib.import_module('flax')")
    assert not _REFERENCE_IMPORT.search("from pbrt_tpu_torch.core import x")


def test_port_imports_no_jax():
    """Every module of pbrt_tpu_torch, and chip_smoke.py, import in a
    fresh interpreter without pulling in jax, flax or pbrt_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pbrt_tpu_torch\n"
        "for m in pkgutil.walk_packages(pbrt_tpu_torch.__path__,\n"
        "                               'pbrt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'pbrt_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('pbrt_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25
