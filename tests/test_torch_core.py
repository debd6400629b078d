"""pbrt_tpu_torch core leaves against pbrt_tpu on the same inputs (CPU).

Tolerances: the counter-based RNG, the Owen scramble and the Sobol'
sampler are integer hashes and must be bit-exact; spectra and transforms
are f32/f64 host math and agree within 1e-6.
"""
import os
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
    with pytest.raises(NotImplementedError):
        tsamp.sample_dim(tsamp.SamplerConfig("halton", 0, 4),
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
