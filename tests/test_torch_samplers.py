"""The port's samplers, low-discrepancy sequences, RNG floats and pixel
filters against pbrt_tpu's on the same inputs (CPU), and the parser's
Sampler and PixelFilter kinds.

Tolerances:
- the RNG words and floats, value_at_wavelength, the radical inverses
  (Halton, all 20 digits), the (0,2)-sequence, the generator matrices
  and every sampler kind on dims 0-12 over 512 (pixel, sample) pairs:
  bit for bit.  XLA on the CPU flushes subnormal f32 and torch does
  not; the port flushes the Halton digit factors the same way, and the
  terms below f32's normal range lie far below the ulp of the sum, so
  the Halton samples are bit for bit too (0 ulp measured);
- the filter tables: bit for bit (the same f64 numpy, cast to f32);
- `add_samples` with each new filter: within 1e-5 relative / 1e-6
  absolute (f32 sums in another scatter order), as
  test_torch_path.py::test_film_splat_matches_jax;
- the parser: job fields equal.
"""
import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import lds as jlds
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu_torch.core import lds as tlds
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.core import spectrum as tspec
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers import samplers as tsamp
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"


def _u32(seed, n):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:8] = [0, 1, 2, 3, 7, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _bits_equal(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    return np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_uniform_floats_bit_exact():
    a, b = _u32(1, 2048), _u32(2, 2048)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(np.asarray(jrng.uniform_u32(ja, jb)),
                          trng.uniform_u32(_t(a), _t(b)).numpy())
    assert _bits_equal(jrng.uniform_float(ja, jnp.uint32(977), jb),
                       trng.uniform_float(_t(a), 977, _t(b)))
    for r, g in zip(jrng.uniform_float2(ja, jb),
                    trng.uniform_float2(_t(a), _t(b))):
        assert _bits_equal(r, g)


def test_value_at_wavelength_bit_exact():
    rs = np.random.RandomState(3)
    s = rs.rand(31).astype(np.float32)
    lam = (rs.rand(1024) * 400 + 350).astype(np.float32)
    # the clamps and the bin centres themselves
    lam[:6] = [350.0, 395.0, 400.0, 550.0, 700.0, 705.0]
    lam[6:37] = tspec.BIN_CENTERS
    assert _bits_equal(
        jspec.value_at_wavelength(jnp.asarray(s), jnp.asarray(lam)),
        tspec.value_at_wavelength(torch.from_numpy(s),
                                  torch.from_numpy(lam)))


def test_primes_and_maxmin_tables_equal():
    assert np.array_equal(tlds.PRIMES, jlds.PRIMES)
    for log2 in range(-1, 18):
        assert np.array_equal(tlds.maxmin_matrix(log2),
                              jlds.maxmin_matrix(log2))


@pytest.mark.parametrize("base", [2, 3, 5, 1619, 8161])
def test_radical_inverse_bit_exact(base):
    idx, seed = _u32(4, 2048), _u32(5, 2048)
    assert _bits_equal(jlds.radical_inverse(jnp.asarray(idx), base),
                       tlds.radical_inverse(_t(idx), base))
    assert _bits_equal(
        jlds.radical_inverse(jnp.asarray(idx), base,
                             perm_seed=jnp.asarray(seed)),
        tlds.radical_inverse(_t(idx), base, perm_seed=_t(seed)))


def test_halton_and_base2_bit_exact():
    idx, seed = _u32(6, 2048), _u32(7, 2048)
    assert _bits_equal(jlds.radical_inverse_base2(jnp.asarray(idx)),
                       tlds.radical_inverse_base2(_t(idx)))
    for dim in (0, 1, 2, 7, 100, 255):
        assert _bits_equal(jlds.halton_sample(jnp.asarray(idx), dim),
                           tlds.halton_sample(_t(idx), dim)), dim
        assert _bits_equal(
            jlds.halton_sample(jnp.asarray(idx), dim,
                               perm_seed=jnp.asarray(seed)),
            tlds.halton_sample(_t(idx), dim, perm_seed=_t(seed))), dim


def test_generator_matrix_and_02_bit_exact():
    idx, sx, sy = _u32(8, 2048), _u32(9, 2048), _u32(10, 2048)
    for log2 in (0, 1, 3, 5, 16):
        m = jlds.maxmin_matrix(log2)
        assert _bits_equal(jlds.generator_matrix_sample(jnp.asarray(idx), m),
                           tlds.generator_matrix_sample(_t(idx), m))
        assert _bits_equal(
            jlds.generator_matrix_sample(jnp.asarray(idx), m,
                                         scramble=jnp.asarray(sx)),
            tlds.generator_matrix_sample(_t(idx), m, scramble=_t(sx)))
    for r, g in zip(jlds.sample_02(jnp.asarray(idx), jnp.asarray(sx),
                                   jnp.asarray(sy)),
                    tlds.sample_02(_t(idx), _t(sx), _t(sy))):
        assert _bits_equal(r, g)


@pytest.mark.parametrize("kind", jsamp.SAMPLER_TYPES)
def test_sampler_bit_exact(kind):
    """Every kind on dims 0-12 over 512 (pixel, sample) pairs, at 1, 8
    (a power of 2) and 6 samples per pixel and two seeds."""
    assert tsamp.SAMPLER_TYPES == jsamp.SAMPLER_TYPES
    rs = np.random.RandomState(11)
    pid = rs.randint(0, 1 << 16, 512).astype(np.uint32)
    sidx = rs.randint(0, 64, 512).astype(np.uint32)
    for seed, spp in ((0, 1), (3, 8), (3, 6)):
        jcfg = jsamp.SamplerConfig(kind, seed, spp)
        tcfg = tsamp.SamplerConfig(kind, seed, spp)
        for dim in range(13):
            ref = jsamp.sample_dim(jcfg, jnp.asarray(pid), jnp.asarray(sidx),
                                   dim)
            got = tsamp.sample_dim(tcfg, _t(pid), _t(sidx), dim)
            assert _bits_equal(ref, got), (seed, spp, dim)
            assert (got >= 0).all() and (got < 1).all()


# ---------------------------------------------------------------------------
# pixel filters
# ---------------------------------------------------------------------------

FILTERS = [("box", {}), ("triangle", {}), ("gaussian", {"alpha": 3.0}),
           ("mitchell", {}), ("mitchell", {"B": 0.5, "C": 0.25}),
           ("sinc", {}), ("sinc", {"tau": 2.0})]


@pytest.mark.parametrize("name,params", FILTERS,
                         ids=[f"{n}{p}" for n, p in FILTERS])
def test_filter_table_bit_exact(name, params):
    jf = jfilm.make_film(8, 6, name, **params)
    tf = tfilm.make_film(8, 6, name, device=DEV, **params)
    assert _bits_equal(jf.filter_table, tf.filter_table)
    assert tuple(np.asarray(jf.radius)) == tf.radius
    assert jf.footprint == tf.footprint
    # the reference's default radii: box 0.5, sinc 4, the others 2
    assert tf.footprint == {"box": 1, "sinc": 8}.get(name, 4)


@pytest.mark.parametrize("name", ["triangle", "mitchell", "sinc"])
def test_add_samples_matches_jax(name):
    """A batch splatted with each new filter; sinc's 8x8 footprint is 64
    index_put_ rounds."""
    W, H = 24, 20
    rs = np.random.RandomState(12)
    pf = (rs.rand(512, 2) * [W, H]).astype(np.float32)
    L = rs.rand(512, 31).astype(np.float32)
    w = rs.rand(512).astype(np.float32)
    jf = jfilm.add_samples(jfilm.make_film(W, H, name), jnp.asarray(pf),
                           jnp.asarray(L), jnp.asarray(w))
    tf = tfilm.add_samples(tfilm.make_film(W, H, name, device=DEV),
                           torch.from_numpy(pf), torch.from_numpy(L),
                           torch.from_numpy(w))
    for k in ("weighted", "weight", "raw"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfilm.develop_spectral(tf).numpy(),
                               np.asarray(jfilm.develop_spectral(jf)),
                               rtol=1e-4, atol=1e-5)


def test_unknown_filter_raises():
    with pytest.raises(ValueError, match="lanczos"):
        tfilm.make_film(4, 4, "lanczos", device=DEV)
    with pytest.raises(NotImplementedError, match="xwidth"):
        tfilm.make_film(4, 4, "box", device=DEV, xwidth=1.0)


# ---------------------------------------------------------------------------
# the parser's Sampler and PixelFilter
# ---------------------------------------------------------------------------

SCENE = """LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
{options}
WorldBegin
AreaLightSource "diffuse" "rgb L" [1 1 1]
Shape "trianglemesh" "point P" [-1 -1 0 1 -1 0 1 1 0] "integer indices" [0 1 2]
WorldEnd
"""


def _jobs(options):
    text = SCENE.format(options=options)
    return JAPI().parse_string(text), TAPI(DEV).parse_string(text)


@pytest.mark.parametrize("options,kind,spp", [
    ("", "halton", 16),
    ('Sampler "halton" "integer pixelsamples" [4]', "halton", 4),
    ('Sampler "random" "integer pixelsamples" [3]', "independent", 3),
    ('Sampler "independent"', "independent", 16),
    ('Sampler "stratified" "integer pixelsamples" [8]', "stratified", 8),
    ('Sampler "sobol"', "sobol", 16),
    ('Sampler "02sequence" "integer pixelsamples" [2]', "zerotwosequence",
     2),
    ('Sampler "lowdiscrepancy"', "zerotwosequence", 16),
    ('Sampler "zerotwosequence"', "zerotwosequence", 16),
    ('Sampler "maxmindist" "integer pixelsamples" [8]', "maxmindist", 8),
    ('Sampler "pmj02bn"', "halton", 16),
])
def test_parser_sampler_kinds_match_jax(options, kind, spp, caplog):
    """No Sampler line renders with halton; the aliases map as the JAX
    parser maps them, and an unknown kind falls back to halton with a
    warning."""
    with caplog.at_level(logging.WARNING):
        jj, tj = _jobs(options)
    assert (tj.sampler_kind, tj.spp) == (jj.sampler_kind, jj.spp) == \
        (kind, spp)
    assert ("unknown sampler" in caplog.text) == ("pmj02bn" in options)


@pytest.mark.parametrize("options", [
    'PixelFilter "triangle"',
    'PixelFilter "mitchell" "float B" [0.5] "float C" [0.25]',
    'PixelFilter "sinc" "float tau" [2] "float xwidth" [3] '
    '"float ywidth" [3]',
    'PixelFilter "gaussian" "float alpha" [3] "float B" [1]',
])
def test_parser_filters_match_jax(options):
    jj, tj = _jobs(options)
    assert tj.filter_name == jj.filter_name
    assert tj.filter_params == jj.filter_params
    fp = dict(tj.filter_params)
    radius = fp.pop("radius", None)
    jf = jfilm.make_film(8, 8, jj.filter_name, radius=radius, **fp)
    tf = tfilm.make_film(8, 8, tj.filter_name, radius=radius, device=DEV,
                         **fp)
    assert _bits_equal(jf.filter_table, tf.filter_table)
