"""The port's textures (Perlin noise, every texture kind on the finest,
cone and EWA branches, pyramids, the texture table) and image readers
(PNG, TGA, EXR with every compression, PFM) against pbrt_tpu on the
same inputs (CPU).

Tolerances: the host-side pyramid, resampling and table code is the same
numpy and is held equal; Perlin noise and the procedural kinds, the same
f32 formulas, to 1e-5 relative (1e-6 absolute); image lookups, the same
texel weights, to 1e-5.  The readers are held equal to pbrt_tpu's, which
reads PNG and TGA through PIL: the port's own decoders give what PIL's
`convert("RGB")` gives, 16-bit grey clipped to 255 and 16-bit colour by
its high byte included.
"""
import os
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pbrt_tpu.film import io as jio
from pbrt_tpu.textures import textures as jtex
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.native import build as native_build
from pbrt_tpu_torch.native.build import exr_headers_present
from pbrt_tpu_torch.textures import textures as ttex
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

N = 4096
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
KINDS = ("image", "checkerboard", "uv", "dots", "fbm", "marble", "windy",
         "wrinkled")


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a.numpy() if torch.is_tensor(a) else a,
                               np.asarray(b), rtol=rtol, atol=atol)


def test_perlin_fbm_turbulence_match_jax():
    rs = np.random.RandomState(91)
    p = rs.uniform(-300, 300, (N, 3)).astype(np.float32)
    p[:64] = np.floor(p[:64])                 # lattice points
    for name in ("perlin", "fbm", "turbulence"):
        _close(getattr(ttex, name)(torch.from_numpy(p)),
               getattr(jtex, name)(jnp.asarray(p)))
    v = ttex.perlin(torch.from_numpy(p)).numpy()
    assert np.abs(v).max() <= 1.5 and v.std() > 0.1


def _table(mod):
    t = mod.TextureTable()
    img = np.random.RandomState(92).rand(40, 30, 3).astype(np.float32)
    t.add(mod.TEX_IMAGE, image=img, uscale=2.0, vscale=-1.5, udelta=0.25)
    t.add(mod.TEX_CHECKER, uscale=4.0, vscale=3.0, vdelta=0.5,
          c1=(0.9, 0.1, 0.1), c2=(0.1, 0.2, 0.8))
    t.add(mod.TEX_UV, uscale=1.5, vscale=2.5)
    t.add(mod.TEX_DOTS, uscale=3.0, vscale=3.0, c1=(1, 1, 0),
          c2=(0, 0, 0.5))
    for k in (mod.TEX_FBM, mod.TEX_MARBLE, mod.TEX_WINDY, mod.TEX_WRINKLED):
        t.add(k, wscale=2.5)
    return t


def test_pyramid_resize_and_table_equal_jax():
    rs = np.random.RandomState(93)
    for shape in ((256, 256, 3), (37, 91, 3), (300, 200), (8, 8, 3)):
        img = rs.rand(*shape).astype(np.float32) * 4.0     # HDR
        a = ttex._resize_bilinear(img, 256, 256)
        b = jtex._resize_bilinear(img, 256, 256)
        assert a.dtype == b.dtype and np.array_equal(a, b), shape
        assert np.array_equal(ttex.build_pyramid(a), jtex.build_pyramid(b))
    for a, b in zip(_table(ttex).arrays(), _table(jtex).arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (ttex.RES, ttex.MAX_LEVEL, ttex.MAX_ANISO, ttex.EWA_TAPS) == (
        jtex.RES, jtex.MAX_LEVEL, jtex.MAX_ANISO, jtex.EWA_TAPS)


@pytest.fixture(scope="module")
def lookups():
    arrs = _table(ttex).arrays()
    rs = np.random.RandomState(94)
    T = arrs[1].shape[0]
    idx = rs.randint(-1, T, N).astype(np.int32)
    uv = rs.uniform(-2, 3, (N, 2)).astype(np.float32)
    p = rs.uniform(-3, 6, (N, 3)).astype(np.float32)
    uv_w = np.exp(rs.uniform(-9, 0, N)).astype(np.float32)
    duv = (rs.randn(N, 4) * np.exp(rs.uniform(-8, -1, (N, 1)))).astype(
        np.float32)
    duv[::5] = 0.0                       # lanes without differentials
    return arrs, idx, uv, p, uv_w, duv


@pytest.mark.parametrize("branch", ["finest", "cone", "ewa"])
def test_eval_texture_matches_jax(lookups, branch):
    arrs, idx, uv, p, uv_w, duv = lookups
    kw = {"finest": {}, "cone": dict(uv_width=uv_w),
          "ewa": dict(uv_width=uv_w, duv=duv)}[branch]
    kinds = tuple(sorted(set(arrs[1][1:].tolist())))
    got = ttex.eval_texture(*(torch.from_numpy(a) for a in arrs),
                            torch.from_numpy(idx), torch.from_numpy(uv),
                            torch.from_numpy(p), kinds=kinds,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jtex.eval_texture(*(jnp.asarray(a) for a in arrs),
                             jnp.asarray(idx), jnp.asarray(uv),
                             jnp.asarray(p), kinds=kinds,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(got, want)
    got = got.numpy()
    assert np.array_equal(got[idx < 0], np.ones(((idx < 0).sum(), 3)))
    # every kind is looked up, and its lanes vary
    for t, name in enumerate(KINDS, start=1):
        assert got[idx == t].std() > 0.01, name
    if branch == "ewa":
        # the cone fallback on lanes without differentials, EWA elsewhere
        cone = jtex.eval_texture(*(jnp.asarray(a) for a in arrs),
                                 jnp.asarray(idx), jnp.asarray(uv),
                                 jnp.asarray(p), kinds=(jtex.TEX_IMAGE,),
                                 uv_width=jnp.asarray(uv_w))
        img = idx == 1
        zero = (duv == 0).all(-1)
        _close(got[img & zero], np.asarray(cone)[img & zero])
        assert np.abs(got[img & ~zero]
                      - np.asarray(cone)[img & ~zero]).max() > 1e-3


def test_absent_kinds_launch_nothing(lookups):
    """kinds=() returns 1 without evaluating any family; an image-only
    table never evaluates the noise families."""
    arrs, idx, uv, p, *_ = lookups
    t = [torch.from_numpy(a) for a in arrs]
    ones = ttex.eval_texture(*t, torch.from_numpy(idx), torch.from_numpy(uv),
                             torch.from_numpy(p), kinds=())
    assert torch.equal(ones, torch.ones_like(ones))
    img = ttex.eval_texture(*t, torch.from_numpy(idx), torch.from_numpy(uv),
                            torch.from_numpy(p), kinds=(ttex.TEX_IMAGE,))
    full = ttex.eval_texture(*t, torch.from_numpy(idx), torch.from_numpy(uv),
                             torch.from_numpy(p))
    sel = idx == 1
    assert torch.equal(img[sel], full[sel])


# ----------------------------------------------------------------- readers

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, px, ctype):
    """A PNG of px [H,W,C] (uint8 or uint16) with filter type y % 5 on row
    y, so the decoder meets all five."""
    h, w = px.shape[:2]
    depth = 16 if px.dtype == np.uint16 else 8
    raw = (px.astype(">u2") if depth == 16 else px).reshape(h, -1)
    raw = np.frombuffer(raw.tobytes(), np.uint8).reshape(h, -1).astype(
        np.int64)
    bpp = px.shape[2] * depth // 8
    rows = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = y % 5
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][f]
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (4, 8), (6, 8),
                                         (0, 16), (2, 16), (4, 16),
                                         (6, 16)])
def test_png_reader_matches_jax(tmp_path, ctype, depth):
    rs = np.random.RandomState(95 + ctype + depth)
    chans = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    hi = 256 if depth == 8 else 65536
    px = rs.randint(0, hi, (13, 17, chans)).astype(
        np.uint8 if depth == 8 else np.uint16)
    if depth == 16 and ctype == 0:
        px[::2] = rs.randint(0, 300, px[::2].shape)      # around 255
    path = str(tmp_path / "t.png")
    _write_png(path, px, ctype)
    got = tio.read_image(path)
    want = jio.read_image(path)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_png_and_tga_written_by_pil_match_jax(tmp_path):
    rs = np.random.RandomState(96)
    rgba = rs.randint(0, 256, (21, 19, 4)).astype(np.uint8)
    cases = [("rgb.png", Image.fromarray(rgba[..., :3]), {}),
             ("rgba.png", Image.fromarray(rgba), {}),
             ("grey.png", Image.fromarray(rgba[..., 0]), {}),
             ("rgb.tga", Image.fromarray(rgba[..., :3]), {}),
             ("rgba.tga", Image.fromarray(rgba), {}),
             ("rle.tga", Image.fromarray(rgba[..., :3]),
              dict(compression="tga_rle")),
             ("rlea.tga", Image.fromarray(rgba),
              dict(compression="tga_rle"))]
    for name, im, kw in cases:
        path = str(tmp_path / name)
        im.save(path, **kw)
        got, want = tio.read_image(path), jio.read_image(path)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    # a uniform image: every TGA run is a repeat packet
    path = str(tmp_path / "flat.tga")
    Image.fromarray(np.full((9, 40, 3), 77, np.uint8)).save(
        path, compression="tga_rle")
    assert np.array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_written_by_port_read_by_both(tmp_path, compression):
    rs = np.random.RandomState(97)
    img = (rs.randn(37, 23, 3) * 10).astype(np.float32)
    img[5:20] = 1.0                  # runs that deflate shrinks
    path = str(tmp_path / "x.exr")
    tio.write_exr(path, img, compression=compression)
    for read in (tio.read_exr, jio.read_exr, tio.read_image):
        assert np.array_equal(read(path), img)
    if compression == "none":
        jio.write_exr(str(tmp_path / "j.exr"), img)
        assert open(path, "rb").read() == open(tmp_path / "j.exr",
                                               "rb").read()
    pfm = str(tmp_path / "x.pfm")
    jio.write_pfm(pfm, img)
    assert np.array_equal(tio.read_image(pfm), jio.read_image(pfm))


def test_unported_formats_raise(tmp_path):
    """.jpg and palette PNGs raise.  The PIZ, PXR24 and B44 files, which
    raised before the port read them through OpenEXR, read equal to
    pbrt_tpu's native reader (half data: exact)."""
    path = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(NotImplementedError, match="jpg"):
        tio.read_image(path)
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(path)
    with pytest.raises(NotImplementedError, match="colour type 3"):
        tio.read_image(path)
    if not exr_headers_present():
        pytest.skip("the OpenEXR headers are missing: PIZ, PXR24 and B44 "
                    "need the OpenEXR library")
    for name in ("exr_piz.exr", "exr_pxr24.exr", "exr_b44.exr"):
        path = os.path.join(DATA, name)
        img = tio.read_image(path)
        assert img.dtype == np.float32 and img.shape == (23, 37, 3)
        assert np.array_equal(img, jio.read_image(path)), name
        assert np.array_equal(tio.read_exr(path), img), name


def test_exr_without_openexr_raises_naming_it(monkeypatch):
    """Without OpenEXR's headers a PIZ file raises naming its compression
    and the missing library, in place of pbrt_tpu's silent failure."""
    monkeypatch.setattr(native_build, "EXR_INCLUDE",
                        ("/nonexistent/OpenEXR", "/nonexistent/Imath"))
    with pytest.raises(NotImplementedError, match="PIZ.*OpenEXR"):
        tio.read_image(os.path.join(DATA, "exr_piz.exr"))
