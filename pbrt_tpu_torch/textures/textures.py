"""Texture evaluation (port of pbrt_tpu.textures.textures; reference:
src/core/texture.{h,cpp}, src/core/mipmap.h, src/textures/*).

Device representation: one RGB mip canvas a texture, stacked into
`tex_images` [T, 2*RES, RES, 3] (level 0 in rows [0, RES); level l >= 1,
of size RES >> l, at row offset 2*RES - (2*RES >> l)), and a typed
parameter table for the procedural families.  RGB is promoted to a
spectrum at the shading call site.  Constant, scale, mix and bilerp
textures are folded by the parser.

Image lookups: the finest level without a footprint; trilinear between
the two levels a ray-cone footprint selects (`uv_width`); and, with
first-hit ray differentials (`duv`), an EWA-style anisotropic filter of
EWA_TAPS trilinear taps along the footprint's major axis at the level of
its minor axis, falling back per lane to the cone where a lane has no
differentials.  A ptex texture is a per-face atlas (textures/ptex.py
bake_atlas): the hit's face index picks the tile, its uv the texel.
Texels are fetched by plain indexing (the JAX package's
one-hot fetch was the TPU's workaround for serial gathers).

Perlin noise hashes its lattice corners with pbrt_tpu's table-free
integer mix, not pbrt's permutation table: the same noise as the JAX
package, a different instance from the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.rng import mul32

TEX_IMAGE = 0
TEX_CHECKER = 1
TEX_UV = 2
TEX_DOTS = 3
TEX_FBM = 4
TEX_MARBLE = 5
TEX_WINDY = 6
TEX_WRINKLED = 7
TEX_PTEX = 8       # per-face atlas (textures/ptex.py bake_atlas)

RES = 256
MAX_LEVEL = 8                  # RES >> 8 == 1x1 top of the pyramid
MAX_ANISO = 8.0                # mipmap.h maxAnisotropy default
EWA_TAPS = 4                   # taps along the footprint's major axis

_ALL_TEX = (TEX_IMAGE, TEX_CHECKER, TEX_UV, TEX_DOTS, TEX_FBM,
            TEX_MARBLE, TEX_WINDY, TEX_WRINKLED, TEX_PTEX)


# ---------------------------------------------------------------------------
# Perlin noise (reference: core/texture.cpp Noise / FBm / Turbulence)
# ---------------------------------------------------------------------------

def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def perlin(p):
    """Perlin noise at [..., 3] points, ~[-1, 1]; corner gradients from
    pbrt_tpu's murmur-style hash (32-bit words in int64 tensors)."""
    fl = torch.floor(p)
    pi = fl.to(torch.int64) & 255
    pf = p - fl
    w = pf * pf * pf * (pf * (pf * 6 - 15) + 10)

    def hash3(dx, dy, dz):
        h = (mul32(pi[..., 0] + dx, 0x9E3779B1)
             ^ mul32(pi[..., 1] + dy, 0x85EBCA77)
             ^ mul32(pi[..., 2] + dz, 0xC2B2AE3D))
        h = h ^ (h >> 15)
        h = mul32(h, 0x27D4EB2F)
        return (h ^ (h >> 13)) & 255

    def g(dx, dy, dz):
        return _grad(hash3(dx, dy, dz), pf[..., 0] - dx, pf[..., 1] - dy,
                     pf[..., 2] - dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    x00 = lerp(w[..., 0], g(0, 0, 0), g(1, 0, 0))
    x10 = lerp(w[..., 0], g(0, 1, 0), g(1, 1, 0))
    x01 = lerp(w[..., 0], g(0, 0, 1), g(1, 0, 1))
    x11 = lerp(w[..., 0], g(0, 1, 1), g(1, 1, 1))
    y0 = lerp(w[..., 1], x00, x10)
    y1 = lerp(w[..., 1], x01, x11)
    return lerp(w[..., 2], y0, y1)


def fbm(p, octaves=6, omega=0.5):
    total = torch.zeros(p.shape[:-1], device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * perlin(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, octaves=6, omega=0.5):
    total = torch.zeros(p.shape[:-1], device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * torch.abs(perlin(p * lam))
        lam *= 1.99
        o *= omega
    return total


# ---------------------------------------------------------------------------
# device-side evaluation
# ---------------------------------------------------------------------------

def _bilinear_level(tex_images, ti, u, v, level):
    """Bilinear fetch at integer mip `level` [B] from the pyramid canvas
    (repeat wrap, imagemap.h's default)."""
    sz = RES >> level                                   # [B]
    off = torch.where(level == 0, 0, 2 * RES - ((2 * RES) >> level))
    fu = torch.remainder(u, 1.0) * (sz - 1)
    fv = torch.remainder(v, 1.0) * (sz - 1)
    iu0 = fu.to(torch.int64)
    iv0 = fv.to(torch.int64)
    iu1 = torch.minimum(iu0 + 1, sz - 1)
    iv1 = torch.minimum(iv0 + 1, sz - 1)
    du = (fu - iu0)[:, None]
    dv = (fv - iv0)[:, None]
    return ((tex_images[ti, off + iv0, iu0] * (1 - du)
             + tex_images[ti, off + iv0, iu1] * du) * (1 - dv)
            + (tex_images[ti, off + iv1, iu0] * (1 - du)
               + tex_images[ti, off + iv1, iu1] * du) * dv)


def _trilinear(tex_images, ti, u, v, lvl):
    """Blend of the two mip levels around the fractional level lvl [B]."""
    l0 = lvl.to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=MAX_LEVEL)
    fl = (lvl - l0)[:, None]
    return (_bilinear_level(tex_images, ti, u, v, l0) * (1 - fl)
            + _bilinear_level(tex_images, ti, u, v, l1) * fl)


def _cone_level(uv_width, us, vs):
    """The mip level of a uv-space footprint of diameter uv_width."""
    w = uv_width * torch.clamp(torch.maximum(torch.abs(us), torch.abs(vs)),
                               min=1e-12)
    return torch.clamp(torch.log2(torch.clamp(w * RES, min=1e-9)), 0.0,
                       float(MAX_LEVEL))


def eval_texture(tex_images, tex_type, tex_params, tex_c1, tex_c2,
                 tex_idx, uv, p_world, uv_width=None, kinds=None, duv=None,
                 face=None):
    """Texture tex_idx [B] at uv [B,2] / world point [B,3] -> RGB [B,3]
    (1 where tex_idx < 0: the caller keeps its constant).

    uv_width: optional [B] uv-space footprint diameter, which selects the
    mip level (None: the finest level, the reference's lookup without
    differentials).  duv: optional [B,4] first-hit uv derivatives
    (dudx, dvdx, dudy, dvdy), which select the EWA filter.  kinds: the
    static tuple of TEX_* families the scene binds (SceneData.tex_kinds);
    an absent family launches nothing (None: every family)."""
    B = uv.shape[0]
    dev = uv.device
    present = set(_ALL_TEX) if kinds is None else set(kinds)
    ti = torch.clamp(tex_idx, 0, tex_type.shape[0] - 1).long()
    tt, pr = tex_type[ti], tex_params[ti]
    us, vs = pr[:, 0], pr[:, 1]
    u = uv[:, 0] * us + pr[:, 2]
    v = uv[:, 1] * vs + pr[:, 3]

    cases = []       # (mask, value) of each present family
    if TEX_IMAGE in present:
        if duv is not None:
            # EWA-style filtering (mipmap.h:103): level from the minor
            # axis, EWA_TAPS Gaussian-weighted trilinear taps along the
            # major axis, eccentricity clamped to MAX_ANISO; duv is in raw
            # uv, scaled here by uscale / vscale
            sc = torch.stack([us, vs], -1)
            dst0, dst1 = duv[:, 0:2] * sc, duv[:, 2:4] * sc
            n0 = (dst0 * dst0).sum(-1)
            n1 = (dst1 * dst1).sum(-1)
            major_v = torch.where((n1 > n0)[:, None], dst1, dst0)
            major = torch.sqrt(torch.clamp(torch.maximum(n0, n1),
                                           min=1e-24))
            minor = torch.sqrt(torch.clamp(torch.minimum(n0, n1),
                                           min=1e-24))
            minor = torch.maximum(minor, major / MAX_ANISO)
            lvl = torch.clamp(float(MAX_LEVEL) + torch.log2(minor), 0.0,
                              float(MAX_LEVEL))
            acc = 0.0
            wsum = 0.0
            for i in range(EWA_TAPS):
                a = (i + 0.5) / EWA_TAPS - 0.5
                wt = float(np.exp(-2.0 * (2.0 * a) ** 2))
                acc = acc + wt * _trilinear(tex_images, ti,
                                            u + a * major_v[:, 0],
                                            v + a * major_v[:, 1], lvl)
                wsum = wsum + wt
            c_img = acc / wsum
            # lanes without differentials (quadric hits, degenerate uv,
            # failed plane projections) carry duv == 0: the cone instead
            if uv_width is not None:
                no_duv = (duv == 0.0).all(-1)
                c_cone = _trilinear(tex_images, ti, u, v,
                                    _cone_level(uv_width, us, vs))
                c_img = torch.where(no_duv[:, None], c_cone, c_img)
        elif uv_width is None:
            c_img = _bilinear_level(tex_images, ti, u, v,
                                    torch.zeros(B, dtype=torch.int64,
                                                device=dev))
        else:
            c_img = _trilinear(tex_images, ti, u, v,
                               _cone_level(uv_width, us, vs))
        cases.append((tt == TEX_IMAGE, c_img))

    if TEX_PTEX in present and face is not None:
        # the face's tile of the atlas (params[5]: tiles a row, params[6]:
        # the tile's size), bilinear at the intra-face uv on level 0
        tpr = torch.clamp(pr[:, 5].to(torch.int64), min=1)
        tile = torch.clamp(pr[:, 6].to(torch.int64), min=1)
        fidx = torch.minimum(torch.clamp(face.long(), min=0), tpr * tpr - 1)
        br = (fidx // tpr) * tile
        bc = (fidx % tpr) * tile
        pu = torch.clamp(uv[:, 0], 0.0, 1.0) * (tile - 1)
        pv = torch.clamp(uv[:, 1], 0.0, 1.0) * (tile - 1)
        pu0 = pu.to(torch.int64)
        pv0 = pv.to(torch.int64)
        pu1 = torch.minimum(pu0 + 1, tile - 1)
        pv1 = torch.minimum(pv0 + 1, tile - 1)
        pdu = (pu - pu0)[:, None]
        pdv = (pv - pv0)[:, None]
        cases.append((tt == TEX_PTEX, (
            (tex_images[ti, br + pv0, bc + pu0] * (1 - pdu)
             + tex_images[ti, br + pv0, bc + pu1] * pdu) * (1 - pdv)
            + (tex_images[ti, br + pv1, bc + pu0] * (1 - pdu)
               + tex_images[ti, br + pv1, bc + pu1] * pdu) * pdv)))

    if TEX_CHECKER in present:
        # checkerboard (textures/checkerboard.cpp, closed form, no AA)
        check = torch.remainder(
            (torch.floor(u) + torch.floor(v)).to(torch.int32), 2) == 0
        cases.append((tt == TEX_CHECKER,
                      torch.where(check[:, None], tex_c1[ti], tex_c2[ti])))

    if TEX_UV in present:
        cases.append((tt == TEX_UV, torch.stack(
            [torch.remainder(u, 1.0), torch.remainder(v, 1.0),
             torch.zeros(B, device=dev)], -1)))

    if TEX_DOTS in present:
        # polka dots (textures/dots.cpp): a noise-chosen dot per cell
        cu, cv = torch.floor(u + 0.5), torch.floor(v + 0.5)
        zero = torch.zeros(B, device=dev)
        has_dot = perlin(torch.stack([cu + 0.5, cv + 0.5, zero], -1)) > 0
        cx = cu + 0.35 * perlin(torch.stack([cu, cv, zero + 1.5], -1))
        cy = cv + 0.35 * perlin(torch.stack([cu, cv, zero + 4.5], -1))
        inside = ((u - cx) ** 2 + (v - cy) ** 2) < 0.35 ** 2
        cases.append((tt == TEX_DOTS, torch.where(
            (has_dot & inside)[:, None], tex_c1[ti], tex_c2[ti])))

    if present & {TEX_FBM, TEX_MARBLE, TEX_WINDY, TEX_WRINKLED}:
        # the noise families, over the world position
        pw = p_world * pr[:, 4:5] + pr[:, 5:6]
    if TEX_FBM in present:
        cases.append((tt == TEX_FBM, torch.clamp(
            0.5 + 0.5 * fbm(pw), 0.0, 1.0)[:, None].expand(B, 3)))
    if TEX_MARBLE in present:
        # marble (texture.cpp MarbleTexture): sin over an fbm-bent axis
        marb = torch.sin(pw[:, 1] * 4.0 + 10.0 * fbm(pw, 3))[:, None]
        cases.append((tt == TEX_MARBLE, (0.6 + 0.4 * marb) * torch.tensor(
            [[0.9, 0.85, 0.8]], device=dev)))
    if TEX_WINDY in present:
        cases.append((tt == TEX_WINDY, (torch.abs(fbm(pw * 0.1, 3))
                                        * turbulence(pw, 6))[:, None]
                      .expand(B, 3)))
    if TEX_WRINKLED in present:
        cases.append((tt == TEX_WRINKLED, torch.clamp(
            turbulence(pw), 0.0, 1.0)[:, None].expand(B, 3)))

    if not cases:
        return torch.ones((B, 3), device=dev)
    out = cases[0][1]
    for mask, val in cases[1:]:
        out = torch.where(mask[:, None], val, out)
    return torch.where((tex_idx >= 0)[:, None], out, 1.0)


# ---------------------------------------------------------------------------
# host side: resampling, pyramids, the table the parser fills
# ---------------------------------------------------------------------------

def _resize_bilinear(img, h, w):
    """HDR-preserving float bilinear resample to h x w (grey replicated
    to RGB)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    ys = (np.arange(h, dtype=np.float32) + 0.5) * ih / h - 0.5
    xs = (np.arange(w, dtype=np.float32) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, iw - 1)
    y1, x1 = np.minimum(y0 + 1, ih - 1), np.minimum(x0 + 1, iw - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def build_pyramid(img):
    """[RES,RES,3] -> [2*RES,RES,3] mip canvas (2x2 box filter a level,
    the reference's power-of-two pyramid, mipmap.h:77)."""
    canvas = np.zeros((2 * RES, RES, 3), np.float32)
    canvas[:RES, :RES] = img
    prev = np.asarray(img, np.float32)
    for lvl in range(1, MAX_LEVEL + 1):
        prev = 0.25 * (prev[0::2, 0::2] + prev[1::2, 0::2]
                       + prev[0::2, 1::2] + prev[1::2, 1::2])
        off = 2 * RES - (2 * RES >> lvl)
        sz = RES >> lvl
        canvas[off:off + sz, :sz] = prev
    return canvas


class TextureTable:
    """Host-side texture registry the parser fills; entry 0 is a white
    image that no material references."""

    def __init__(self):
        self.images = [build_pyramid(np.ones((RES, RES, 3), np.float32))]
        self.types = [TEX_IMAGE]
        self.params = [np.zeros(8, np.float32)]
        self.c1 = [np.ones(3, np.float32)]
        self.c2 = [np.zeros(3, np.float32)]

    def add(self, ttype, image=None, uscale=1.0, vscale=1.0, udelta=0.0,
            vdelta=0.0, wscale=1.0, c1=(1, 1, 1), c2=(0, 0, 0),
            p5=0.0, p6=0.0):
        """Register a texture; image: a file name (film.io.read_image) or
        an [H,W,3] array.  Returns its index."""
        if image is not None:
            if isinstance(image, str):
                from pbrt_tpu_torch.film.io import read_image
                img = read_image(image)          # EXR/PFM linear, LDR ** 2.2
            else:
                img = np.asarray(image, np.float32)
            self.images.append(build_pyramid(_resize_bilinear(img, RES,
                                                              RES)))
        else:
            self.images.append(
                build_pyramid(np.ones((RES, RES, 3), np.float32)))
        self.types.append(ttype)
        self.params.append(np.asarray(
            [uscale, vscale, udelta, vdelta, wscale, p5, p6, 0],
            np.float32))
        self.c1.append(np.asarray(c1, np.float32))
        self.c2.append(np.asarray(c2, np.float32))
        return len(self.types) - 1

    def arrays(self):
        """(images [T,2*RES,RES,3], types [T] int32, params [T,8], c1 [T,3],
        c2 [T,3]) as numpy."""
        return (np.stack(self.images), np.asarray(self.types, np.int32),
                np.stack(self.params), np.stack(self.c1), np.stack(self.c2))
