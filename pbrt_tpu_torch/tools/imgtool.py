"""imgtool — image utility (port of pbrt_tpu.tools.imgtool; reference:
src/tools/imgtool.cpp:32-85).

Commands: assemble, cat, convert (tonemap/bloom/scale/flipy/repeatpix/
despike/preservecolors), diff (--difftol), info, makesky.

    python -m pbrt_tpu_torch.tools.imgtool convert in.exr out.png --tonemap

Host numpy over the port's image readers and writers (film/io.py) and
its Hosek-Wilkie sky (lights/hosek.py): no command touches a device, and
each writes and prints what the JAX package's does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from pbrt_tpu_torch.film import io as fio
from pbrt_tpu_torch.lights import hosek


def cmd_info(args):
    img = fio.read_image(args.input)
    print(f"{args.input}: {img.shape[1]} x {img.shape[0]}, "
          f"{img.shape[2]} channels")
    print(f"  min {img.min():.6g} max {img.max():.6g} mean {img.mean():.6g}")
    lum = img @ np.array([0.2126, 0.7152, 0.0722])[:img.shape[2]]
    print(f"  luminance min {lum.min():.6g} max {lum.max():.6g} "
          f"avg {lum.mean():.6g}")
    return 0


def cmd_cat(args):
    img = fio.read_image(args.input)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            print(f"({x},{y}): " + " ".join(f"{v:.6g}" for v in img[y, x]))
    return 0


def cmd_diff(args):
    a = fio.read_image(args.input)
    b = fio.read_image(args.ref)
    if a.shape != b.shape:
        print(f"images differ in size: {a.shape} vs {b.shape}")
        return 1
    d = np.abs(a - b)
    rel = d.sum() / max(np.abs(b).sum(), 1e-12) * 100
    print(f"images differ: {int((d > 0).sum())} pixels, "
          f"{rel:.4f}%% relative error, max abs diff {d.max():.6g}")
    if args.outfile:
        fio.write_image(args.outfile, d)
    return 0 if rel <= args.difftol else 1


def _tonemap(rgb, max_y=1.0):
    # reference imgtool tonemap: Reinhard-style using luminance
    lum = rgb @ np.array([0.2126, 0.7152, 0.0722])
    scale = (1 + lum / (max_y * max_y)) / (1 + lum)
    return rgb * scale[..., None]


def _bloom(rgb, level=0.95, width=15, scale=0.3, iters=5):
    thresh = np.quantile(rgb.max(-1), level)
    bright = np.where(rgb.max(-1, keepdims=True) > thresh, rgb, 0.0)
    blurred = bright
    for _ in range(iters):
        b = blurred.copy()
        k = width // 2 or 1
        b[k:] += blurred[:-k]
        b[:-k] += blurred[k:]
        b[:, k:] += blurred[:, :-k]
        b[:, :-k] += blurred[:, k:]
        blurred = b / 5
    return rgb + scale * blurred


def _despike(rgb, threshold):
    lum = rgb @ np.array([0.2126, 0.7152, 0.0722])
    med = np.copy(rgb)
    hot = lum > threshold
    ys, xs = np.nonzero(hot)
    H, W = lum.shape
    for y, x in zip(ys, xs):
        y0, y1 = max(0, y - 1), min(H, y + 2)
        x0, x1 = max(0, x - 1), min(W, x + 2)
        med[y, x] = np.median(rgb[y0:y1, x0:x1].reshape(-1, 3), 0)
    return med


def cmd_convert(args):
    img = fio.read_image(args.input)
    if args.scale != 1.0:
        img = img * args.scale
    if args.despike < 1e20:
        img = _despike(img, args.despike)
    if args.bloomlevel < 1e20:
        img = _bloom(img, level=0.95, width=args.bloomwidth,
                     scale=args.bloomscale, iters=args.bloomiters)
    if args.tonemap:
        img = _tonemap(img, args.maxluminance)
    if args.preservecolors:
        m = img.max(-1, keepdims=True)
        img = np.where(m > 1, img / np.maximum(m, 1e-9), img)
    if args.flipy:
        img = img[::-1]
    if args.repeatpix > 1:
        img = np.repeat(np.repeat(img, args.repeatpix, 0), args.repeatpix, 1)
    fio.write_image(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_assemble(args):
    """Merge crop-window renders into one image (imgtool assemble)."""
    imgs = [fio.read_image(f) for f in args.inputs]
    H = max(i.shape[0] for i in imgs)
    W = max(i.shape[1] for i in imgs)
    out = np.zeros((H, W, 3), np.float32)
    count = np.zeros((H, W, 1), np.float32)
    for i in imgs:
        nz = (i.sum(-1) != 0)[..., None]
        out[:i.shape[0], :i.shape[1]] += i
        count[:i.shape[0], :i.shape[1]] += nz
    out = out / np.maximum(count, 1)
    fio.write_image(args.output, out)
    print(f"wrote {args.output}")
    return 0


def cmd_makesky(args):
    """Hosek-Wilkie spectral sky + solar disc, lat-long env map
    (reference imgtool.cpp:87-188 via ext/ArHosekSkyModel.c; model +
    coefficient tables in lights/hosek.py)."""
    rgb = hosek.make_sky_image(resolution=args.resolution,
                               turbidity=args.turbidity,
                               albedo=args.albedo,
                               elevation_deg=args.elevation) * args.scale
    fio.write_image(args.output, np.maximum(rgb, 0))
    print(f"wrote {args.output} ({rgb.shape[1]}x{rgb.shape[0]})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("info"); p.add_argument("input")
    p = sub.add_parser("cat"); p.add_argument("input")
    p = sub.add_parser("diff")
    p.add_argument("input"); p.add_argument("ref")
    p.add_argument("--difftol", type=float, default=0.0)
    p.add_argument("--outfile", default=None)
    p = sub.add_parser("convert")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--tonemap", action="store_true")
    p.add_argument("--maxluminance", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--despike", type=float, default=1e30)
    p.add_argument("--bloomlevel", type=float, default=1e30)
    p.add_argument("--bloomwidth", type=int, default=15)
    p.add_argument("--bloomscale", type=float, default=0.3)
    p.add_argument("--bloomiters", type=int, default=5)
    p.add_argument("--flipy", action="store_true")
    p.add_argument("--repeatpix", type=int, default=1)
    p.add_argument("--preservecolors", action="store_true")
    p = sub.add_parser("assemble")
    p.add_argument("output"); p.add_argument("inputs", nargs="+")
    p = sub.add_parser("makesky")
    p.add_argument("output")
    p.add_argument("--elevation", type=float, default=10.0)
    p.add_argument("--turbidity", type=float, default=3.0)
    p.add_argument("--albedo", type=float, default=0.5)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    return {"info": cmd_info, "cat": cmd_cat, "diff": cmd_diff,
            "convert": cmd_convert, "assemble": cmd_assemble,
            "makesky": cmd_makesky}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
