"""cyhair2pbrt — Cem Yuksel .hair -> pbrt curves (a copy of
pbrt_tpu.tools.cyhair2pbrt: plain Python and numpy; reference:
src/tools/cyhair2pbrt.cpp).  It writes the JAX package's bytes, its header
comment included.

    python -m pbrt_tpu_torch.tools.cyhair2pbrt model.hair out.pbrt
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def read_cyhair(path):
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"HAIR":
            raise ValueError(f"{path}: not a cyhair file")
        n_strands, n_points, flags = struct.unpack("<III", f.read(12))
        d_segments, d_thickness = struct.unpack("<If", f.read(8))
        d_transparency, = struct.unpack("<f", f.read(4))
        d_color = struct.unpack("<fff", f.read(12))
        f.read(88)  # file info
        has_segments = flags & 1
        has_points = flags & 2
        has_thickness = flags & 4
        has_transparency = flags & 8
        has_color = flags & 16
        segments = (np.frombuffer(f.read(2 * n_strands), "<u2")
                    if has_segments
                    else np.full(n_strands, d_segments, np.uint32))
        points = np.frombuffer(f.read(12 * n_points),
                               "<f4").reshape(-1, 3)
        thickness = (np.frombuffer(f.read(4 * n_points), "<f4")
                     if has_thickness
                     else np.full(n_points, d_thickness, np.float32))
        if has_transparency:
            f.read(4 * n_points)
        color = (np.frombuffer(f.read(12 * n_points), "<f4").reshape(-1, 3)
                 if has_color else None)
    return segments, points, thickness, color, d_color


def convert(in_path, out_path, max_strands=0):
    segments, points, thickness, color, d_color = read_cyhair(in_path)
    n_out = 0
    pos = 0
    with open(out_path, "w") as out:
        out.write(f"# converted from {in_path} by pbrt_tpu cyhair2pbrt\n")
        c = color.mean(0) if color is not None else d_color
        out.write(f'Material "hair" "color color" '
                  f'[{c[0]:g} {c[1]:g} {c[2]:g}]\n')
        for si, nseg in enumerate(segments):
            npts = int(nseg) + 1
            pts = points[pos:pos + npts]
            th = thickness[pos:pos + npts]
            pos += npts
            if max_strands and si >= max_strands:
                continue
            # emit cubic bezier curve segments through the polyline
            # (pbrt "curve" shape, 4 cp per segment)
            for k in range(0, npts - 1, 3):
                cp = pts[k:k + 4]
                while len(cp) < 4:
                    cp = np.concatenate([cp, cp[-1:]], 0)
                out.write('Shape "curve" "string type" "cylinder" '
                          '"point P" [ ')
                out.write(" ".join(f"{p[0]:g} {p[1]:g} {p[2]:g}"
                                   for p in cp))
                out.write(f' ] "float width0" [{th[k]:g}] '
                          f'"float width1" [{th[min(k+3, npts-1)]:g}]\n')
                n_out += 1
    print(f"wrote {out_path}: {len(segments)} strands, "
          f"{n_out} curve segments")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cyhair2pbrt")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--maxstrands", type=int, default=0)
    args = ap.parse_args(argv)
    return convert(args.input, args.output, args.maxstrands)


if __name__ == "__main__":
    sys.exit(main())
