"""The skin scene: the rest of the materials in the Cornell box of
scenes/cornell_bench.pbrt (its walls, area light and camera).

    python -m pbrt_tpu_torch.tools.skin_scene OUT_DIR [--res 256]
        [--spp 4] [--fibres 600] [--wall 16] [--rings 24] [--seed 0]

writes OUT_DIR/skin.pbrt with OUT_DIR/sphere.bsdf (a SCATFUN file made by
materials/fourier.py write_bsdf) and OUT_DIR/wall.ptx (made by
textures/ptex.py write_ptex).  At the defaults:
- a tall block in `subsurface` with `"string name" "Skin1"` and `scale`
  30, so that its mean free path (1 / sigma_t, about 1 unit of the
  preset at scale 1) is a few percent of the 1.2-unit block;
- a short block in `kdsubsurface` (Kd, mfp 0.05) with `uroughness` 0.1:
  the rough interface;
- a sphere tessellated to `rings` x 2 `rings` quads in `fourier`, a
  3-channel table of 5 Fourier orders (an azimuthal lobe, so that phi
  sampling is not uniform);
- the back wall tessellated to `wall` x `wall` quads, its Kd a ptex with
  one colour a face (2 `wall`^2 faces);
- a swatch of `fibres` flat `curve`s hanging from the ceiling in `hair`
  with eumelanin 1.3.

It renders at 256x256 with Sobol, 4 spp, depth 5 and the path
integrator, and stays under the dense cap (the main path's K1 and K2).
Nothing of it is committed: it is written from the seed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pbrt_tpu_torch.materials.fourier import write_bsdf
from pbrt_tpu_torch.textures.ptex import write_ptex

_BOX = """LookAt 2.5 -4.5 2.5  2.5 2.5 2.5  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [256] "integer yresolution" [256]
Sampler "sobol" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [5]
WorldBegin
Texture "wallptex" "spectrum" "ptex" "string filename" "wall.ptx"
Material "matte" "rgb Kd" [.73 .73 .73]
Shape "trianglemesh" "point P" [0 0 0 5 0 0 5 5 0 0 5 0] "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [0 0 5 0 5 5 5 5 5 5 0 5] "integer indices" [0 1 2 2 3 0]
Material "matte" "rgb Kd" [.65 .05 .05]
Shape "trianglemesh" "point P" [0 0 0 0 5 0 0 5 5 0 0 5] "integer indices" [0 1 2 2 3 0]
Material "matte" "rgb Kd" [.12 .45 .15]
Shape "trianglemesh" "point P" [5 0 0 5 0 5 5 5 5 5 5 0] "integer indices" [0 1 2 2 3 0]
AttributeBegin
Material "matte" "rgb Kd" [0 0 0]
AreaLightSource "diffuse" "rgb L" [15 12.75 9]
Shape "trianglemesh" "point P" [1.8 1.8 4.99 1.8 3.2 4.99 3.2 3.2 4.99 3.2 1.8 4.99] "integer indices" [0 1 2 2 3 0]
AttributeEnd
"""


def _floats(a):
    return " ".join(f"{x:.6g}" for x in np.asarray(a, np.float64).ravel())


def _ints(a):
    return " ".join(str(int(x)) for x in np.asarray(a).ravel())


def box_mesh(lo, hi):
    """An axis-aligned box's 8 corners and 12 outward triangles."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                  [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
                  [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]])
    return v, f


def grid_wall(n):
    """The back wall (y = 5) as n x n quads: (vertices, 2 n^2 faces)."""
    s = np.linspace(0.0, 5.0, n + 1)
    xs, zs = np.meshgrid(s, s, indexing="ij")
    v = np.stack([xs, np.full_like(xs, 5.0), zs], -1).reshape(-1, 3)
    f = []
    for i in range(n):
        for k in range(n):
            a = i * (n + 1) + k
            b, c, d = a + n + 1, a + n + 2, a + 1
            f += [[a, b, c], [a, c, d]]
    return v, np.asarray(f)


def uv_sphere(rings):
    """A unit sphere of rings x 2 rings quads: (vertices, faces, normals)."""
    th = np.linspace(0.0, np.pi, rings + 1)
    ph = np.linspace(0.0, 2 * np.pi, 2 * rings + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 -1).reshape(-1, 3)
    w = 2 * rings + 1
    f = []
    for i in range(rings):
        for k in range(2 * rings):
            a = i * w + k
            b, c, d = a + w, a + w + 1, a + 1
            if i > 0:
                f.append([a, b, d])
            if i < rings - 1:
                f.append([d, b, c])
    return v, np.asarray(f), v


def fourier_table(n_mu=12, orders=5):
    """(mu nodes, coefficients) of a 3-channel (Y, R, B) reflection-only
    measured BSDF: at each (muI, muO) on opposite sides a diffuse term of
    albedo ~0.3 and a decaying azimuthal series (a_k = a_0 0.6^k), so the
    lobe peaks where -wi and wo share their azimuth."""
    mu = np.linspace(-1.0, 1.0, n_mu)
    coeffs = []
    for mi in mu:
        row = []
        for mo in mu:
            if mi * mo < 0:
                a0 = 0.3 * abs(mi) / np.pi
                y = a0 * 0.6 ** np.arange(orders)
                row.append(np.concatenate([y, 1.2 * y, 0.7 * y]))
            else:
                row.append(np.zeros(0))
        coeffs.append(row)
    return mu, coeffs


def wall_faces(n_faces, seed):
    """One colour a face: [n_faces] 8x8 RGB tiles."""
    rng = np.random.default_rng(seed)
    cols = rng.uniform(0.15, 0.85, (n_faces, 3)).astype(np.float32)
    return [np.broadcast_to(c, (8, 8, 3)).copy() for c in cols]


def fibres(n, seed):
    """n hair fibres hanging from the ceiling in front of the short
    block: (control points [n,4,3], widths)."""
    rng = np.random.default_rng(seed + 7)
    x = rng.uniform(0.7, 2.1, n)
    y = rng.uniform(1.2, 1.6, n)
    z0 = 4.98
    length = rng.uniform(1.9, 2.5, n)
    sway = rng.normal(0.0, 0.12, (n, 2))
    cps = np.zeros((n, 4, 3))
    for k, f in enumerate((0.0, 1 / 3, 2 / 3, 1.0)):
        cps[:, k, 0] = x + sway[:, 0] * f ** 2
        cps[:, k, 1] = y + sway[:, 1] * f ** 2
        cps[:, k, 2] = z0 - length * f
    return cps, rng.uniform(0.008, 0.014, n)


def scene_text(res=256, spp=4, n_fibres=600, wall=16, rings=24, seed=0):
    """The .pbrt text; its files are "sphere.bsdf" and "wall.ptx"."""
    out = [_BOX.replace("[256]", f"[{res}]").replace(
        '"integer pixelsamples" [4]', f'"integer pixelsamples" [{spp}]')]
    wv, wf = grid_wall(wall)
    out.append('AttributeBegin\nMaterial "matte" "texture Kd" "wallptex"\n'
               f'Shape "trianglemesh" "point P" [{_floats(wv)}] '
               f'"integer indices" [{_ints(wf)}]\nAttributeEnd\n')
    tv, tf = box_mesh((3.0, 2.9, 0.0), (4.2, 4.1, 3.0))
    out.append('AttributeBegin\nMaterial "subsurface" "string name" "Skin1" '
               '"float scale" [30] "float eta" [1.33]\n'
               f'Shape "trianglemesh" "point P" [{_floats(tv)}] '
               f'"integer indices" [{_ints(tf)}]\nAttributeEnd\n')
    sv, sf = box_mesh((0.6, 2.8, 0.0), (1.9, 4.1, 1.3))
    out.append('AttributeBegin\nMaterial "kdsubsurface" "rgb Kd" '
               '[.7 .5 .4] "float mfp" [0.05] "float uroughness" [0.1]\n'
               f'Shape "trianglemesh" "point P" [{_floats(sv)}] '
               f'"integer indices" [{_ints(sf)}]\nAttributeEnd\n')
    pv, pf, pn = uv_sphere(rings)
    out.append('AttributeBegin\nMaterial "fourier" "string bsdffile" '
               '"sphere.bsdf"\nTranslate 3.7 1.3 0.7\nScale 0.7 0.7 0.7\n'
               f'Shape "trianglemesh" "point P" [{_floats(pv)}] '
               f'"normal N" [{_floats(pn)}] "integer indices" '
               f'[{_ints(pf)}]\nAttributeEnd\n')
    cps, widths = fibres(n_fibres, seed)
    out.append('AttributeBegin\nMaterial "hair" "float eumelanin" [1.3]\n')
    for cp, w in zip(cps, widths):
        out.append(f'Shape "curve" "string type" "flat" "point P" '
                   f'[{_floats(cp)}] "float width" [{w:.6g}]\n')
    out.append("AttributeEnd\nWorldEnd\n")
    return "".join(out)


def write_skin_scene(out_dir, res=256, spp=4, n_fibres=600, wall=16,
                     rings=24, seed=0):
    """Write out_dir/skin.pbrt, sphere.bsdf and wall.ptx; returns the
    .pbrt path."""
    os.makedirs(out_dir, exist_ok=True)
    mu, coeffs = fourier_table()
    write_bsdf(os.path.join(out_dir, "sphere.bsdf"), mu, coeffs,
               n_channels=3, eta=1.5)
    write_ptex(os.path.join(out_dir, "wall.ptx"),
               wall_faces(2 * wall * wall, seed))
    path = os.path.join(out_dir, "skin.pbrt")
    with open(path, "w") as f:
        f.write(scene_text(res, spp, n_fibres, wall, rings, seed))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--fibres", type=int, default=600)
    ap.add_argument("--wall", type=int, default=16)
    ap.add_argument("--rings", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(write_skin_scene(args.out_dir, args.res, args.spp, args.fibres,
                           args.wall, args.rings, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
