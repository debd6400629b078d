"""The shapes scene: every shape and scene-format directive of the port in
the Cornell box of scenes/cornell_bench.pbrt (its walls and area light).

    python -m pbrt_tpu_torch.tools.shapes_scene OUT_DIR [--level 5]
        [--instances 6] [--field 128] [--subdiv 4] [--seed 0] [--res 256]
        [--spp 4] [--accel bvh|kdtree] [--moving-field]

writes OUT_DIR/shapes.pbrt and its binary PLY, OUT_DIR/blob.ply.  At the
defaults (the full-size cell):
- a `plymesh` blob, a level-5 icosphere (20,480 faces) displaced from
  the seed, defined once in `ObjectBegin "blob"` and placed by 6
  `ObjectInstance`s under distinct transforms (122,880 triangles);
- a `heightfield` floor of 128 x 128 samples (32,258 triangles);
- a `loopsubdiv` icosahedron at `levels 4` (5,120 triangles);
- a `hyperboloid` (1,890 triangles once tessellated), a `nurbs` patch,
  and two `curve`s, one "flat" and one "cylinder";
- a `cylinder`, a `disk` with an `innerradius`, a `cone`, a `paraboloid`
  and a sphere cut to `phimax` 270, so that the quadrics take their z /
  phi clip;
- a `CoordinateSystem` / `CoordSysTransform` pair that places the cone,
  and an `Accelerator "bvh"` line.

It renders at 256x256 with Sobol, 4 spp, depth 5 and the path
integrator.  Small arguments give a small scene of the same structure
(the tests': level 1, 2 instances, a 6 x 6 field, subdiv 1); larger ones
a scene over the dense cap (the walks' cells: `--level 6 --instances 12
--field 256`, ~1.12M triangles, takes the BVH).  Two options change the
test data, each with directives both packages parse: `--accel kdtree`
writes that Accelerator line (a scene over the cap then walks the
kd-tree), and `--moving-field` moves the heightfield by (0, 0, 0.15) over
the shutter (ActiveTransform EndTime, as pbrt_tpu_torch/scenes/
cornell_motion.pbrt:24-26 moves its mirror), so that the scene has an
animated mesh (over 150,000 primitives it walks the BVH with per-ray
time).  Nothing of it is committed: it is written from the seed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pbrt_tpu_torch.shapes.ply import write_ply

# scenes/cornell_bench.pbrt's camera, walls and ceiling light
_HEADER = """LookAt 2.5 -4.5 2.5  2.5 2.5 2.5  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [256] "integer yresolution" [256]
Sampler "sobol" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [5]
Accelerator "bvh" "integer maxnodeprims" [4]
WorldBegin
Material "matte" "rgb Kd" [.73 .73 .73]
Shape "trianglemesh" "point P" [0 0 0 5 0 0 5 5 0 0 5 0]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [0 0 5 0 5 5 5 5 5 5 0 5]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [0 5 0 5 5 0 5 5 5 0 5 5]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "rgb Kd" [.65 .05 .05]
Shape "trianglemesh" "point P" [0 0 0 0 5 0 0 5 5 0 0 5]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "rgb Kd" [.12 .45 .15]
Shape "trianglemesh" "point P" [5 0 0 5 0 5 5 5 5 5 5 0]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
Material "matte" "rgb Kd" [0 0 0]
AreaLightSource "diffuse" "rgb L" [15 12.75 9]
Shape "trianglemesh"
  "point P" [1.8 1.8 4.99 1.8 3.2 4.99 3.2 3.2 4.99 3.2 1.8 4.99]
  "integer indices" [0 1 2 2 3 0]
AttributeEnd
"""


def icosahedron():
    """The 12 vertices (unit sphere) and 20 faces of an icosahedron."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    return v / np.linalg.norm(v, axis=1, keepdims=True), f


def icosphere(level):
    """A unit icosphere: each level splits every face into four, the new
    vertices pushed to the sphere (20 * 4^level faces)."""
    v, f = icosahedron()
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), 1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq].mean(1)
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = inv.reshape(3, -1).T + len(v)          # [F,3]: ab, bc, ca
        v = np.concatenate([v, mid])
        a, b, c = f.T
        ab, bc, ca = m.T
        f = np.concatenate([np.stack(x, 1) for x in (
            (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
    return v, f


def blob(level, seed):
    """The icosphere of `level` displaced radially by a few random
    smooth lobes from `seed`; returns (vertices, faces, normals)."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(level)
    dirs = rng.normal(size=(6, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    amp = rng.uniform(0.08, 0.2, 6)
    sharp = rng.uniform(2.0, 6.0, 6)
    r = 1.0 + (amp[None] * np.exp(sharp[None] * (v @ dirs.T - 1.0))).sum(1)
    verts = v * r[:, None]
    # area-weighted vertex normals
    fn = np.cross(verts[f[:, 1]] - verts[f[:, 0]],
                  verts[f[:, 2]] - verts[f[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return verts, f, n


def _floats(a):
    return " ".join(f"{x:.6g}" for x in np.asarray(a, np.float64).ravel())


def _ints(a):
    return " ".join(str(int(x)) for x in np.asarray(a).ravel())


def instance_transforms(instances):
    """(translation, rotation about z in degrees, scale) of each blob
    instance: rows of three above the floor, each turned and scaled."""
    out = []
    for i in range(instances):
        row, col = divmod(i, 3)
        out.append(((0.95 + 1.55 * col, 1.4 + 1.3 * (row % 3),
                     0.85 + 0.35 * (row % 2) + 1.2 * (row // 3)),
                    37.0 * i, 0.42 - 0.03 * (i % 4)))
    return out


def scene_text(level=5, instances=6, field=128, subdiv=4, seed=0,
               res=256, spp=4, accel="bvh", moving_field=False):
    """The .pbrt text of the shapes scene; its plymesh is "blob.ply"."""
    rng = np.random.default_rng(seed + 1)
    out = [_HEADER.replace("[256]", f"[{res}]").replace(
        '"integer pixelsamples" [4]', f'"integer pixelsamples" [{spp}]')
        .replace('Accelerator "bvh"', f'Accelerator "{accel}"')]
    # the blob, once, then its instances
    out.append('ObjectBegin "blob"\n'
               'Material "plastic" "rgb Kd" [.35 .45 .7] "rgb Ks" '
               '[.3 .3 .3] "float roughness" [.05]\n'
               'Shape "plymesh" "string filename" "blob.ply"\n'
               'ObjectEnd\n')
    for (tx, ty, tz), rot, sc in instance_transforms(instances):
        out.append(f"AttributeBegin\nTranslate {tx:.6g} {ty:.6g} {tz:.6g}\n"
                   f"Rotate {rot:.6g} 0 0 1\nScale {sc:.6g} {sc:.6g} "
                   f'{sc:.6g}\nObjectInstance "blob"\nAttributeEnd\n')
    # the heightfield floor: a few random smooth waves, 0.01-0.25 high
    xs, ys = np.meshgrid(np.linspace(0, 1, field), np.linspace(0, 1, field))
    z = np.zeros_like(xs)
    for _ in range(4):
        kx, ky = rng.uniform(2, 9, 2)
        z += np.sin(kx * xs + rng.uniform(0, 6.3)) \
            * np.cos(ky * ys + rng.uniform(0, 6.3))
    z = 0.01 + 0.24 * (z - z.min()) / max(np.ptp(z), 1e-9)
    motion = ("ActiveTransform EndTime\nTranslate 0 0 0.15\n"
              "ActiveTransform All\n" if moving_field else "")
    out.append('AttributeBegin\n' + motion
               + 'Material "matte" "rgb Kd" [.6 .55 .4]\n'
               "Translate 0.02 0.02 0\nScale 4.96 4.96 1\n"
               f'Shape "heightfield" "integer nu" [{field}] "integer nv" '
               f'[{field}] "float Pz" [{_floats(z)}]\nAttributeEnd\n')
    # the Loop-subdivided icosahedron
    iv, ifc = icosahedron()
    out.append('AttributeBegin\nMaterial "matte" "rgb Kd" [.7 .6 .2]\n'
               "Translate 0.8 4.1 3.7\nScale 0.5 0.5 0.5\n"
               f'Shape "loopsubdiv" "integer levels" [{subdiv}] '
               f'"point P" [{_floats(iv)}] "integer indices" '
               f"[{_ints(ifc)}]\nAttributeEnd\n")
    # the hyperboloid, the nurbs patch and the curves
    out.append('AttributeBegin\nMaterial "matte" "rgb Kd" [.3 .7 .6]\n'
               "Translate 4.2 4.2 2.6\n"
               'Shape "hyperboloid" "point p1" [0.45 0 0] "point p2" '
               '[0.2 0.35 1.1] "float phimax" [360]\nAttributeEnd\n')
    cp = np.array([[[x, 0.0, y] for x in np.linspace(0, 1, 4)]
                   for y in np.linspace(0, 1, 4)])
    cp[1:3, 1:3, 1] = -0.4
    out.append('AttributeBegin\nMaterial "matte" "rgb Kd" [.8 .3 .5]\n'
               "Translate 3.3 4.95 3.2\nScale 1.4 1 1.2\n"
               'Shape "nurbs" "integer nu" [4] "integer nv" [4] '
               '"integer uorder" [3] "integer vorder" [3] '
               '"float uknots" [0 0 0 0.5 1 1 1] '
               '"float vknots" [0 0 0 0.5 1 1 1] '
               f'"point P" [{_floats(cp)}]\nAttributeEnd\n')
    out.append('AttributeBegin\nMaterial "matte" "rgb Kd" [.9 .8 .1]\n'
               'Shape "curve" "string type" "flat" "point P" '
               '[0.4 3.0 0.4 1.2 3.6 2.4 2.2 2.4 3.4 3.0 3.8 4.4] '
               '"float width0" [0.06] "float width1" [0.02]\n'
               'Material "matte" "rgb Kd" [.2 .8 .9]\n'
               'Shape "curve" "string type" "cylinder" "point P" '
               '[4.6 0.8 0.5 3.8 1.6 2.6 4.8 2.6 3.2 4.0 3.4 4.6] '
               '"float width" [0.05]\nAttributeEnd\n')
    # the quadrics; the cone placed through a named coordinate system
    out.append('AttributeBegin\nTranslate 4.3 1.2 3.7\nRotate 30 0 1 0\n'
               'CoordinateSystem "shelf"\nAttributeEnd\n')
    out.append('AttributeBegin\nMaterial "matte" "rgb Kd" [.8 .4 .2]\n'
               "Translate 0.7 1.1 1.6\nRotate 90 1 0 0\n"
               'Shape "cylinder" "float radius" [0.25] "float zmin" [-0.4] '
               '"float zmax" [0.4] "float phimax" [300]\nAttributeEnd\n'
               'AttributeBegin\nMaterial "matte" "rgb Kd" [.5 .8 .3]\n'
               "Translate 2.5 0.9 2.9\nRotate 60 1 0 0\n"
               'Shape "disk" "float radius" [0.45] "float innerradius" '
               '[0.2] "float height" [0.05]\nAttributeEnd\n'
               'AttributeBegin\nMaterial "matte" "rgb Kd" [.9 .9 .9]\n'
               'CoordSysTransform "shelf"\n'
               'Shape "cone" "float radius" [0.35] "float height" [0.8] '
               '"float phimax" [320]\nAttributeEnd\n'
               'AttributeBegin\nMaterial "mirror" "rgb Kr" [.9 .9 .9]\n'
               "Translate 3.6 2.2 4.3\nRotate 180 1 0 0\n"
               'Shape "paraboloid" "float radius" [0.4] "float zmin" [0] '
               '"float zmax" [0.5]\nAttributeEnd\n'
               'AttributeBegin\nMaterial "glass"\n'
               "Translate 1.6 0.9 0.75\n"
               'Shape "sphere" "float radius" [0.4] "float phimax" [270]\n'
               "AttributeEnd\nWorldEnd\n")
    return "".join(out)


def write_shapes_scene(out_dir, level=5, instances=6, field=128, subdiv=4,
                       seed=0, res=256, spp=4, accel="bvh",
                       moving_field=False):
    """Write out_dir/shapes.pbrt and out_dir/blob.ply (binary
    little-endian); returns the .pbrt path."""
    os.makedirs(out_dir, exist_ok=True)
    verts, faces, norms = blob(level, seed)
    write_ply(os.path.join(out_dir, "blob.ply"), verts, faces, norms=norms,
              binary=True)
    path = os.path.join(out_dir, "shapes.pbrt")
    with open(path, "w") as f:
        f.write(scene_text(level, instances, field, subdiv, seed, res, spp,
                           accel, moving_field))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--instances", type=int, default=6)
    ap.add_argument("--field", type=int, default=128)
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--accel", choices=("bvh", "kdtree"), default="bvh")
    ap.add_argument("--moving-field", action="store_true")
    args = ap.parse_args(argv)
    print(write_shapes_scene(args.out_dir, args.level, args.instances,
                             args.field, args.subdiv, args.seed, args.res,
                             args.spp, args.accel, args.moving_field))
    return 0


if __name__ == "__main__":
    sys.exit(main())
