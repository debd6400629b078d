"""obj2pbrt — Wavefront OBJ -> pbrt scene (a copy of
pbrt_tpu.tools.obj2pbrt: plain Python and numpy; reference:
src/tools/obj2pbrt.cpp).  It writes the JAX package's bytes, its header
comment included.

    python -m pbrt_tpu_torch.tools.obj2pbrt scene.obj scene.pbrt
"""

from __future__ import annotations

import argparse
import os
import sys


def _parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {}
            elif cur and parts[0] in ("Kd", "Ks", "Ke"):
                mats[cur][parts[0]] = [float(x) for x in parts[1:4]]
            elif cur and parts[0] == "Ns":
                mats[cur]["Ns"] = float(parts[1])
            elif cur and parts[0] == "map_Kd":
                mats[cur]["map_Kd"] = parts[1]
    return mats


def convert(obj_path, out_path):
    verts, norms, uvs = [], [], []
    groups = {}          # material name -> list of faces (v/vt/vn triples)
    cur_mat = ""
    mtl = {}
    with open(obj_path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "usemtl":
                cur_mat = parts[1]
            elif tag == "mtllib":
                mtl.update(_parse_mtl(os.path.join(
                    os.path.dirname(os.path.abspath(obj_path)), parts[1])))
            elif tag == "f":
                idx = []
                for vspec in parts[1:]:
                    comp = (vspec.split("/") + ["", ""])[:3]
                    vi = int(comp[0])
                    ti = int(comp[1]) if comp[1] else 0
                    ni = int(comp[2]) if comp[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):
                    groups.setdefault(cur_mat, []).append(
                        (idx[0], idx[k], idx[k + 1]))

    def fix(i, n):
        return i - 1 if i > 0 else n + i

    with open(out_path, "w") as out:
        out.write(f"# converted from {obj_path} by pbrt_tpu obj2pbrt\n")
        for mname, faces in groups.items():
            m = mtl.get(mname, {})
            kd = m.get("Kd", [0.5, 0.5, 0.5])
            out.write(f"\nAttributeBegin # {mname or 'default'}\n")
            if m.get("map_Kd"):
                out.write(f'Texture "{mname}_kd" "color" "imagemap" '
                          f'"string filename" "{m["map_Kd"]}"\n')
                out.write(f'Material "matte" "texture Kd" "{mname}_kd"\n')
            elif m.get("Ks") and max(m["Ks"]) > 0:
                ks = m["Ks"]
                rough = 1.0 / max(m.get("Ns", 10.0), 1.0)
                out.write(f'Material "plastic" '
                          f'"color Kd" [{kd[0]} {kd[1]} {kd[2]}] '
                          f'"color Ks" [{ks[0]} {ks[1]} {ks[2]}] '
                          f'"float roughness" [{rough:.5f}]\n')
            else:
                out.write(f'Material "matte" '
                          f'"color Kd" [{kd[0]} {kd[1]} {kd[2]}]\n')
            if m.get("Ke") and max(m["Ke"]) > 0:
                ke = m["Ke"]
                out.write(f'AreaLightSource "area" '
                          f'"color L" [{ke[0]} {ke[1]} {ke[2]}]\n')
            # remap used vertices
            used = {}
            P, N, UV, I = [], [], [], []
            has_n = any(fc[2] for face in faces for fc in face)
            has_t = any(fc[1] for face in faces for fc in face)
            for face in faces:
                tri = []
                for (vi, ti, ni) in face:
                    key = (vi, ti, ni)
                    if key not in used:
                        used[key] = len(P)
                        P.append(verts[fix(vi, len(verts))])
                        if has_n:
                            N.append(norms[fix(ni, len(norms))]
                                     if ni else [0, 0, 0])
                        if has_t:
                            UV.append(uvs[fix(ti, len(uvs))]
                                      if ti else [0, 0])
                    tri.append(used[key])
                I.append(tri)
            out.write('Shape "trianglemesh"\n "point P" [ ')
            out.write(" ".join(f"{v[0]:g} {v[1]:g} {v[2]:g}" for v in P))
            out.write(" ]\n")
            if has_n:
                out.write(' "normal N" [ ')
                out.write(" ".join(f"{v[0]:g} {v[1]:g} {v[2]:g}" for v in N))
                out.write(" ]\n")
            if has_t:
                out.write(' "float uv" [ ')
                out.write(" ".join(f"{v[0]:g} {v[1]:g}" for v in UV))
                out.write(" ]\n")
            out.write(' "integer indices" [ ')
            out.write(" ".join(f"{t[0]} {t[1]} {t[2]}" for t in I))
            out.write(" ]\nAttributeEnd\n")
    n_tris = sum(len(v) for v in groups.values())
    print(f"wrote {out_path}: {len(verts)} vertices, {n_tris} triangles, "
          f"{len(groups)} material groups")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="obj2pbrt")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    return convert(args.input, args.output)


if __name__ == "__main__":
    sys.exit(main())
