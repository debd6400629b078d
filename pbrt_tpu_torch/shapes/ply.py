"""Minimal PLY mesh reader (port of pbrt_tpu.shapes.ply; reference:
src/shapes/plymesh.cpp via rply).

Supports ascii and binary_little_endian PLY with float vertex properties
(x y z [nx ny nz] [u v / s t]) and list-typed face indices; triangulates
polygons by fanning.
"""

from __future__ import annotations

import struct

import numpy as np

_TYPES = {"char": ("b", 1), "uchar": ("B", 1), "int8": ("b", 1),
          "uint8": ("B", 1), "short": ("h", 2), "ushort": ("H", 2),
          "int16": ("h", 2), "uint16": ("H", 2), "int": ("i", 4),
          "uint": ("I", 4), "int32": ("i", 4), "uint32": ("I", 4),
          "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
          "float64": ("d", 8)}


def read_ply(path):
    """Returns (vertices [V,3], faces [F,3], normals or None, uvs or None)."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]
    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    verts = norms = uvs = None
    faces = []           # list of [n,3] int arrays (fast path) or rows

    def _fan(idx):
        """Vectorized fan triangulation of uniform n-gons [F,n], emitting
        triangles in the same face-major order as the per-face loop."""
        n = idx.shape[1]
        tris = np.stack([np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], -1)
                         for k in range(1, n - 1)], 1)      # [F, n-2, 3]
        faces.append(tris.reshape(-1, 3).astype(np.int64))

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                arr = np.asarray(tokens[pos:pos + count * ncols],
                                 dtype=np.float64).reshape(count, ncols)
                pos += count * ncols
                cols = {p[0]: i for i, p in enumerate(props)}
                verts, norms, uvs = _extract(arr, cols)
            elif name == "face" and count > 0:
                # uniform n-gon fast path: one reshape instead of a
                # per-face Python loop (killeroo-class meshes)
                n0 = int(tokens[pos])
                blk = tokens[pos:pos + count * (n0 + 1)]
                done = False
                if len(props) == 1 and len(blk) == count * (n0 + 1):
                    mat = np.asarray(blk).reshape(count, n0 + 1)
                    if (mat[:, 0] == tokens[pos]).all():
                        _fan(mat[:, 1:].astype(np.int64))
                        pos += count * (n0 + 1)
                        done = True
                if not done:
                    rows = []
                    for _ in range(count):
                        n = int(tokens[pos]); pos += 1
                        poly = [int(tokens[pos + k]) for k in range(n)]
                        pos += n
                        for k in range(1, n - 1):
                            rows.append([poly[0], poly[k], poly[k + 1]])
                    faces.append(np.asarray(rows, np.int64).reshape(-1, 3))
            else:
                for _ in range(count):
                    for p in props:
                        pos += 1 + (int(tokens[pos]) if p[2] else 0)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                fmt_str = "<" + "".join(_TYPES[p[1]][0] for p in props)
                sz = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[0], "<" + _TYPES[p[1]][0]) for p in props]),
                    count=count, offset=off)
                off += sz * count
                cols = {p[0]: i for i, p in enumerate(props)}
                mat = np.stack([arr[p[0]].astype(np.float64)
                                for p in props], -1)
                verts, norms, uvs = _extract(mat, cols)
            elif name == "face" and count > 0:
                cnt_t, idx_t = props[0][2], props[0][1]
                cfmt, csz = _TYPES[cnt_t]
                ifmt, isz = _TYPES[idx_t]
                done = False
                if len(props) == 1:
                    # uniform n-gon fast path: ONE structured frombuffer
                    # instead of a per-face struct.unpack loop
                    n0 = int(np.frombuffer(body, "<" + cfmt, 1, off)[0])
                    rec = np.dtype([("c", "<" + cfmt),
                                    ("i", "<" + ifmt, (max(n0, 1),))])
                    if (n0 >= 3
                            and off + rec.itemsize * count <= len(body)):
                        arr = np.frombuffer(body, rec, count, off)
                        if (arr["c"] == n0).all():
                            _fan(arr["i"].astype(np.int64))
                            off += rec.itemsize * count
                            done = True
                if not done:
                    rows = []
                    for _ in range(count):
                        n = struct.unpack_from("<" + cfmt, body, off)[0]
                        off += csz
                        poly = struct.unpack_from("<" + ifmt * n, body, off)
                        off += isz * n
                        for k in range(1, n - 1):
                            rows.append([poly[0], poly[k], poly[k + 1]])
                    faces.append(np.asarray(rows, np.int64).reshape(-1, 3))
            else:
                for _ in range(count):
                    for p in props:
                        if p[2]:
                            cfmt, csz = _TYPES[p[2]]
                            n = struct.unpack_from("<" + cfmt, body, off)[0]
                            off += csz + n * _TYPES[p[1]][1]
                        else:
                            off += _TYPES[p[1]][1]
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    faces_arr = (np.concatenate(faces, 0) if faces
                 else np.zeros((0, 3), np.int64))
    return (np.asarray(verts), faces_arr, norms, uvs)


def _extract(arr, cols):
    verts = np.stack([arr[:, cols[c]] for c in "xyz"], -1)
    norms = uvs = None
    if all(c in cols for c in ("nx", "ny", "nz")):
        norms = np.stack([arr[:, cols[c]] for c in ("nx", "ny", "nz")], -1)
    for pair in (("u", "v"), ("s", "t")):
        if all(c in cols for c in pair):
            uvs = np.stack([arr[:, cols[c]] for c in pair], -1)
            break
    return verts, norms, uvs


def write_ply(path, verts, faces, norms=None, uvs=None, binary=False):
    """PLY writer (reference: WritePlyFile, triangle.cpp:112): ascii, or
    with binary=True binary_little_endian with float32 vertex properties
    and uchar / int32 triangle lists (the form read_ply's fast path
    reads; the port writes its test and benchmark meshes so)."""
    props = ["x", "y", "z"]
    cols = [np.asarray(verts, np.float64).reshape(-1, 3)]
    if norms is not None:
        props += ["nx", "ny", "nz"]
        cols.append(np.asarray(norms, np.float64).reshape(-1, 3))
    if uvs is not None:
        props += ["u", "v"]
        cols.append(np.asarray(uvs, np.float64).reshape(-1, 2))
    faces = np.asarray(faces).reshape(-1, 3)
    if binary:
        head = ("ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(cols[0])}\n"
                + "".join(f"property float {p}\n" for p in props)
                + f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        rec = np.zeros(len(faces), np.dtype([("c", "u1"), ("i", "<i4", (3,))]))
        rec["c"] = 3
        rec["i"] = faces
        with open(path, "wb") as f:
            f.write(head.encode("ascii"))
            f.write(np.concatenate(cols, 1).astype("<f4").tobytes())
            f.write(rec.tobytes())
        return
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if norms is not None:
            f.write("property float nx\nproperty float ny\n"
                    "property float nz\n")
        if uvs is not None:
            f.write("property float u\nproperty float v\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            row = list(v)
            if norms is not None:
                row += list(norms[i])
            if uvs is not None:
                row += list(uvs[i])
            f.write(" ".join(f"{x:g}" for x in row) + "\n")
        for face in faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")
