"""Loop subdivision surfaces -> triangle mesh (port of
pbrt_tpu.shapes.subdiv; reference: src/shapes/loopsubdiv.cpp).  Host-side
numpy; tessellates at scene-compile time exactly as the reference does at
shape creation.

pbrt-exact pipeline (required for matched-RNG parity on loopsubdiv
geometry like the killeroo meshes):
  1. nLevels of Loop refinement — even interior weightOneRing with
     beta(valence) (1/16 when regular), even boundary weightBoundary
     with beta=1/8, odd interior 3/8-3/8-1/8-1/8, odd boundary 1/2-1/2
     (loopsubdiv.cpp:239-320);
  2. push every vertex to the LIMIT surface — interior
     weightOneRing(loopGamma(valence)), boundary weightBoundary(1/5)
     (:333-341);
  3. limit-surface tangents -> per-vertex shading NORMALS Ns = S x T
     over the ORDERED one-ring (:343-378), which the created triangle
     mesh carries as shading normals (:397).
Arithmetic in float32 like the reference's Float.
"""

from __future__ import annotations

import numpy as np


def loop_subdivide(verts, faces, levels):
    """verts [V,3], faces [F,3] -> (limit_verts f32, faces, normals f32)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    for _ in range(max(int(levels), 0)):
        verts, faces = _subdivide_once(verts, faces)
    verts, normals = _limit(verts, faces)
    return verts, faces, normals


def _adjacency(verts, faces):
    """Per-vertex ordered-ring machinery.

    Returns (edge_faces, nbr_across, startFace, boundary):
      edge_faces: {sorted edge: [(face, opposite vertex), ...]}
      nbr_across: {(v, w) directed: face index across edge {v,w} from the
                   face in which w follows v} — pbrt's f->nextFace(v)
      startFace[v]: pbrt's startFace (the LAST face touching v in face
                    order; LoopSubdivide overwrites it per face)
      boundary[v]
    """
    V = len(verts)
    edge_faces = {}
    face_of_dir = {}          # directed edge (v,w) -> face where w follows v
    start = np.full(V, -1, np.int64)
    for fi, f in enumerate(faces):
        for k in range(3):
            a, b = int(f[k]), int(f[(k + 1) % 3])
            edge_faces.setdefault((min(a, b), max(a, b)), []).append(
                (fi, int(f[(k + 2) % 3])))
            face_of_dir[(a, b)] = fi
            start[f[k]] = fi
    boundary = np.zeros(V, bool)
    for (a, b), efs in edge_faces.items():
        if len(efs) == 1:
            boundary[a] = boundary[b] = True

    def next_face(fi, v):
        # pbrt SDFace::nextFace(v) = neighbor across edge (v, nextVert)
        f = faces[fi]
        k = int(np.where(f == v)[0][0])
        w = int(f[(k + 1) % 3])
        return face_of_dir.get((w, v), None)   # the OTHER face has (w,v)

    def prev_face(fi, v):
        f = faces[fi]
        k = int(np.where(f == v)[0][0])
        u = int(f[(k + 2) % 3])                 # prevVert
        return face_of_dir.get((v, u), None)

    def next_vert(fi, v):
        f = faces[fi]
        k = int(np.where(f == v)[0][0])
        return int(f[(k + 1) % 3])

    def prev_vert(fi, v):
        f = faces[fi]
        k = int(np.where(f == v)[0][0])
        return int(f[(k + 2) % 3])

    def one_ring(v):
        """Ordered ring indices, pbrt SDVertex::oneRing semantics."""
        fi = int(start[v])
        if not boundary[v]:
            ring = []
            f0 = fi
            while True:
                ring.append(next_vert(fi, v))
                fi = next_face(fi, v)
                if fi == f0:
                    break
            return ring
        # boundary: rewind along nextFace, then walk prevFace
        while True:
            f2 = next_face(fi, v)
            if f2 is None:
                break
            fi = f2
        ring = [next_vert(fi, v)]
        while fi is not None:
            ring.append(prev_vert(fi, v))
            fi = prev_face(fi, v)
        return ring

    return edge_faces, one_ring, boundary


def _beta(n):
    # f32 arithmetic like the reference's Float (loopsubdiv.cpp:137-141)
    if n == 3:
        return np.float32(3.0) / np.float32(16.0)
    return np.float32(3.0) / (np.float32(8.0) * np.float32(n))


def _weight_one_ring(verts, v, ring, b):
    """weightOneRing (loopsubdiv.cpp:426): (1-n*b)*p then sequential
    += b*ring[i] in RING order — the f32 summation order matters for
    bit-level parity with the reference."""
    p = (np.float32(1.0) - np.float32(len(ring)) * b) * verts[v]
    for w in ring:
        p = p + b * verts[w]
    return p


def _weight_boundary(verts, v, ring, b):
    """weightBoundary (loopsubdiv.cpp:456)."""
    p = (np.float32(1.0) - np.float32(2.0) * b) * verts[v]
    p = p + b * verts[ring[0]]
    return p + b * verts[ring[-1]]


def _subdivide_once(verts, faces):
    V = len(verts)
    edge_faces, one_ring, boundary = _adjacency(verts, faces)

    # even (original) vertices (loopsubdiv.cpp:239-252)
    even = np.empty_like(verts)
    for v in range(V):
        ring = one_ring(v)
        if boundary[v]:
            even[v] = _weight_boundary(verts, v, ring,
                                       np.float32(1.0) / np.float32(8.0))
        else:
            even[v] = _weight_one_ring(verts, v, ring, _beta(len(ring)))

    # odd (edge) vertices (loopsubdiv.cpp:256-283): pbrt's exact f32 op
    # order — 3/8 a, += 3/8 b, += 1/8 opposite-of-first-face,
    # += 1/8 opposite-of-second-face
    w38 = np.float32(3.0) / np.float32(8.0)
    w18 = np.float32(1.0) / np.float32(8.0)
    w12 = np.float32(0.5)
    edge_map = {}
    new_verts = []
    for e, efs in edge_faces.items():
        a, b = e
        if len(efs) == 2:
            p = w38 * verts[a]
            p = p + w38 * verts[b]
            p = p + w18 * verts[efs[0][1]]
            p = p + w18 * verts[efs[1][1]]
        else:
            p = w12 * verts[a]
            p = p + w12 * verts[b]
        edge_map[e] = V + len(new_verts)
        new_verts.append(p)

    out_faces = []
    for f in faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ab = edge_map[(min(a, b), max(a, b))]
        bc = edge_map[(min(b, c), max(b, c))]
        ca = edge_map[(min(c, a), max(c, a))]
        # pbrt's children vertex ROTATION matters: child k keeps the
        # original vertex at slot k (loopsubdiv.cpp "children vertex
        # pointers"), so children 1/2 START at an edge vertex.  v[0]
        # fixes dpdu via the default uvs (0,0),(1,0),(1,1) — a rotated
        # order spins every shading frame and breaks matched-RNG parity.
        out_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return (np.concatenate([even, np.asarray(new_verts, np.float32)], 0),
            np.asarray(out_faces, np.int64))


def _limit(verts, faces):
    """Limit-surface projection + tangent normals (loopsubdiv.cpp:333-378)."""
    V = len(verts)
    _, one_ring, boundary = _adjacency(verts, faces)
    rings = [one_ring(v) for v in range(V)]

    p_limit = np.empty_like(verts)
    for v in range(V):
        ring = rings[v]
        n = len(ring)
        if boundary[v]:
            b = np.float32(1.0 / 5.0)
            p_limit[v] = (1 - 2 * b) * verts[v] \
                + b * verts[ring[0]] + b * verts[ring[-1]]
        else:
            b = np.float32(1.0 / (n + 3.0 / (8.0 * _beta(n))))
            p_limit[v] = (1 - n * b) * verts[v] + b * verts[ring].sum(0)

    normals = np.empty_like(verts)
    for v in range(V):
        ring = rings[v]
        n = len(ring)
        pr = p_limit[ring]
        if not boundary[v]:
            j = np.arange(n)
            S = (np.cos(2 * np.pi * j / n, dtype=np.float32)[:, None]
                 * pr).sum(0)
            T = (np.sin(2 * np.pi * j / n, dtype=np.float32)[:, None]
                 * pr).sum(0)
        else:
            S = pr[n - 1] - pr[0]
            if n == 2:
                T = pr[0] + pr[1] - 2 * p_limit[v]
            elif n == 3:
                T = pr[1] - p_limit[v]
            elif n == 4:
                T = (-1 * pr[0] + 2 * pr[1] + 2 * pr[2] - 1 * pr[3]
                     - 2 * p_limit[v])
            else:
                theta = np.pi / (n - 1)
                T = np.sin(theta) * (pr[0] + pr[n - 1])
                for k in range(1, n - 1):
                    T = T + (2 * np.cos(theta) - 2) * np.sin(k * theta) \
                        * pr[k]
                T = -T
        normals[v] = np.cross(S, T)
    return p_limit, normals
