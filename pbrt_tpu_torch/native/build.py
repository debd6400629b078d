"""Build and load the port's native code (ctypes, no pybind11): the BVH
and kd-tree builders, and the OpenEXR reader shim.

Shared libraries are compiled into `pbrt_tpu_torch/_build/` (listed in
.gitignore), named by a hash of their sources and compiler command, so a
stale library is never loaded.  A failed build raises: there is no
silent fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def build_shared_library(name, sources, command, timeout=600, libs=()):
    """Compile `sources` with `command + sources + ["-o", out] + libs`
    (the libraries after the sources, which the linker needs) unless a
    library built from the same sources and command already exists.

    The build writes a process-private file and renames it into place,
    so concurrent builders (test workers) never load a half-written
    library.  Returns (path, compiler log); the log is empty when an
    existing library was reused."""
    h = hashlib.sha256(" ".join(list(command) + list(libs)).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(list(command) + list(sources) + ["-o", tmp]
                          + list(libs),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _bvh_lib():
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bvh_builder.cc")
    path, _ = build_shared_library(
        "pbrt_native",
        [src], ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                "-std=c++17"])
    lib = ctypes.CDLL(path)
    lib.build_bvh_native.restype = ctypes.c_int64
    lib.build_bvh_native.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    return lib


def build_bvh_native(prim_lo, prim_hi, max_leaf):
    """SAH BVH over [P,3] bounds: (packed [N,8] f32, hit links [8,N] i32,
    miss links [8,N] i32, prim order [P] i32), trimmed to the N nodes the
    builder reports (accel/bvh.py's layout)."""
    lib = _bvh_lib()
    plo = np.ascontiguousarray(prim_lo, np.float64)
    phi = np.ascontiguousarray(prim_hi, np.float64)
    P = plo.shape[0]
    max_nodes = 2 * P + 2
    packed = np.zeros((max_nodes, 8), np.float32)
    hit = np.zeros(8 * max_nodes, np.int32)
    miss = np.zeros(8 * max_nodes, np.int32)
    order = np.zeros(P, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    n = lib.build_bvh_native(ptr(plo, ctypes.c_double),
                             ptr(phi, ctypes.c_double),
                             ctypes.c_int64(P), ctypes.c_int(max_leaf),
                             ptr(packed, ctypes.c_float),
                             ptr(hit, ctypes.c_int32),
                             ptr(miss, ctypes.c_int32),
                             ptr(order, ctypes.c_int32))
    if n <= 0:
        raise RuntimeError(f"native BVH build failed ({n})")
    # the link tables were written with stride N, the real node count
    return (packed[:n].copy(), hit[:8 * n].reshape(8, n).copy(),
            miss[:8 * n].reshape(8, n).copy(), order)


@functools.lru_cache(maxsize=None)
def _kd_lib():
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "kdtree_builder.cc")
    path, _ = build_shared_library(
        "pbrt_kdtree", [src], ["g++", "-O2", "-ffp-contract=off", "-shared",
                               "-fPIC", "-std=c++17"])
    lib = ctypes.CDLL(path)
    lib.kd_build.restype = ctypes.c_void_p
    lib.kd_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double]
    lib.kd_sizes.restype = None
    lib.kd_sizes.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.kd_copy.restype = None
    lib.kd_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.kd_free.restype = None
    lib.kd_free.argtypes = [ctypes.c_void_p]
    return lib


def build_kdtree_native(lo, hi, max_depth, max_prims, isect_cost,
                        traversal_cost, empty_bonus):
    """accel/kdtree.py's build in C++ (native/kdtree_builder.cc) over f32
    boxes lo / hi [P,3]: (nodes_f [N] f32, nodes_i [N,3] i32, prim_idx [M]
    i32)."""
    lib = _kd_lib()
    plo = np.ascontiguousarray(lo, np.float32)
    phi = np.ascontiguousarray(hi, np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    h = lib.kd_build(ptr(plo, ctypes.c_float), ptr(phi, ctypes.c_float),
                     ctypes.c_int64(plo.shape[0]), int(max_depth),
                     int(max_prims), float(isect_cost), float(traversal_cost),
                     float(empty_bonus))
    if not h:
        raise RuntimeError("native kd-tree build failed")
    try:
        n, m = ctypes.c_int64(), ctypes.c_int64()
        lib.kd_sizes(h, ctypes.byref(n), ctypes.byref(m))
        nodes_f = np.zeros(n.value, np.float32)
        nodes_i = np.zeros((n.value, 3), np.int32)
        prim_idx = np.zeros(m.value, np.int32)
        lib.kd_copy(h, ptr(nodes_f, ctypes.c_float),
                    ptr(nodes_i, ctypes.c_int32),
                    ptr(prim_idx, ctypes.c_int32))
    finally:
        lib.kd_free(h)
    return nodes_f, nodes_i, prim_idx


#: the system OpenEXR 3.1 the EXR shim compiles against and links
EXR_INCLUDE = ("/usr/include/OpenEXR", "/usr/include/Imath")
EXR_LIBS = ("-lOpenEXR-3_1", "-lIex-3_1", "-lImath-3_1", "-lIlmThread-3_1",
            "-pthread")


def exr_headers_present():
    return os.path.exists(os.path.join(EXR_INCLUDE[0], "ImfRgbaFile.h"))


@functools.lru_cache(maxsize=None)
def _exr_lib():
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "exr_reader.cc")
    path, _ = build_shared_library(
        "pbrt_exr", [src],
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]
        + [f"-I{d}" for d in EXR_INCLUDE], libs=EXR_LIBS)
    lib = ctypes.CDLL(path)
    lib.pbrt_exr_size.restype = ctypes.c_int
    lib.pbrt_exr_size.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.pbrt_exr_read_rgba.restype = ctypes.c_int
    lib.pbrt_exr_read_rgba.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_float)]
    return lib


def read_exr_native(path):
    """[H,W,4] float32 RGBA of any scanline or tiled EXR through the
    system OpenEXR (native/exr_reader.cc, built at first use; a compiler
    error raises with its log).  A file OpenEXR cannot read raises
    ValueError."""
    lib = _exr_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.pbrt_exr_size(os.fsencode(path), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        raise ValueError(f"{path}: OpenEXR cannot read it")
    out = np.zeros((h.value, w.value, 4), np.float32)
    if lib.pbrt_exr_read_rgba(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
        raise ValueError(f"{path}: OpenEXR cannot read its pixels")
    return out
