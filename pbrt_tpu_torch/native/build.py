"""Build and load the port's native code (ctypes, no pybind11).

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


def build_shared_library(name, sources, command, timeout=600):
    """Compile `sources` with `command + sources + ["-o", out]` unless a
    library built from the same sources and command already exists.

    The build writes a process-private file and renames it into place,
    so concurrent builders (test workers) never load a half-written
    library.  Returns (path, compiler log); the log is empty when an
    existing library was reused."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(command + list(sources) + ["-o", tmp],
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
    """SAH BVH over [P,3] bounds; returns the [P] new->old prim order."""
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
    return order
