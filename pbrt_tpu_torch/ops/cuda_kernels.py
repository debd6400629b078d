"""Build and bind the dense intersector's CUDA kernels (csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first
CUDA use, never at import, and is cached in `pbrt_tpu_torch/_build/` by a
hash of the sources.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import time

from pbrt_tpu_torch.native.build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = tuple(os.path.join(CSRC, f)
                for f in ("dense_queue.cu", "dense_loop.cu"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def build():
    """Compile the kernels if no cached library matches the sources.

    Returns (library path, seconds spent, compiler log); the log holds
    ptxas's per-kernel register and shared-memory report, and is empty
    when the cached library was reused."""
    t0 = time.perf_counter()
    path, log = build_shared_library("pbrt_dense", SOURCES,
                                     [_nvcc()] + NVCC_FLAGS)
    return path, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, with argument types declared."""
    lib = ctypes.CDLL(build()[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pbrt_dense_queue.restype = ctypes.c_int
    lib.pbrt_dense_queue.argtypes = [p, p, p, i, i, i, p, p, p]
    lib.pbrt_dense_loop.restype = ctypes.c_int
    lib.pbrt_dense_loop.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p]
    return lib
