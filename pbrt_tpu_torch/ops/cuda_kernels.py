"""Build and bind the port's CUDA kernels (csrc/*.cu): the dense
intersector's K1 and K2, the BVH and kd-tree walks, and SPPM's photon
gather.

The sources are compiled by `nvcc` for sm_90a into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first
CUDA use, never at import, and is cached in `pbrt_tpu_torch/_build/` by a
hash of the sources.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time

from pbrt_tpu_torch.native.build import build_shared_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = tuple(os.path.join(CSRC, f)
                for f in ("dense_queue.cu", "dense_loop.cu", "accel_walk.cu",
                        "sppm_gather.cu"))
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
    ptxas's per-kernel register, spill and shared-memory report, and is
    empty when the cached library was reused (ptxas_report reads it
    back)."""
    t0 = time.perf_counter()
    path, log = build_shared_library("pbrt_dense", SOURCES,
                                     [_nvcc()] + NVCC_FLAGS)
    if log:
        with open(path + ".ptxas.txt", "w") as f:
            f.write(log)
    return path, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, with argument types declared."""
    lib = ctypes.CDLL(build()[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("pbrt_dense_queue", "pbrt_dense_queue_cull"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [p, p, p, i, i, i, p, p, p]
    lib.pbrt_dense_loop.restype = ctypes.c_int
    lib.pbrt_dense_loop.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    lib.pbrt_dense_loop_motion.restype = ctypes.c_int
    lib.pbrt_dense_loop_motion.argtypes = [p] * 7 + [i] * 5 + [p] * 4
    lib.pbrt_dense_loop_ablate.restype = ctypes.c_int
    lib.pbrt_dense_loop_ablate.argtypes = [i] + [p] * 5 + [i] * 5 + [p] * 4
    lib.pbrt_dense_tile_dump.restype = ctypes.c_int
    lib.pbrt_dense_tile_dump.argtypes = [p] * 4 + [i] * 3 + [p] * 6
    lib.pbrt_bvh_walk.restype = ctypes.c_int
    lib.pbrt_bvh_walk.argtypes = [p] * 10 + [i] * 4 + [p] * 3
    lib.pbrt_kd_walk.restype = ctypes.c_int
    lib.pbrt_kd_walk.argtypes = [p] * 12 + [i] * 5 + [p] * 3
    lib.pbrt_sppm_gather.restype = ctypes.c_int
    lib.pbrt_sppm_gather.argtypes = [p] * 8 + [i] * 2 + [p] * 3
    return lib


def sass_counts():
    """Instruction counts of each kernel in the built library, read from
    `cuobjdump --dump-sass` (see parse_sass)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return parse_sass(subprocess.run(
        [tool, "--dump-sass", build()[0]], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def ptxas_report():
    """ptxas's report of the built library's kernels (parse_ptxas)."""
    with open(build()[0] + ".ptxas.txt") as f:
        return parse_ptxas(f.read())


_SASS_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def parse_sass(text):
    """{function name: {opcode: count}} of a SASS listing: each opcode
    without its modifiers (FFMA, BAR, STS, ...), and MUFU.RCP, BAR.SYNC
    and LDS.128 (a 16-byte shared load) also by those names."""
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = counts.setdefault(line.split("Function :")[1].strip(), {})
            continue
        m = _SASS_OP.search(line) if cur is not None else None
        if m is None:
            continue
        full = m.group(1)
        for name in {full.split(".")[0]} | {
                n for n in ("MUFU.RCP", "BAR.SYNC", "LDS.128")
                if full.startswith(n)}:
            cur[name] = cur.get(name, 0) + 1
    return counts


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([A-Za-z0-9_]+)'")
_PTXAS_PROPS = re.compile(r"Function properties for ([A-Za-z0-9_]+)")
_PTXAS_NUM = {"stack": re.compile(r"(\d+) bytes stack frame"),
              "spill_stores": re.compile(r"(\d+) bytes spill stores"),
              "spill_loads": re.compile(r"(\d+) bytes spill loads")}
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text):
    """{function name: {"registers", "stack", "spill_stores",
    "spill_loads": int}} of an `nvcc -Xptxas -v` log: the registers of
    each entry function, the stack and spills of each function whose
    properties are listed."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            props = m.group(1)
            out.setdefault(props, {})
            continue
        m = _PTXAS_REGS.search(line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
        for k, rx in _PTXAS_NUM.items():
            m = rx.search(line)
            if m and props is not None:
                out[props][k] = int(m.group(1))
    return out
