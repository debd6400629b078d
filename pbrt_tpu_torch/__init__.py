"""pbrt_tpu_torch — the PyTorch/CUDA port of the pbrt_tpu spectral path tracer.

The package mirrors `pbrt_tpu`'s module paths and function names, so each
ported function sits at the same place as its JAX counterpart.  Plain
tensor code is PyTorch; the ray-triangle intersector's kernels are
hand-written CUDA for Hopper (`csrc/`), built at first CUDA use.  Every
function that creates tensors takes a `device`; the entry points (scene
build, camera, film, parser, the Cornell model, the CLI) default to the
first CUDA card and raise without one, so the CPU is used only when the
caller asks for it (`core/device.py`).

The package imports `torch` and numpy only: never `jax`, `flax` or
`pbrt_tpu`.  Data tables are read by path from `pbrt_tpu/data`.
"""

import os

#: the JAX package's data directory (tables shared by both packages)
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pbrt_tpu", "data")
