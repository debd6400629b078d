"""The device an entry point runs on.

Entry points (scene build, camera, film, parser, CLI) take `device=None`,
which means the first CUDA card; the CPU is used only when the caller
names it (`device="cpu"`, the CLI's `--cpu`).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None is cuda:0, and raises when no CUDA
    card is visible rather than running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass device='cpu' (the CLI's --cpu) "
            "to run on the CPU")
    return torch.device("cuda", 0)
