"""Spectral complex IoR data for common conductors (port of
pbrt_tpu.materials.metal_data, numpy only).

Copper, the `metal` material's default (reference: materials/metal.cpp:
82-115), uses the measured 56-sample table data/metal_cu.npz resampled
to the 31 bins; the other conductors keep coarse published curves
(Johnson & Christy 1972 for the noble metals, Rakic for Al) linearly
interpolated to the bins.
"""

from __future__ import annotations

import os

import numpy as np

from pbrt_tpu_torch import DATA_DIR
from pbrt_tpu_torch.core import spectrum as spec

# wavelength grid for the coarse data (nm)
_LAM = np.array([400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0])

_DATA = {
    # n (real IoR), k (extinction)
    "Cu": (np.array([1.18, 1.15, 1.12, 1.04, 0.47, 0.26, 0.21]),
           np.array([2.21, 2.40, 2.60, 2.59, 2.97, 3.41, 3.75])),
    "Au": (np.array([1.66, 1.50, 0.85, 0.33, 0.20, 0.13, 0.13]),
           np.array([1.96, 1.88, 1.90, 2.32, 2.90, 3.34, 3.84])),
    "Ag": (np.array([0.05, 0.04, 0.05, 0.06, 0.06, 0.06, 0.08]),
           np.array([2.12, 2.55, 2.95, 3.35, 3.75, 4.15, 4.52])),
    "Al": (np.array([0.49, 0.62, 0.77, 0.96, 1.20, 1.47, 1.83]),
           np.array([4.86, 5.47, 6.08, 6.69, 7.26, 7.79, 8.31])),
    # MgO and TiO2 appear in pbrt's metal data too; approximate dielectrics
    "MgO": (np.full(7, 1.74), np.zeros(7)),
    "TiO2": (np.full(7, 2.60), np.zeros(7)),
}


def _load_copper():
    d = np.load(os.path.join(DATA_DIR, "metal_cu.npz"))
    return d["lam"], d["n"], d["k"]


_CU_LAM, _CU_N, _CU_K = _load_copper()


def conductor_eta_k(name="Cu"):
    """(eta [31], k [31]) float32 binned spectra of a conductor."""
    if name == "Cu":
        eta = np.interp(spec.BIN_CENTERS, _CU_LAM, _CU_N)
        kap = np.interp(spec.BIN_CENTERS, _CU_LAM, _CU_K)
        return eta.astype(np.float32), kap.astype(np.float32)
    n, k = _DATA[name]
    eta = np.interp(spec.BIN_CENTERS, _LAM, n).astype(np.float32)
    kap = np.interp(spec.BIN_CENTERS, _LAM, k).astype(np.float32)
    return eta, kap
