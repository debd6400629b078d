"""RGB to a 31-bin spectrum (395-705 nm), as pbrt-v3 converts an "rgb"
or "color" parameter: Smits' decomposition over the illuminant basis
(pbrt-v3 paramset.cpp converts every rgb parameter as an illuminant,
reflectances included), the basis bin-averaged into the 31 bins and its
trailing scale folded in (`data/rgb2spect.npz`)."""

from __future__ import annotations

import functools
import os

import numpy as np

N_BINS = 31
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_NAMES = ("white", "cyan", "magenta", "yellow", "red", "green", "blue")


@functools.lru_cache(maxsize=None)
def _basis():
    d = np.load(os.path.join(_DATA, "rgb2spect.npz"))
    return {k: d[f"illum_{k}"].astype(np.float64) * float(d["illum_scale"])
            for k in _NAMES}


def from_rgb(rgb):
    """[3] rgb -> [31] float64 spectrum (Smits 1999)."""
    B = _basis()
    r, g, b = (float(v) for v in rgb)
    if r <= g and r <= b:
        s = r * B["white"] + (
            (g - r) * B["cyan"] + (b - g) * B["blue"] if g <= b
            else (b - r) * B["cyan"] + (g - b) * B["green"])
    elif g <= r and g <= b:
        s = g * B["white"] + (
            (r - g) * B["magenta"] + (b - r) * B["blue"] if r <= b
            else (b - g) * B["magenta"] + (r - b) * B["red"])
    else:
        s = b * B["white"] + (
            (r - b) * B["yellow"] + (g - r) * B["green"] if r <= g
            else (g - b) * B["yellow"] + (r - g) * B["red"])
    return np.maximum(s, 0.0)
