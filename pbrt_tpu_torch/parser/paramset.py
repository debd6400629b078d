"""Typed parameter lists (port of pbrt_tpu.parser.paramset; reference:
src/core/paramset.{h,cpp}).

Parses pbrt's `"type name" [values]` declarations into a dict-backed
ParamSet with the reference's Find/FindOne lookup semantics.  Spectra:
`rgb`/`color`, `xyz`, `blackbody` [T scale ...] pairs, and `spectrum` as
inline (lambda, value) pairs or an `.spd` file, read relative to the
scene's directory.
"""

from __future__ import annotations

import os

import numpy as np

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.parser.tokenizer import unquote, is_quoted

PARAM_TYPES = {"integer", "float", "bool", "string", "point", "point2",
               "point3", "vector", "vector2", "vector3", "normal", "normal3",
               "rgb", "color", "xyz", "spectrum", "blackbody", "texture"}


class ParamSet:
    def __init__(self, scene_dir="."):
        self.items = {}       # name -> (type, values list)
        self.used = set()
        self.scene_dir = scene_dir

    def add(self, ptype, name, values):
        self.items[name] = (ptype, values)

    def _get(self, name):
        if name in self.items:
            self.used.add(name)
            return self.items[name]
        return None

    def find_one_float(self, name, default):
        it = self._get(name)
        return float(it[1][0]) if it else default

    def find_one_int(self, name, default):
        it = self._get(name)
        return int(it[1][0]) if it else default

    def find_one_bool(self, name, default):
        it = self._get(name)
        if not it:
            return default
        return it[1][0] in (True, "true", "\"true\"", 1)

    def find_one_string(self, name, default):
        it = self._get(name)
        return str(it[1][0]) if it else default

    def find_floats(self, name):
        it = self._get(name)
        return np.asarray(it[1], np.float64) if it else None

    def find_ints(self, name):
        it = self._get(name)
        return np.asarray(it[1], np.int64) if it else None

    def find_one_point(self, name, default):
        it = self._get(name)
        return np.asarray(it[1][:3] if it else default, np.float64)

    def find_points(self, name):
        it = self._get(name)
        return None if not it else np.asarray(it[1], np.float64).reshape(-1, 3)

    def find_point2s(self, name):
        it = self._get(name)
        return None if not it else np.asarray(it[1], np.float64).reshape(-1, 2)

    def find_texture(self, name):
        it = self._get(name)
        return str(it[1][0]) if it and it[0] == "texture" else None

    def find_one_spectrum(self, name, default, kind="illuminant"):
        """A [31] spectrum; default: a scalar or a [31] array.  Takes
        rgb/color, xyz, blackbody [T scale]... (each pair the normalized
        blackbody times its scale, summed), spectrum [l v l v ...] and
        spectrum "file.spd" (reference paramset.cpp:110-187).

        kind is "illuminant" by default because the reference converts
        every rgb parameter, reflectances included, as an illuminant
        (paramset.cpp:110-120, spectrum.h:428-429)."""
        it = self._get(name)
        if not it:
            if np.isscalar(default):
                return np.full(spec.N_SPECTRAL_SAMPLES, default, np.float32)
            return np.asarray(default, np.float32)
        ptype, vals = it
        if ptype in ("rgb", "color"):
            return spec.from_rgb_np(np.asarray(vals[:3], np.float64), kind)
        if ptype == "xyz":
            rgb = np.asarray(vals[:3], np.float64) @ spec.XYZ_TO_RGB.T
            return spec.from_rgb_np(rgb, kind)
        if ptype == "blackbody":
            out = np.zeros(spec.N_SPECTRAL_SAMPLES)
            for i in range(0, len(vals), 2):
                scale = float(vals[i + 1]) if i + 1 < len(vals) else 1.0
                out = out + spec.blackbody_spectrum(float(vals[i]), scale)
            return out.astype(np.float32)
        if ptype == "spectrum":
            if isinstance(vals[0], str):
                lam, v = read_spd(os.path.join(self.scene_dir, vals[0]))
                return spec.from_sampled(lam, v).astype(np.float32)
            arr = np.asarray(vals, np.float64)
            return spec.from_sampled(arr[0::2], arr[1::2]).astype(np.float32)
        if ptype == "float":
            return np.full(spec.N_SPECTRAL_SAMPLES, float(vals[0]), np.float32)
        raise ValueError(f"param {name}: type {ptype} is not a spectrum")

    def unused(self):
        return [n for n in self.items if n not in self.used]


def read_spd(path):
    """Whitespace-separated (lambda, value) pairs, `#` comments (the
    reference's ReadFloatFile and .spd convention, floatfile.cpp)."""
    nums = []
    with open(path) as f:
        for line in f:
            nums.extend(float(x) for x in line.split("#")[0].split())
    arr = np.asarray(nums)
    return arr[0::2], arr[1::2]


def parse_param_list(stream, scene_dir="."):
    """Consume `"type name" [values...]` declarations until a non-quoted
    token (the next directive) and return a ParamSet whose file
    parameters are relative to scene_dir."""
    ps = ParamSet(scene_dir)
    while True:
        tok = stream.peek()
        if tok is None or not is_quoted(tok):
            return ps
        decl = unquote(stream.next()).split()
        if len(decl) == 1:
            # a bare quoted string that is NOT a param decl (e.g. the name
            # argument of the next directive): push back and stop
            stream.push('"' + decl[0] + '"')
            return ps
        ptype, name = decl[0], decl[1]
        if ptype not in PARAM_TYPES:
            stream.push('"' + " ".join(decl) + '"')
            return ps
        values = []
        tok = stream.next()
        if tok == "[":
            while True:
                tok = stream.next()
                if tok is None:
                    raise ValueError("unterminated [ in param list")
                if tok == "]":
                    break
                values.append(_convert(tok))
        else:
            values.append(_convert(tok))
        ps.add(ptype, name, values)


def _convert(tok):
    if is_quoted(tok):
        return unquote(tok)
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        return float(tok)
