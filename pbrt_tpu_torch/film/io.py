"""Image output: the fork's ISET spectral .dat and an uncompressed EXR
(port of pbrt_tpu.film.io's writers, byte for byte), and an 8-bit sRGB
PNG written with zlib (no imaging library)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_dat(path, spectral, scale=1.0):
    """spectral: [H,W,31] (numpy or a tensor).  Text "W H 31\\n" + "v3 \\n",
    then float64 band-sequential data.  Returns the written path."""
    spectral = np.asarray(spectral.cpu() if hasattr(spectral, "cpu")
                          else spectral)
    h, w, ns = spectral.shape
    out = os.path.splitext(path)[0] + ".dat"
    with open(out, "w") as f:
        f.write(f"{w} {h} {ns}\n")
        f.write("v3 \n")
    data = np.asarray(spectral, np.float64) * scale
    with open(out, "ab") as f:
        f.write(np.ascontiguousarray(data.reshape(-1, ns).T).tobytes())
    return out


def read_dat(path):
    """Inverse of write_dat -> ([H,W,ns] float64, flag)."""
    with open(path, "rb") as f:
        w, h, ns = (int(x) for x in f.readline().split()[:3])
        flag = f.readline().strip()
        data = np.frombuffer(f.read(), dtype=np.float64, count=w * h * ns)
    return data.reshape(ns, h * w).T.reshape(h, w, ns), flag.decode()


def _attr(name, atype, payload):
    return (name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path, rgb):
    """rgb: [H,W,3] float32 -> scanline EXR, compression NONE."""
    rgb = np.asarray(rgb.cpu() if hasattr(rgb, "cpu") else rgb, np.float32)
    h, w = rgb.shape[:2]
    channels = b""
    for name in (b"B", b"G", b"R"):
        channels += name + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    channels += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_attr("channels", "chlist", channels)
              + _attr("compression", "compression", b"\x00")
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\x00")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")
    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    offset0 = len(magic) + len(header) + 8 * h
    line_size = 8 + 3 * 4 * w
    offsets = struct.pack("<" + "Q" * h,
                          *[offset0 + i * line_size for i in range(h)])
    with open(path, "wb") as f:
        f.write(magic + header + offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            for c in (2, 1, 0):          # channels alphabetical: B, G, R
                f.write(np.ascontiguousarray(rgb[y, :, c]).tobytes())
    return path


def _srgb_encode(x):
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * x ** (1 / 2.4) - 0.055)


def write_png(path, rgb):
    """rgb [H,W,3] linear -> 8-bit sRGB PNG (the JAX package's encoding,
    written by hand: one IDAT, filter 0 on every row)."""
    rgb = np.asarray(rgb.cpu() if hasattr(rgb, "cpu") else rgb)
    img = (_srgb_encode(rgb) * 255 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
    return path


def write_image(path, rgb):
    """Extension dispatch (reference: imageio.cpp WriteImage): .exr or
    .png; any other extension raises ValueError."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return write_exr(path, rgb)
    if ext == ".png":
        return write_png(path, rgb)
    raise ValueError(f"unsupported image extension {ext}")
