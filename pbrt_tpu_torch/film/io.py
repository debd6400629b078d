"""Image input and output: the fork's ISET spectral .dat, scanline EXR
(port of pbrt_tpu.film.io: its writer byte for byte, its NONE / ZIPS /
ZIP reader), PFM, and PNG and TGA, all in numpy and zlib (no imaging
library).

`read_image` gives what the JAX package's gives: EXR and PFM linear,
PNG and TGA as pbrt_tpu's PIL route decodes them (`convert("RGB")`,
/255, ** 2.2).  EXR compressions other than NONE, ZIPS and ZIP (PIZ,
PXR24, B44, DWA...) read through the system OpenEXR by a native shim
(native/exr_reader.cc), as in the JAX package; where its headers are
missing they raise NotImplementedError naming the compression and the
missing library.  Image formats other than EXR, PFM, PNG and TGA raise
NotImplementedError."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from pbrt_tpu_torch.native import build


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


# EXR compression codes (ImfCompression.h)
EXR_COMPRESSIONS = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                    5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
_EXR_LINES = {0: 1, 2: 1, 3: 16}      # scanlines a block, by compression
_EXR_TYPE_BYTES = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT


def _exr_predict(raw):
    """The EXR ZIP pre-deflate transform (OpenEXR ImfZip.cpp): split the
    bytes into even and odd planes, then store byte deltas + 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + 128
    return (d & 255).astype(np.uint8).tobytes()


def _exr_unpredict(raw):
    """Undo _exr_predict: delta-reconstruct, then interleave the planes."""
    t = np.frombuffer(raw, np.uint8).astype(np.int16)
    d = t.copy()
    d[1:] -= 128
    d = np.cumsum(d).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty(len(d), np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def write_exr(path, rgb, compression="none"):
    """rgb: [H,W,3] float32 -> scanline EXR, FLOAT channels; compression
    "none" (byte for byte the JAX package's writer), "zips" (one line a
    block) or "zip" (16 lines a block).  A block that deflate does not
    shrink is stored raw, as OpenEXR does."""
    code = {"none": 0, "zips": 2, "zip": 3}[compression]
    rgb = np.asarray(rgb.cpu() if hasattr(rgb, "cpu") else rgb, np.float32)
    h, w = rgb.shape[:2]
    channels = b""
    for name in (b"B", b"G", b"R"):
        channels += name + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    channels += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_attr("channels", "chlist", channels)
              + _attr("compression", "compression", bytes([code]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\x00")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")
    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    lines = _EXR_LINES[code]
    blocks = []
    for y in range(0, h, lines):
        # channels alphabetical: B, G, R, each a full row
        raw = b"".join(np.ascontiguousarray(rgb[yy, :, c]).tobytes()
                       for yy in range(y, min(y + lines, h))
                       for c in (2, 1, 0))
        if code:
            packed = zlib.compress(_exr_predict(raw), 6)
            raw = packed if len(packed) < len(raw) else raw
        blocks.append(struct.pack("<ii", y, len(raw)) + raw)
    offsets, pos = [], len(magic) + len(header) + 8 * len(blocks)
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(magic + header + struct.pack("<" + "Q" * len(blocks),
                                             *offsets))
        f.write(b"".join(blocks))
    return path


def read_exr(path):
    """Scanline EXR -> [H,W,3] float32 (or the channels as stored when
    there is no R, G, B or Y): NONE / ZIPS / ZIP, HALF / FLOAT / UINT
    channels, as the JAX package's numpy reader; every other compression
    through OpenEXR's RGBA interface (native.build.read_exr_native), as
    the JAX package's shim reads it.  Without OpenEXR's headers those
    raise NotImplementedError naming the compression."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack_from("<i", data, 0)[0] != 20000630:
        raise ValueError(f"{path}: not an EXR")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        atype = data[pos:e].decode()
        pos = e + 1
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = (atype, data[pos:pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in _EXR_LINES:
        if not build.exr_headers_present():
            raise NotImplementedError(
                f"{path}: EXR compression "
                f"{EXR_COMPRESSIONS.get(comp, comp)} needs the OpenEXR "
                f"library, whose headers are missing ({build.EXR_INCLUDE[0]}"
                "); NONE, ZIPS and ZIP read without it")
        return build.read_exr_native(path)[..., :3].copy()
    lines_per_block = _EXR_LINES[comp]
    # channel list (file order = sorted names; per scanline in this order)
    ch = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\x00", cpos)
        ch.append((cdata[cpos:e].decode(),
                   struct.unpack_from("<i", cdata, e + 1)[0]))
        cpos = e + 1 + 16
    ch_names = [c[0] for c in ch]
    line_bytes = sum(_EXR_TYPE_BYTES[t] for _, t in ch) * w
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    pos += 8 * n_blocks            # offset table
    img = np.zeros((h, w, len(ch)), np.float32)
    for _ in range(n_blocks):
        yy, sz = struct.unpack_from("<ii", data, pos)
        pos += 8
        nl = min(lines_per_block, y1 - yy + 1)
        payload = data[pos:pos + sz]
        pos += sz
        if comp in (2, 3) and sz < line_bytes * nl:
            payload = _exr_unpredict(zlib.decompress(payload))
        lpos = 0
        for li in range(nl):
            y = yy - y0 + li
            for ci, (_, ptype) in enumerate(ch):
                nb = _EXR_TYPE_BYTES[ptype]
                buf = payload[lpos:lpos + nb * w]
                lpos += nb * w
                dt = {2: np.float32, 1: np.float16, 0: np.uint32}[ptype]
                if 0 <= y < h:
                    img[y, :, ci] = np.frombuffer(buf, dt, w).astype(
                        np.float32)
    if set("RGB") <= set(ch_names):
        return img[:, :, [ch_names.index(c) for c in "RGB"]]
    if "Y" in ch_names:            # luminance-only maps
        return np.repeat(img[:, :, ch_names.index("Y")][:, :, None], 3,
                         axis=2)
    return img


def write_pfm(path, rgb):
    """rgb [H,W,3] -> little-endian PFM (bottom row first)."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" + f"{w} {h}\n".encode() + b"-1.000000\n")
        f.write(np.ascontiguousarray(rgb[::-1]).tobytes())
    return path


def read_pfm(path):
    """PFM -> [H,W,C] float32, top row first (reference imageio.cpp)."""
    with open(path, "rb") as f:
        if f.readline().strip() not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, -1)[::-1]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _png_unfilter(raw, h, stride, bpp):
    """Undo the per-scanline PNG filters 0-4 -> [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype == 1:
            # sub: a running sum per byte of the pixel
            cur = (np.cumsum(line.reshape(-1, bpp), 0) & 255).reshape(-1)
        elif ftype in (3, 4):
            cur = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                c = up[x - bpp] if x >= bpp else 0
                pred = ((a + up[x]) >> 1 if ftype == 3
                        else _paeth(a, up[x], c))
                cur[x] = (cur[x] + pred) & 255
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path):
    """PNG -> [H,W,3] uint8 as PIL's `Image.open(path).convert("RGB")`
    gives it (the JAX package's route): grey replicated, alpha dropped,
    16-bit RGB(A) and grey-alpha by their high byte, 16-bit grey clipped
    to 255.  8- and 16-bit grey / grey-alpha / RGB / RGBA, not
    interlaced; others raise NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if chans is None or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG colour type {ctype}, {depth}-bit, interlace "
            f"{interlace} is not ported (8/16-bit grey, grey-alpha, RGB, "
            "RGBA, not interlaced)")
    nb = depth // 8
    px = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * chans * nb,
                       chans * nb).reshape(h, w, chans, nb)
    if nb == 2 and ctype == 0:
        v = px[..., 0].astype(np.uint16) << 8 | px[..., 1]
        px = np.minimum(v, 255).astype(np.uint8)
    else:
        px = px[..., 0]                  # the high byte
    if chans <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_tga(path):
    """TGA, true-colour types 2 (raw) and 10 (run-length), 24 or 32 bits
    -> [H,W,3] uint8, top row first, alpha dropped; other types raise
    NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h, bits, desc = struct.unpack_from("<HHBB", data, 12)
    if itype not in (2, 10) or cmap_type != 0 or bits not in (24, 32):
        raise NotImplementedError(
            f"{path}: TGA type {itype}, {bits} bits, colour map "
            f"{cmap_type} is not ported (true-colour types 2 and 10, 24 "
            "or 32 bits)")
    bpp = bits // 8
    pos = 18 + id_len
    n = w * h
    if itype == 2:
        px = np.frombuffer(data, np.uint8, n * bpp, pos)
    else:
        out = bytearray()
        while len(out) < n * bpp:
            head = data[pos]
            pos += 1
            count = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos:pos + bpp] * count
                pos += bpp
            else:
                out += data[pos:pos + bpp * count]
                pos += bpp * count
        px = np.frombuffer(bytes(out[:n * bpp]), np.uint8)
    img = px.reshape(h, w, bpp)[..., 2::-1]          # BGR(A) -> RGB
    if not desc & 0x20:                              # bottom-left origin
        img = img[::-1]
    if desc & 0x10:                                  # right-to-left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def read_image(path):
    """An image file -> float32 [H,W,3]: EXR and PFM linear; PNG and TGA
    8-bit values / 255 raised to 2.2, as the JAX package reads them.
    Any other format raises NotImplementedError naming it."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext in (".png", ".tga"):
        img = (read_png if ext == ".png" else read_tga)(path)
        return (np.asarray(img, np.float32) / 255.0) ** 2.2
    raise NotImplementedError(f"{path}: image format {ext or '(none)'} "
                              "is not ported (EXR, PFM, PNG, TGA)")


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
    """Extension dispatch (reference: imageio.cpp WriteImage): .exr, .pfm
    or .png; any other extension raises ValueError (the JAX package
    writes .tga, .jpg and .bmp through PIL)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return write_exr(path, rgb)
    if ext == ".pfm":
        return write_pfm(path, rgb)
    if ext == ".png":
        return write_png(path, rgb)
    raise ValueError(f"unsupported image extension {ext}")
