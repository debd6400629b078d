"""Ptex per-face textures (a copy of pbrt_tpu.textures.ptex; reference:
src/textures/ptex.cpp over the Disney Ptex library): an independent
reader and writer of the documented PtexIO container.

Scope: the single-texel-block layout, header v1, uint8 / uint16 /
float32 data, `enc_zipped` and `enc_constant` face encodings, the top
mip level only (the texture table builds its own pyramid).  Tiled and
diff-zipped encodings raise.  `write_ptex` writes the same subset.

At scene build the faces are baked into a RES x RES atlas of equal
tiles (`bake_atlas`); a lane looks up its face's tile by the hit's
per-mesh face index (Hit.face) and samples it bilinearly at the
intra-face uv (a triangle mesh without vertex uvs takes the default
corners, whose uv are the barycentrics, Ptex's triangle
parameterisation).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x78657450             # 'Ptex' little-endian
MESH_TRIANGLE, MESH_QUAD = 0, 1
DT_UINT8, DT_UINT16, DT_HALF, DT_FLOAT = 0, 1, 2, 3
ENC_CONSTANT, ENC_ZIPPED, ENC_DIFFZIPPED, ENC_TILED = 0, 1, 2, 3
_DTYPES = {DT_UINT8: np.uint8, DT_UINT16: np.uint16,
           DT_HALF: np.float16, DT_FLOAT: np.float32}

_HEADER = struct.Struct("<IIIIiHHIIIIIQII")
# magic version meshtype datatype alphachan nchannels nlevels nfaces
# extheadersize faceinfosize constdatasize levelinfosize leveldatasize
# metadatazipsize metadatamemsize
_FACEINFO = struct.Struct("<bbBBiiii")   # ulog2 vlog2 adjedges flags adj[4]
_LEVELINFO = struct.Struct("<QII")       # leveldatasize headersize nfaces


def _to_float(arr, datatype):
    arr = np.asarray(arr)
    if datatype == DT_UINT8:
        return arr.astype(np.float32) / 255.0
    if datatype == DT_UINT16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def read_ptex(path):
    """Parse a .ptx file -> dict(meshtype, nchannels, faces=[...]) where
    each face is a float32 [h, w, nchannels] array (top level)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, version, meshtype, datatype, alphachan, nchannels, nlevels,
     nfaces, extheadersize, faceinfosize, constdatasize, levelinfosize,
     leveldatasize, metadatazipsize, metadatamemsize) = \
        _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a Ptex file")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype {datatype}")
    pos = _HEADER.size + extheadersize
    finfo_raw = zlib.decompress(data[pos:pos + faceinfosize])
    pos += faceinfosize
    faceinfo = [_FACEINFO.unpack_from(finfo_raw, i * _FACEINFO.size)
                for i in range(nfaces)]
    const_raw = zlib.decompress(data[pos:pos + constdatasize]) \
        if constdatasize else b""
    pos += constdatasize
    linfo = [_LEVELINFO.unpack_from(data, pos + i * _LEVELINFO.size)
             for i in range(nlevels)]
    pos += levelinfosize
    # top level only (level 0 holds every face at full res)
    lsize, lheadersize, lfaces = linfo[0]
    fdh_raw = zlib.decompress(data[pos:pos + lheadersize])
    fdh = np.frombuffer(fdh_raw, dtype=np.uint32, count=lfaces)
    dpos = pos + lheadersize
    dt = _DTYPES[datatype]
    itemsize = np.dtype(dt).itemsize
    faces = []
    for i in range(lfaces):
        ulog2, vlog2, _, _, *_ = faceinfo[i]
        w, h = 1 << ulog2, 1 << vlog2
        blocksize = int(fdh[i]) & 0x3FFFFFFF
        enc = int(fdh[i]) >> 30
        blob = data[dpos:dpos + blocksize]
        dpos += blocksize
        if enc == ENC_CONSTANT:
            texel = np.frombuffer(
                blob if blob else
                const_raw[i * nchannels * itemsize:
                          (i + 1) * nchannels * itemsize], dtype=dt,
                count=nchannels)
            face = np.broadcast_to(texel, (h, w, nchannels)).copy()
        elif enc == ENC_ZIPPED:
            raw = zlib.decompress(blob)
            face = np.frombuffer(raw, dtype=dt).reshape(h, w, nchannels)
        else:
            raise ValueError(f"{path}: face {i} uses unsupported "
                             f"encoding {enc} (tiled/diff-zipped)")
        faces.append(_to_float(face, datatype))
    return dict(meshtype=meshtype, nchannels=nchannels, faces=faces,
                alphachan=alphachan)


def write_ptex(path, faces, meshtype=MESH_TRIANGLE, datatype=DT_FLOAT):
    """Write float faces ([h,w,c] each, pow2 dims) as a .ptx with
    enc_zipped face blocks."""
    faces = [np.asarray(f, np.float32) for f in faces]
    nfaces = len(faces)
    nchannels = faces[0].shape[2]
    dt = _DTYPES[datatype]
    finfo = b"".join(
        _FACEINFO.pack(int(np.log2(f.shape[1])), int(np.log2(f.shape[0])),
                       0, 0, -1, -1, -1, -1) for f in faces)
    finfo_z = zlib.compress(finfo)
    blocks = []
    fdh = np.empty(nfaces, np.uint32)
    for i, f in enumerate(faces):
        if datatype == DT_UINT8:
            raw = np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
        elif datatype == DT_UINT16:
            raw = np.clip(f * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
        else:
            raw = f.astype(dt)
        blob = zlib.compress(raw.tobytes())
        blocks.append(blob)
        fdh[i] = (ENC_ZIPPED << 30) | (len(blob) & 0x3FFFFFFF)
    fdh_z = zlib.compress(fdh.tobytes())
    level_data = fdh_z + b"".join(blocks)
    linfo = _LEVELINFO.pack(len(level_data), len(fdh_z), nfaces)
    header = _HEADER.pack(MAGIC, 1, meshtype, datatype, -1, nchannels, 1,
                          nfaces, 0, len(finfo_z), 0, len(linfo),
                          len(level_data), 0, 0)
    with open(path, "wb") as f:
        f.write(header + finfo_z + linfo + level_data)


def bake_atlas(faces, res=None, tile=None):
    """Pack per-face textures into a square RGB atlas of fixed tiles.

    Returns (atlas [res,res,3], tiles_per_row, tile).  Faces beyond the
    atlas capacity reuse the last tile (logged by the caller)."""
    from pbrt_tpu_torch.textures.textures import RES
    res = res or RES
    if tile is None:
        tile = res
        while tile * tile > max(res * res // max(len(faces), 1), 16):
            tile //= 2
        tile = max(tile, 4)
    tpr = res // tile
    atlas = np.zeros((res, res, 3), np.float32)
    cap = tpr * tpr
    from pbrt_tpu_torch.textures.textures import _resize_bilinear
    for i, f in enumerate(faces[:cap]):
        if f.shape[2] == 1:
            f = np.repeat(f, 3, axis=2)
        t = _resize_bilinear(f[..., :3], tile, tile)
        r, c = (i // tpr) * tile, (i % tpr) * tile
        atlas[r:r + tile, c:c + tile] = t
    return atlas, tpr, tile
