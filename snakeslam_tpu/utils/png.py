"""PNG reading and writing in numpy + zlib (no imaging library).

Covers what the dataset loaders and the viewer need: non-interlaced
8-bit gray, gray+alpha, RGB and RGBA, and 16-bit gray (depth maps).
Palette images and interlaced files raise ValueError.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters; returns (height, stride) uint8."""
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        ftype = rows[y, 0]
        line = rows[y, 1:]
        if ftype == 0:          # None
            cur = line.copy()
        elif ftype == 1:        # Sub: running sum along each byte lane
            lanes = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).ravel()
        elif ftype == 2:        # Up
            cur = line + prev
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = bytearray(stride)
            ln = line.tobytes()
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (ln[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), dtype=np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG: (H, W) for gray, (H, W, C) otherwise; uint8 at 8
    bits, uint16 at 16 bits."""
    data = Path(path).read_bytes()
    ihdr = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = ihdr
    if interlace != 0:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: color type {ctype}, "
                         f"bit depth {depth}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    px = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(height, width, ch)
    return img[:, :, 0] if ch == 1 else img


def to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 -> (H, W) uint8 luma, with the ITU-R 601 weights
    in the fixed-point form imaging libraries use (alpha is dropped)."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return img[:, :, 0]
    rgb = img[:, :, :3].astype(np.uint32)
    y = (rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
         + rgb[:, :, 2] * 7471 + 0x8000) >> 16
    return y.astype(np.uint8)


def write_png(path, img: np.ndarray) -> Path:
    """Encode (H, W) uint8/uint16 gray or (H, W, 3|4) uint8 color,
    unfiltered rows."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and img.ndim in (2, 3):
        depth = 8
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write {img.dtype} array of shape "
                         f"{img.shape} as PNG")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = (_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(out)
    return path
