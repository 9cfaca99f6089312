"""PNG reading and writing with numpy and zlib.

Covers what the dataset formats use: 8-bit grayscale (KITTI, EuRoC), 8-bit
RGB/RGBA (TUM) and 16-bit grayscale (depth maps), non-interlaced. Writing
uses filter type 0 on every row; reading undoes all five filter types.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 [H, W] gray, uint8 [H, W, 3] RGB or uint16 [H, W] gray."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype = 8, 0
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype = 8, 2
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
    else:
        raise ValueError(f"unsupported PNG image {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Decode to uint8 or uint16, [H, W] for gray and [H, W, C] otherwise."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (color type {ctype}, depth {depth}, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def read_gray(path) -> np.ndarray:
    """Float32 [H, W] grayscale in [0, 1] (ITU-R 601 luma for color)."""
    img = read_png(path)
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    img = img.astype(np.float32)
    if img.ndim == 3:  # gray + alpha, RGB or RGBA
        luma = np.array([0.299, 0.587, 0.114], np.float32)
        img = img[..., 0] if img.shape[2] == 2 else img[..., :3] @ luma
    return img / scale
