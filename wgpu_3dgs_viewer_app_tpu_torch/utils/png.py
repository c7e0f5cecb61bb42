"""Minimal PNG codec (zlib + numpy): 8-bit grayscale, RGB and RGBA.

Writing uses filter type 0; reading undoes all five PNG row filters, so
PNGs written by other encoders load too. No image library is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, C) uint8 array (C = 1, 3 or 4)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG -> (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNGs are supported")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # Sub, Average and Paeth depend on the reconstructed left pixel
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                up = prev[i]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[i - c] if i >= c else 0
                    pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c).astype(np.uint8)
