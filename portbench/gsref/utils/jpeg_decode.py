"""A plain reader of baseline JPEG files: the quantised DCT coefficients of
every block, as the file codes them. It parses the file's own tables
(DQT, SOF0, DHT, SOS) and decodes the one interleaved Huffman scan, with
no inverse DCT: the benchmark compares a served frame's coefficients with
the reference's (`jpeg.coefficients`), so no rounding of a decoder stands
between the two."""

from __future__ import annotations

import struct

import numpy as np


class JpegError(ValueError):
    pass


def _lut(counts: bytes, symbols: bytes) -> list:
    """A 16-bit-peek lookup: value -> (symbol << 8) | code length."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            entry = (symbols[k] << 8) | length
            lut[lo:hi] = [entry] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _segments(blob: bytes):
    if blob[:2] != b"\xff\xd8":
        raise JpegError("no SOI")
    i = 2
    while i < len(blob):
        if blob[i] != 0xFF:
            raise JpegError(f"no marker at {i}")
        code = blob[i + 1]
        if code == 0xD9:
            return
        length = struct.unpack(">H", blob[i + 2:i + 4])[0]
        yield code, blob[i + 4:i + 2 + length], i + 2 + length
        i += 2 + length


def _scan_end(blob: bytes, start: int) -> int:
    i = start
    while True:
        i = blob.index(b"\xff", i)
        if blob[i + 1] != 0x00:
            return i
        i += 2


def decode_coefficients(blob: bytes) -> tuple:
    """(width, height, sampling, coefficients): the quantised coefficients
    as an (MCUs * blocks per MCU, 64) int32 array in zig-zag order, the
    blocks in scan order (per MCU each component's blocks in turn)."""
    dht, comps, size = {}, [], None
    scan = None
    for code, body, end in _segments(blob):
        if code == 0xC0:
            _, h, w, n = struct.unpack(">BHHB", body[:6])
            size = (w, h)
            comps = [(body[6 + 3 * c], body[7 + 3 * c] >> 4, body[7 + 3 * c] & 15)
                     for c in range(n)]
        elif code in (0xC1, 0xC2, 0xC3):
            raise JpegError("not a baseline file")
        elif code == 0xC4:
            j = 0
            while j < len(body):
                tc_th = body[j]
                counts = body[j + 1:j + 17]
                nsym = sum(counts)
                dht[tc_th] = _lut(counts, body[j + 17:j + 17 + nsym])
                j += 17 + nsym
        elif code == 0xDA:
            n = body[0]
            tables = {body[1 + 2 * c]: body[2 + 2 * c] for c in range(n)}
            scan = (tables, end)
            break
    if size is None or scan is None:
        raise JpegError("no frame or no scan")
    tables, start = scan
    data = blob[start:_scan_end(blob, start)].replace(b"\xff\x00", b"\xff")
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    nb = bits.size
    padded = np.concatenate([bits, np.ones(32, np.uint8)]).astype(np.uint32)
    peek = np.zeros(nb + 16, np.uint32)
    for k in range(16):
        peek |= padded[k:k + nb + 16] << (15 - k)
    peek = peek.tolist()

    w, h = size
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcus = -(-w // (8 * hmax)) * -(-h // (8 * vmax))
    order = []  # per block of an MCU: (component index, DC table, AC table)
    for ci, (cid, hs, vs) in enumerate(comps):
        td_ta = tables[cid]
        order += [(ci, dht[td_ta >> 4], dht[0x10 | (td_ta & 15)])] * (hs * vs)
    out = np.zeros((mcus * len(order), 64), np.int32)
    pred = [0] * len(comps)
    pos = 0
    row = 0
    for _ in range(mcus):
        for ci, dc, ac in order:
            e = dc[peek[pos]]
            pos += e & 0xFF
            s = e >> 8
            diff = 0
            if s:
                v = peek[pos] >> (16 - s)
                pos += s
                diff = v if v >= 1 << (s - 1) else v - (1 << s) + 1
            pred[ci] += diff
            blk = out[row]
            blk[0] = pred[ci]
            k = 1
            while k < 64:
                e = ac[peek[pos]]
                pos += e & 0xFF
                rs = e >> 8
                r, s = rs >> 4, rs & 15
                if s == 0:
                    if r != 15:
                        break
                    k += 16
                    continue
                k += r
                v = peek[pos] >> (16 - s)
                pos += s
                blk[k] = v if v >= 1 << (s - 1) else v - (1 << s) + 1
                k += 1
            row += 1
    if pos > nb:
        raise JpegError("the scan ended early")
    return w, h, [(c[1], c[2]) for c in comps], out
