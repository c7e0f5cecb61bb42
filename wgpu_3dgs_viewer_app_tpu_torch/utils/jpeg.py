"""Baseline JPEG encoder of the port's own, with no image library.

It writes what libjpeg (as Pillow calls it: `Image.save(f, "JPEG",
quality=q)`) writes for an 8-bit RGB image: a JFIF header, the Annex K
luma and chroma tables scaled by the IJG quality rule, 4:2:0 subsampling,
the standard Huffman tables and one interleaved baseline scan. Every stage
that could depend on the device is integer arithmetic, libjpeg's own:

- the fixed-point RGB -> YCbCr of `jccolor.c` (16 fraction bits);
- the h2v2 chroma downsampling of `jcsample.c` (bias 1, 2, 1, 2 along a
  row), with the edges replicated as `jcprepct.c` and `jcsample.c` do;
- the `islow` integer DCT of `jfdctint.c` and libjpeg-turbo's quantisation
  by a reciprocal (`jcdctmgr.c::compute_reciprocal`);
- the dummy blocks of `jccoefct.c` that fill the last MCU row and column
  (no AC, the DC of the block before).

Those stages run as torch integer ops on the frame's device, so one frame
gives the same bytes on a card and on the CPU; only the nonzero quantised
coefficients are copied to the host. The entropy coder (zig-zag runs,
Huffman codes, bit packing and 0xFF stuffing) is vectorised numpy on the
host, with no Python loop over blocks.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F

from . import trace

# Annex K, Tables K.1 and K.2, in natural (row-major) order.
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# Annex K.3, Tables K.3-K.6: the 16 code counts by length, then the symbols.
_DC_LUMA = bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b")
_DC_CHROMA = bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b")
_AC_LUMA = bytes.fromhex(
    "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
    "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
    "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = bytes.fromhex(
    "0002010204040304070504040001027700010203110405213106124151076171132232810814"
    "4291a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445"
    "464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
    "d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")

# ZIGZAG[k]: the natural index of the k-th coefficient in zig-zag order.
ZIGZAG = np.array(sorted(range(64), key=lambda p: (p // 8 + p % 8,
                                                   (p // 8) if (p // 8 + p % 8) % 2 else -(p // 8))),
                  np.int64)

# jccolor.c: FIX(x) = x * 2^16 rounded; Cb and Cr round by 0.5 - epsilon.
_SCALEBITS = 16


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS

# jfdctint.c: 13 fraction bits for the constants, 2 extra bits after pass 1.
_CONST_BITS, _PASS1_BITS = 13, 2
_C0_298, _C0_390, _C0_541, _C0_765 = 2446, 3196, 4433, 6270
_C0_899, _C1_175, _C1_501, _C1_847 = 7373, 9633, 12299, 15137
_C1_961, _C2_053, _C2_562, _C3_072 = 16069, 16819, 20995, 25172


def quant_tables(quality: int) -> np.ndarray:
    """(2, 64) luma and chroma tables in natural order: libjpeg's
    `jpeg_set_quality(quality, force_baseline=TRUE)`."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    t = (np.stack([_STD_LUMA_Q, _STD_CHROMA_Q]) * scale + 50) // 100
    return np.clip(t, 1, 255)


def _reciprocals(divisor: np.ndarray) -> tuple:
    """libjpeg-turbo's `compute_reciprocal` for 16-bit DCT elements: x / d
    rounded becomes ((x + corr) * recip) >> shift."""
    recip, corr, shift = (np.empty(divisor.size, np.int64) for _ in range(3))
    for i, d in enumerate(divisor.reshape(-1).tolist()):
        if d == 1:
            recip[i], corr[i], shift[i] = 1, 0, 0
            continue
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return tuple(v.reshape(divisor.shape) for v in (recip, corr, shift))


def frame_to_u8(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) f32 in [0, 1] -> uint8 on the same device: the multiply by
    255, clamp and truncation of `np.clip(img * 255.0, 0, 255).astype(np.uint8)`."""
    return (img.float() * 255.0).clamp_(0.0, 255.0).to(torch.uint8)


def scaled_size(width: int, height: int, scale: float) -> tuple:
    """The (width, height) a `scale` gives, as the JAX server's resize rounds it."""
    return max(1, round(width * scale)), max(1, round(height * scale))


def resize_u8(u8: torch.Tensor, scale: float) -> torch.Tensor:
    """Bicubic resize with antialiasing (the filter of Pillow's default
    `resize`) on the image's device: like Pillow, a horizontal pass rounded
    to uint8, then a vertical one; each in f32 (Pillow: fixed point)."""
    h, w = u8.shape[:2]
    nw, nh = scaled_size(w, h, scale)
    x = u8.permute(2, 0, 1)[None].float()
    for size in ((h, nw), (nh, nw)):
        x = F.interpolate(x, size=size, mode="bicubic", antialias=True, align_corners=False)
        x = x.round_().clamp_(0.0, 255.0)
    return x[0].permute(1, 2, 0).to(torch.uint8).contiguous()


def _rows_cols(plane: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Extend (..., h, w) planes to (..., rows, cols) by repeating their last
    row and column."""
    h, w = plane.shape[-2:]
    dev = plane.device
    ri = torch.arange(rows, device=dev).clamp_(max=h - 1)
    ci = torch.arange(cols, device=dev).clamp_(max=w - 1)
    return plane.index_select(-2, ri).index_select(-1, ci)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., 8 R, 8 C) samples -> (... * R * C, 8, 8) blocks in raster order,
    centred on 0."""
    r, c = plane.shape[-2] // 8, plane.shape[-1] // 8
    b = plane.reshape(-1, r, 8, c, 8).permute(0, 1, 3, 2, 4)
    return b.reshape(-1, 8, 8) - 128


def _fdct_sums(d) -> list:
    """The 8 sums of one `jpeg_fdct_islow` pass before their descaling, for
    inputs d[0..7]: a linear map with integer weights (outputs 0 and 4 are
    pass 1's before its << PASS1_BITS)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _C0_541
    out2, out6 = z1 + tmp13 * _C0_765, z1 - tmp12 * _C1_847
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _C1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _C0_298, tmp5 * _C2_053, tmp6 * _C3_072, tmp7 * _C1_501
    z1, z2 = z1 * -_C0_899, z2 * -_C2_562
    z3, z4 = z3 * -_C1_961 + z5, z4 * -_C0_390 + z5
    return [tmp10 + tmp11, tmp7 + z1 + z4, out2, tmp6 + z2 + z3,
            tmp10 - tmp11, tmp5 + z2 + z4, out6, tmp4 + z1 + z3]


# The pass as weights W[out, in] (the sums on the unit vectors), and each
# pass's descaling of output k: (sum + bias) >> shift. Pass 1 shifts its
# outputs 0 and 4 left by PASS1_BITS instead of descaling them.
_FDCT_W = np.stack(_fdct_sums(np.eye(8, dtype=np.int64)))
_EVEN04 = np.arange(8) % 4 == 0
_PASS1_W = _FDCT_W * np.where(_EVEN04, 1 << _PASS1_BITS, 1)[:, None]
_PASS1_SHIFT = np.where(_EVEN04, 0, _CONST_BITS - _PASS1_BITS)
_PASS2_SHIFT = np.where(_EVEN04, _PASS1_BITS, _CONST_BITS + _PASS1_BITS)


def _constant(a: np.ndarray, dev) -> torch.Tensor:
    """A constant table on the frame's device. From pageable memory: on a
    card the copy waits for the stream."""
    with trace.host_read(dev.type == "cuda"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _fdct_pass(x: torch.Tensor, weights: np.ndarray, shift: np.ndarray) -> torch.Tensor:
    """One pass along the last axis, in int64. Every sum is the integer that
    libjpeg's butterfly computes, so the result is exact on any device."""
    dev = x.device
    w = _constant(weights, dev)
    sh = _constant(shift, dev)
    bias = _constant(np.where(shift > 0, 1 << np.maximum(shift - 1, 0), 0), dev)
    return ((x.unsqueeze(-2) * w).sum(-1) + bias) >> sh


def _dct_quantize(blocks: torch.Tensor, table: torch.Tensor, quality: int) -> torch.Tensor:
    """islow DCT then quantisation: (n, 8, 8) centred samples -> (n, 64)
    quantised coefficients in zig-zag order, block i by table `table[i]`
    (0 luma, 1 chroma)."""
    x = _fdct_pass(blocks.long(), _PASS1_W, _PASS1_SHIFT).transpose(-1, -2)
    coef = _fdct_pass(x, _FDCT_W, _PASS2_SHIFT).transpose(-1, -2).reshape(-1, 64)
    dev = coef.device
    coef = coef[:, _constant(ZIGZAG, dev)]
    recip, corr, shift = (_constant(v[:, ZIGZAG], dev)[table]
                          for v in _reciprocals(quant_tables(quality) * 8))
    mag = ((coef.abs() + corr) * recip) >> shift
    return torch.where(coef < 0, -mag, mag)


def mcu_grid(width: int, height: int) -> tuple:
    """(MCU rows, MCU columns, luma block rows, luma block columns) of a 4:2:0 image."""
    return -(-height // 16), -(-width // 16), -(-height // 8), -(-width // 8)


def coefficients(u8: torch.Tensor, quality: int) -> torch.Tensor:
    """The device stages: (H, W, 3) uint8 -> (MCUs * 6, 64) int16 quantised
    coefficients in zig-zag order, in the scan's block order (per MCU the 4
    luma blocks, Cb, Cr). The luma blocks past the image's last block row
    or column (dummy blocks) are zero here; `entropy_code` codes them as
    libjpeg does."""
    h, w = u8.shape[:2]
    mr, mc, hb, wb = mcu_grid(w, h)
    dev = u8.device
    r, g, b = u8.to(torch.int32).permute(2, 0, 1)
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> _SCALEBITS
    off = _CBCR_OFFSET + _ONE_HALF - 1
    cbcr = torch.stack([-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b,
                        _fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b])
    cbcr = (cbcr + off) >> _SCALEBITS
    # Chroma: rows to an even count and columns to whole MCUs, then 2x2 sums
    # with libjpeg's bias of 1, 2, 1, 2 along a row, then rows to whole MCUs.
    cbcr = _rows_cols(cbcr, h + (h & 1), mc * 16)
    cbcr = cbcr.reshape(2, -1, 2, mc * 8, 2).sum(dim=(2, 4), dtype=torch.int32)
    cbcr = (cbcr + _constant(np.array([1, 2], np.int32), dev).repeat(mc * 4)) >> 2
    blocks = torch.cat([_blocks(_rows_cols(y, hb * 8, wb * 8)),
                        _blocks(_rows_cols(cbcr, mr * 8, mc * 8))])
    table = torch.zeros(blocks.shape[0], dtype=torch.long, device=dev)
    table[hb * wb:] = 1
    q = _dct_quantize(blocks, table, quality).to(torch.int16)
    # Dummy luma blocks fill the grid to whole MCUs.
    yq = F.pad(q[: hb * wb].reshape(hb, wb, 64), (0, 0, 0, 2 * mc - wb, 0, 2 * mr - hb))
    yq = yq.reshape(mr, 2, mc, 2, 64).permute(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    cq = q[hb * wb:].reshape(2, mr, mc, 64).permute(1, 2, 0, 3)
    return torch.cat([yq, cq], dim=2).reshape(-1, 64)


def nonzero_coefficients(coef: torch.Tensor) -> tuple:
    """The nonzero entries of `coefficients`' output, on its device: (flat
    index int32 in block * 64 + zig-zag position order, value int16)."""
    flat = coef.reshape(-1)
    with trace.host_read(flat.is_cuda):   # the count sizes the result
        idx = torch.nonzero(flat).reshape(-1)
    return idx.to(torch.int32), flat[idx]


def _huffman(spec: bytes) -> tuple:
    """Code and length of every symbol of a DHT spec (Annex C)."""
    counts, symbols = spec[:16], spec[16:]
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DC_CODES = [_huffman(_DC_LUMA), _huffman(_DC_CHROMA)]
_AC_CODES = [_huffman(_AC_LUMA), _huffman(_AC_CHROMA)]
# Magnitude category (bit length) of |v| for |v| < 2^11.
_NBITS = np.array([0] + [int(v).bit_length() for v in range(1, 1 << 11)], np.int64)


def _table(a: list, t: np.ndarray, sym: np.ndarray) -> tuple:
    """Per-item (code, length) from a luma/chroma pair of tables."""
    (c0, l0), (c1, l1) = a
    return np.where(t, c1[sym], c0[sym]), np.where(t, l1[sym], l0[sym])


def _items(idx: np.ndarray, val: np.ndarray, width: int, height: int) -> tuple:
    """The scan as a sequence of bit strings (value, length), one for each
    DC, one for each nonzero AC (with its ZRL codes before it) and one for
    each EOB, in scan order, from the nonzero coefficients (`idx`, `val`)."""
    mr, mc, hb, wb = mcu_grid(width, height)
    nb = mr * mc * 6
    idx = idx.astype(np.int64)
    val = val.astype(np.int64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
    chroma = comp > 0
    # Dummy luma blocks: block (i, j) of an MCU lies past row hb or column wb.
    rr, cc = np.meshgrid(np.arange(mr), np.arange(mc), indexing="ij")
    by = (2 * rr[..., None] + np.array([0, 0, 1, 1])).reshape(-1, 4)
    bx = (2 * cc[..., None] + np.array([0, 1, 0, 1])).reshape(-1, 4)
    dummy = np.zeros((mr * mc, 6), bool)
    dummy[:, :4] = (by >= hb) | (bx >= wb)
    dummy = dummy.reshape(-1)
    # DC differences per component over its real blocks; a dummy block's DC
    # is the one before it, so its difference is 0.
    is_dc = (idx & 63) == 0
    dc = np.zeros(nb, np.int64)
    dc[idx[is_dc] >> 6] = val[is_dc]
    diff = np.zeros(nb, np.int64)
    for c in range(3):
        real = np.flatnonzero((comp == c) & ~dummy)
        diff[real] = np.diff(dc[real], prepend=0)
    # Nonzero AC coefficients, in block then zig-zag order.
    blk, k, v = idx[~is_dc] >> 6, idx[~is_dc] & 63, val[~is_dc]
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    run = k - np.where(first, 0, np.roll(k, 1)) - 1
    n_ac = np.bincount(blk, minlength=nb)
    last = np.flatnonzero(np.append(blk[1:] != blk[:-1], True)) if blk.size else blk
    last_k = np.zeros(nb, np.int64)
    last_k[blk[last]] = k[last]
    eob = last_k < 63
    # Item slots: DC, the block's AC items, its EOB.
    count = 1 + n_ac + eob
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    bits = np.zeros(int(count.sum()), np.int64)
    length = np.zeros(bits.size, np.int64)
    # DC items: code of the category, then the category's bits.
    s = _NBITS[np.abs(diff)]
    code, ln = _table(_DC_CODES, chroma, s)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    bits[start] = (code << s) | extra
    length[start] = ln + s
    # AC items: (run mod 16, category) code after run // 16 ZRL codes.
    t = chroma[blk]
    s = _NBITS[np.abs(v)]
    code, ln = _table(_AC_CODES, t, (run & 15) * 16 + s)
    extra = np.where(v < 0, v - 1, v) & ((1 << s) - 1)
    zcode, zlen = _table(_AC_CODES, t, np.full(blk.size, 0xF0))
    n_zrl = run >> 4
    zrl = np.zeros(blk.size, np.int64)
    for i in range(3):  # at most 3 ZRLs: a run is at most 62
        zrl = np.where(n_zrl > i, (zrl << zlen) | zcode, zrl)
    rank = np.arange(blk.size) - np.concatenate([[0], np.cumsum(n_ac)[:-1]])[blk]
    pos = start[blk] + 1 + rank
    bits[pos] = (((zrl << ln) | code) << s) | extra
    length[pos] = n_zrl * zlen + ln + s
    # EOB items.
    e = np.flatnonzero(eob)
    code, ln = _table(_AC_CODES, chroma[e], np.zeros(e.size, np.int64))
    bits[start[e] + count[e] - 1] = code
    length[start[e] + count[e] - 1] = ln
    return bits.astype(np.uint64), length


def _pack(val: np.ndarray, length: np.ndarray) -> bytes:
    """Concatenate bit strings of at most 64 bits, MSB first; pad the last
    byte with 1 bits and stuff a 0x00 after every 0xFF byte."""
    off = np.concatenate([[0], np.cumsum(length)])
    n_bits = int(off[-1])
    off = off[:-1]
    word = off >> 6
    used = (off & 63).astype(np.uint64)
    ln = length.astype(np.uint64)
    end = used + ln
    fits = end <= 64
    # A string's part in its first word; where it crosses into the next
    # word, the rest goes there (one string at most crosses each boundary).
    head = np.where(fits, val << np.where(fits, 64 - end, 0).astype(np.uint64),
                    val >> np.where(fits, 0, end - 64).astype(np.uint64))
    starts = np.flatnonzero(np.diff(word, prepend=-1))
    words = np.add.reduceat(head, starts) if val.size else np.zeros(0, np.uint64)
    n_words = (n_bits + 63) // 64
    words = np.concatenate([words, np.zeros(n_words + 1 - words.size, np.uint64)])
    cross = np.flatnonzero(~fits)
    words[word[cross] + 1] += val[cross] << (128 - end[cross])
    pad = (-n_bits) % 8
    out = np.frombuffer(words.astype(">u8").tobytes(), np.uint8)[: (n_bits + pad) // 8].copy()
    if pad:
        out[-1] |= (1 << pad) - 1
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _header(width: int, height: int, qt: np.ndarray) -> bytes:
    """SOI, JFIF APP0, the two DQTs, SOF0, the four DHTs and SOS, as
    libjpeg writes them."""
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i in range(2):
        out.append(_marker(0xDB, bytes([i]) + qt[i][ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, spec in ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
                         (0x11, _AC_CHROMA)):
        out.append(_marker(0xC4, bytes([cls_id]) + spec))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


def entropy_code(idx: np.ndarray, val: np.ndarray, width: int, height: int,
                 quality: int) -> bytes:
    """The host stages: `nonzero_coefficients`' output (numpy) -> the JPEG file."""
    bits, length = _items(idx, val, width, height)
    return _header(width, height, quant_tables(quality)) + _pack(bits, length) + b"\xff\xd9"


def encode_jpeg(u8, quality: int = 85) -> bytes:
    """(H, W, 3) uint8 (a tensor on any device, or numpy) -> JPEG bytes.
    Spans: the device stages (`jpeg.device`: issued, and waited for where
    the nonzero count is read), the copy of the nonzero coefficients to the
    host (`jpeg.copy`) and the entropy coder (`jpeg.entropy`)."""
    if not torch.is_tensor(u8):
        u8 = torch.from_numpy(np.ascontiguousarray(u8, np.uint8))
    h, w = u8.shape[:2]
    with trace.span("jpeg.device"):
        idx, val = nonzero_coefficients(coefficients(u8, quality))
    with trace.span("jpeg.copy"):
        with trace.host_read(u8.is_cuda):
            idx = idx.cpu().numpy()
        with trace.host_read(u8.is_cuda):
            val = val.cpu().numpy()
    with trace.span("jpeg.entropy"):
        return entropy_code(idx, val, w, h, quality)


def encode_frame(img: torch.Tensor, quality: int = 85, scale: float = 1.0) -> bytes:
    """A rendered (H, W, 3) f32 frame -> JPEG bytes: uint8 on its device,
    the optional resize (both in `jpeg.device`), then `encode_jpeg`."""
    with trace.span("jpeg.device"):
        u8 = frame_to_u8(img)
        if scale != 1.0:
            u8 = resize_u8(u8, scale)
    return encode_jpeg(u8, quality)
