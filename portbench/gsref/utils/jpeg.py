"""The integer stages of the port's baseline JPEG encoder, frozen: an
8-bit RGB frame -> its quantised DCT coefficients as libjpeg computes
them (the fixed-point RGB -> YCbCr of `jccolor.c`, the h2v2 chroma
downsampling of `jcsample.c`, the `islow` DCT of `jfdctint.c` and
libjpeg-turbo's quantisation by a reciprocal), in the scan's block order.
The entropy coding is not copied: `jpeg_decode` reads a served file's
coefficients back for the comparison."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Annex K, Tables K.1 and K.2, in natural (row-major) order.
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)


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


def _fdct_pass(x: torch.Tensor, weights: np.ndarray, shift: np.ndarray) -> torch.Tensor:
    """One pass along the last axis, in int64. Every sum is the integer that
    libjpeg's butterfly computes, so the result is exact on any device."""
    dev = x.device
    w = torch.from_numpy(weights).to(dev)
    sh = torch.from_numpy(shift).to(dev)
    bias = torch.from_numpy(np.where(shift > 0, 1 << np.maximum(shift - 1, 0), 0)).to(dev)
    return ((x.unsqueeze(-2) * w).sum(-1) + bias) >> sh


def _dct_quantize(blocks: torch.Tensor, table: torch.Tensor, quality: int) -> torch.Tensor:
    """islow DCT then quantisation: (n, 8, 8) centred samples -> (n, 64)
    quantised coefficients in zig-zag order, block i by table `table[i]`
    (0 luma, 1 chroma)."""
    x = _fdct_pass(blocks.long(), _PASS1_W, _PASS1_SHIFT).transpose(-1, -2)
    coef = _fdct_pass(x, _FDCT_W, _PASS2_SHIFT).transpose(-1, -2).reshape(-1, 64)
    dev = coef.device
    coef = coef[:, torch.from_numpy(ZIGZAG).to(dev)]
    recip, corr, shift = (torch.from_numpy(v[:, ZIGZAG]).to(dev)[table]
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
    cbcr = (cbcr + torch.tensor([1, 2], dtype=torch.int32, device=dev).repeat(mc * 4)) >> 2
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

