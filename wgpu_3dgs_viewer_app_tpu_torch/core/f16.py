"""Integer f16 codec on int64 tensors holding u32 words.

This is NOT IEEE round-to-nearest-even: it reproduces the repo's packed
format bit for bit (`wgpu_3dgs_viewer_app_tpu.core.f16`): the mantissa
rounds half-up, subnormals flush to signed zero, and overflow clamps to the
f16 maximum 0x7BFF. `csrc/common.cuh` carries the same routine for the
kernels.

u32 words travel as int64 values in [0, 2**32) on the plain path: torch's
uint32 tensors reject `>>` and comparisons on the CPU.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & U32_MASK


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 tensor with the same 32-bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f16 bit pattern in the low 16 bits of an int64."""
    b = u32(x.to(torch.float32).contiguous().view(torch.int32))
    sign = (b >> 16) & 0x8000
    exp = (b >> 23) & 0xFF
    mant = b & 0x7FFFFF
    # Round the mantissa to 10 bits (half-up), carrying into the exponent.
    mant_r = (mant + 0x1000) >> 13
    carry = mant_r >> 10
    mant_h = torch.where(carry > 0, torch.zeros_like(mant_r), mant_r) & 0x3FF
    exp_h = exp - 112 + carry
    half = sign | (exp_h.clamp(0, 30) << 10) | mant_h
    half = torch.where(exp_h <= 0, sign, half)  # underflow -> signed 0
    return torch.where(exp_h > 30, sign | 0x7BFF, half)  # clamp to f16 max


def f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """f16 bit pattern (int64, low 16 bits) -> f32; subnormals read as 0."""
    sign = (h & 0x8000) << 16
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF
    bits = sign | ((exp + 112) << 23) | (mant << 13)
    bits = torch.where(exp == 0, sign, bits)
    return as_i32(bits).view(torch.float32)


def pack2xf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 -> one u32 word (a in the low 16 bits, b in the high)."""
    return f32_to_f16_bits(a) | (f32_to_f16_bits(b) << 16)


def unpack2xf16(w: torch.Tensor) -> tuple:
    """One u32 word -> two f32 (low, high f16 halves)."""
    return f16_bits_to_f32(w & 0xFFFF), f16_bits_to_f32(w >> 16)
