"""Quantised pod compression configs and the flat u32-word pod.

The eight configs (SH single/half/norm8/remove x cov3d single/half) and the
host-side pack are those of `wgpu_3dgs_viewer_app_tpu.data.compression`.
The port keeps one device layout, the flat word pod, splat axis last:

  pos      (3, N) f32
  color0   (N,)   u32  r | g<<8 | b<<16 | a<<24; rgb = clamp(0.5 + C0*sh0),
                       a = sigmoid(opacity), all u8. Empty slots have a = 0.
  sh       SINGLE (45, N) f32 | HALF (23, N) u32, f16 pairs (2j | 2j+1 << 16)
           | NORM8 (12, N) u32, u8 quads (4j..4j+3, LSB first) plus
           sh_mn, sh_span (N,) f32 | REMOVE absent
  cov3d    SINGLE (6, N) f32 | HALF (3, N) u32, f16 pairs

On a device, u32 words are int32 tensors with the same bit pattern
(`pod_to_tensors`); the kernels read them as `uint32_t`, the plain path
widens them to int64 (`core.f16.u32`).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..core.covariance import cov3d_from_scale_rot
from ..core.f16 import f16_bits_to_f32, u32, unpack2xf16
from ..core.sh import SH_C0
from .gaussian import Gaussians, sigmoid


class ShCompression(enum.Enum):
    SINGLE = "single"
    HALF = "half"
    NORM8 = "norm8"
    REMOVE = "remove"


class Cov3dCompression(enum.Enum):
    SINGLE = "single"
    HALF = "half"


# Per-splat byte sizes of each field.
POS_FIELD_SIZE = 12
COLOR_FIELD_SIZE = 4
SH_FIELD_SIZES = {
    ShCompression.SINGLE: 45 * 4,
    ShCompression.HALF: 45 * 2,
    ShCompression.NORM8: 45 * 1 + 8,  # u8 coeffs + f32 min/span
    ShCompression.REMOVE: 0,
}
COV3D_FIELD_SIZES = {
    Cov3dCompression.SINGLE: 6 * 4,
    Cov3dCompression.HALF: 6 * 2,
}


@dataclasses.dataclass(frozen=True)
class Compressions:
    """Compression selection; the default is norm8 SH with half cov3d."""

    sh: ShCompression = ShCompression.NORM8
    cov3d: Cov3dCompression = Cov3dCompression.HALF

    def bytes_per_splat(self) -> int:
        return (POS_FIELD_SIZE + COLOR_FIELD_SIZE + SH_FIELD_SIZES[self.sh]
                + COV3D_FIELD_SIZES[self.cov3d])

    def compressed_size(self, gaussian_count: int) -> int:
        return gaussian_count * self.bytes_per_splat()


ALL_COMPRESSIONS = tuple(
    Compressions(sh=s, cov3d=c) for s in ShCompression for c in Cov3dCompression
)


def _pack_f16_pairs(a: np.ndarray) -> np.ndarray:
    """(k, N) f16 -> (ceil(k/2), N) u32, word j = coeff 2j | coeff 2j+1 << 16."""
    k, n = a.shape
    u = a.view(np.uint16).astype(np.uint32)
    if k % 2:
        u = np.concatenate([u, np.zeros((1, n), np.uint32)])
    return u[0::2] | (u[1::2] << 16)


def _pack_u8_quads(a: np.ndarray) -> np.ndarray:
    """(k, N) u8 -> (ceil(k/4), N) u32, word j = coeffs 4j..4j+3, LSB first."""
    k, n = a.shape
    pad = (-k) % 4
    if pad:
        a = np.concatenate([a, np.zeros((pad, n), np.uint8)])
    u = a.astype(np.uint32)
    return u[0::4] | (u[1::4] << 8) | (u[2::4] << 16) | (u[3::4] << 24)


def flat_pod_to_words(pod: dict, comp: Compressions) -> dict:
    """Flat raw pod (f16/u8 dtypes) -> flat u32-word pod (splat axis last)."""
    out = {"pos": pod["pos"].astype(np.float32), "color0": pod["color0"]}
    if comp.sh == ShCompression.SINGLE:
        out["sh"] = pod["sh"].astype(np.float32)
    elif comp.sh == ShCompression.HALF:
        out["sh"] = _pack_f16_pairs(pod["sh"])
    elif comp.sh == ShCompression.NORM8:
        out["sh"] = _pack_u8_quads(pod["sh"])
        out["sh_mn"] = pod["sh_mn"]
        out["sh_span"] = pod["sh_span"]
    if comp.cov3d == Cov3dCompression.SINGLE:
        out["cov3d"] = pod["cov3d"].astype(np.float32)
    else:
        out["cov3d"] = _pack_f16_pairs(pod["cov3d"].astype(np.float16))
    return out


def pack_gaussians(g: Gaussians, comp: Compressions) -> dict:
    """Host-side pack: raw SoA -> flat raw pod (numpy; f16/u8 dtypes where
    compressed). `flat_pod_to_words` turns it into the word pod."""
    n = g.count
    pos = np.ascontiguousarray(g.pos.astype(np.float32).T)  # (3, N)
    rgb = np.clip(0.5 + SH_C0 * g.sh0, 0.0, 1.0)
    alpha = sigmoid(g.opacity)
    q8 = np.round(rgb * 255.0).astype(np.uint32)
    a8 = np.round(alpha * 255.0).astype(np.uint32)
    color0 = (q8[:, 0] | (q8[:, 1] << 8) | (q8[:, 2] << 16) | (a8 << 24)).astype(np.uint32)

    sh_flat = np.ascontiguousarray(g.sh_rest.reshape(n, 45).astype(np.float32).T)  # (45, N)
    out = {"pos": pos, "color0": color0}
    if comp.sh == ShCompression.SINGLE:
        out["sh"] = sh_flat
    elif comp.sh == ShCompression.HALF:
        out["sh"] = sh_flat.astype(np.float16)
    elif comp.sh == ShCompression.NORM8:
        mn = sh_flat.min(axis=0) if n else np.zeros(0, np.float32)
        mx = sh_flat.max(axis=0) if n else np.zeros(0, np.float32)
        span = np.maximum(mx - mn, 1e-12)
        q = np.round((sh_flat - mn[None, :]) / span[None, :] * 255.0).astype(np.uint8)
        out["sh"] = q
        out["sh_mn"] = mn.astype(np.float32)
        out["sh_span"] = span.astype(np.float32)

    scale_lin = torch.from_numpy(np.exp(g.scale.astype(np.float32)))
    cov6 = cov3d_from_scale_rot(scale_lin, torch.from_numpy(g.rot.astype(np.float32)))
    cov6 = np.ascontiguousarray(cov6.numpy().T)  # (6, N)
    if comp.cov3d == Cov3dCompression.SINGLE:
        out["cov3d"] = cov6.astype(np.float32)
    else:
        out["cov3d"] = cov6.astype(np.float16)
    return out


def pod_to_tensors(words: dict, device) -> dict:
    """Word pod (numpy) -> device tensors: u32 fields as int32 bit patterns."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32) if v.dtype == np.uint32
                            else np.ascontiguousarray(v, np.float32)).to(device)
        for k, v in words.items()
    }


# --- plain-path decoders over the device word pod --------------------------


def make_sh_coeff_fn(pod: dict, comp: Compressions):
    """Per-coefficient dequantiser: (k, c) -> (N,) f32."""
    if comp.sh == ShCompression.REMOVE:
        zero = torch.zeros(pod["color0"].shape[-1], dtype=torch.float32,
                           device=pod["color0"].device)
        return lambda k, c: zero
    sh = pod["sh"]
    if comp.sh == ShCompression.NORM8:
        mn = pod["sh_mn"]
        scale = pod["sh_span"] * (1.0 / 255.0)

        def coeff(k, c):
            i = k * 3 + c
            q = (u32(sh[i // 4]) >> (8 * (i % 4))) & 0xFF
            return q.to(torch.float32) * scale + mn

        return coeff
    if comp.sh == ShCompression.HALF:

        def coeff(k, c):
            i = k * 3 + c
            return f16_bits_to_f32((u32(sh[i // 2]) >> (16 * (i % 2))) & 0xFFFF)

        return coeff
    return lambda k, c: sh[k * 3 + c]


def cov3d_components(pod: dict) -> tuple:
    """Six (N,) f32 covariance uniques (xx, xy, xz, yy, yz, zz)."""
    c = pod["cov3d"]
    if c.dtype == torch.int32:
        out = []
        for j in range(3):
            out += list(unpack2xf16(u32(c[j])))
        return tuple(out)
    return tuple(c[i] for i in range(6))


def unpack_color0(pod: dict) -> tuple:
    """Packed u32 rgba -> ((r, g, b) (N,) f32 in [0, 1], alpha (N,) f32)."""
    w = u32(pod["color0"])
    r, g, b, a = (((w >> s) & 0xFF).to(torch.float32) * (1.0 / 255.0) for s in (0, 8, 16, 24))
    return (r, g, b), a
