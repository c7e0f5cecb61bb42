"""Tile-local front-to-back alpha compositing of the sorted entries.

`composite_tiles_v2` is the counterpart of the JAX package's
`composite_tiles_pallas_v2`. On CUDA entries it launches kernel K3
(`csrc/composite.cu`); on CPU entries it runs the plain version,
`composite_tiles_plain_v2`, a port of `composite_tiles_jnp_v2`: per tile,
chunks of 128 entries aligned to the global entry order, alpha as a
(pixels, entries) matrix, transmittance by a cumulative product along the
entries, and an exit once every pixel of the tile has T <= 1/255.

Alpha per entry and pixel: op * 2^min(power2, 0) in splat mode, with the
conic rows pre-scaled by -0.5 * log2(e); in ellipse/point mode the flat
opacity inside the 2-sigma cut. Alpha below 1/255 is dropped. The output
is (H, W, 4) f32: premultiplied RGB and A = 1 - T.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.f16 import f16_bits_to_f32, u32, unpack2xf16
from . import kernels
from .binning import MEAN_FIX_BIAS, MEAN_FIX_SCALE, ROW, SortedEntries, TileConfig

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1.0 / 255.0
FLAT_POWER_CUTOFF = -2.0  # ellipse/point: flat fill inside the 2-sigma boundary
LOG2E = 1.4426950408889634
_TILES_PER_STEP = 256


def _u8_unit(w, shift):
    return ((w >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)


def _decode(chunk, live):
    """(..., C, 4) int64 words -> per-entry rows (op, mx, my, a2, b2, c2, r, g, b)."""
    key, p1, p2, p3 = chunk.unbind(-1)
    l2 = float(np.float32(LOG2E))
    s = float(np.float32(-0.5) * np.float32(LOG2E))
    op = torch.where(live, _u8_unit(key, 0), 0.0)
    inv = 1.0 / MEAN_FIX_SCALE
    mx = (p1 & 0xFFF).to(torch.float32) * inv - MEAN_FIX_BIAS
    my = ((p1 >> 12) & 0xFFF).to(torch.float32) * inv - MEAN_FIX_BIAS
    ca, cb = unpack2xf16(p2)
    cc = f16_bits_to_f32(p3 & 0xFFFF)
    return (op, mx, my, ca * s, cb * -l2, cc * s,
            _u8_unit(p3, 16), _u8_unit(p3, 24), _u8_unit(p1, 24))


def composite_tiles_plain_v2(entries: SortedEntries, cfg: TileConfig,
                             flat_mode: bool = False) -> torch.Tensor:
    """Plain version of K3. Tiles advance chunk by chunk together, at most
    _TILES_PER_STEP at a time (bounds the (tiles, pixels, 128) temporaries)."""
    tile, n_tiles = cfg.tile, cfg.n_tiles
    p = tile * tile
    ent = u32(entries.entries)
    dev = ent.device
    ent = torch.cat([ent, ent.new_zeros(((-ent.shape[0]) % ROW, 4))])
    starts = entries.tile_starts.to(torch.int64)
    ends = starts + entries.tile_counts.to(torch.int64)
    row0 = starts // ROW
    n_chunks = torch.where(ends > starts, (ends + ROW - 1) // ROW - row0, 0)
    lane = torch.arange(p, device=dev)
    px = ((lane % tile).to(torch.float32) + 0.5)[:, None]  # (P, 1) tile-local
    py = ((lane // tile).to(torch.float32) + 0.5)[:, None]
    col = torch.arange(ROW, device=dev)
    cut = float(np.float32(FLAT_POWER_CUTOFF * LOG2E))

    t_all = torch.ones((n_tiles, p, 1), device=dev)
    rgb_all = torch.zeros((n_tiles, p, 3), device=dev)
    max_chunks = int(n_chunks.max()) if n_tiles else 0
    for c in range(max_chunks):
        active = ((c < n_chunks) & (t_all.amax(dim=(1, 2)) > T_EPS)).nonzero().flatten()
        for g in range(0, active.numel(), _TILES_PER_STEP):
            idx = active[g:g + _TILES_PER_STEP]
            gidx = (row0[idx] + c)[:, None] * ROW + col  # (A, C) global entry index
            live = (gidx >= starts[idx, None]) & (gidx < ends[idx, None])
            op, mx, my, a2, b2, c2, r, gr, b = (v[:, None, :] for v in _decode(ent[gidx], live))
            dx = px - mx  # (A, P, C)
            dy = py - my
            power2 = (a2 * dx + b2 * dy) * dx + (c2 * dy) * dy
            if flat_mode:
                a = torch.where(power2 >= cut, op, 0.0)
            else:
                a = op * torch.exp2(torch.clamp_max(power2, 0.0))
            a = torch.where(a < ALPHA_EPS, 0.0, a)
            incl = torch.cumprod(1.0 - a, dim=-1)
            excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
            w = excl * a
            t = t_all[idx]
            sums = torch.stack([(w * r).sum(-1), (w * gr).sum(-1), (w * b).sum(-1)], dim=-1)
            rgb_all[idx] = rgb_all[idx] + t * sums
            t_all[idx] = t * incl[..., -1:]
    tiles = torch.cat([rgb_all, 1.0 - t_all], dim=-1)  # (T, P, 4)
    img = tiles.reshape(cfg.tiles_y, cfg.tiles_x, tile, tile, 4).permute(0, 2, 1, 3, 4)
    img = img.reshape(cfg.tiles_y * tile, cfg.tiles_x * tile, 4)
    return img[: cfg.height, : cfg.width]


def _composite_tiles_cuda(entries: SortedEntries, cfg: TileConfig, flat_mode: bool) -> torch.Tensor:
    lib = kernels.library()
    if cfg.tile * cfg.tile > 1024:
        raise ValueError(f"tile {cfg.tile}: the compositor runs one thread per pixel (<= 32x32)")
    ent = entries.entries
    kernels.require(ent, "entries", torch.int32, (ent.shape[0], 4))
    kernels.require(entries.tile_starts, "tile_starts", torch.int32, (cfg.n_tiles,))
    kernels.require(entries.tile_counts, "tile_counts", torch.int32, (cfg.n_tiles,))
    out = torch.empty((cfg.height, cfg.width, 4), dtype=torch.float32, device=ent.device)
    p = kernels.ptr
    kernels.check(lib.gs_composite(p(ent), p(entries.tile_starts), p(entries.tile_counts),
                                   cfg.n_tiles, cfg.tile, cfg.tiles_x, cfg.width, cfg.height,
                                   int(flat_mode), p(out), kernels.stream()), "gs_composite")
    kernels.LAUNCHES["composite"] += 1
    return out


def composite_tiles_v2(entries: SortedEntries, cfg: TileConfig,
                       flat_mode: bool = False) -> torch.Tensor:
    """SortedEntries -> (H, W, 4) premultiplied RGBA: kernel K3 on CUDA, the
    plain version on the CPU."""
    if entries.entries.device.type == "cpu":
        return composite_tiles_plain_v2(entries, cfg, flat_mode)
    return _composite_tiles_cuda(entries, cfg, flat_mode)


def over_background(img: torch.Tensor, background) -> torch.Tensor:
    """Premultiplied (H, W, 4) over an opaque background colour -> (H, W, 3)."""
    bg = torch.as_tensor(background, dtype=torch.float32, device=img.device)
    return img[..., :3] + (1.0 - img[..., 3:4]) * bg
