"""Tile-local front-to-back alpha compositing of the sorted entries: a
frozen copy of the port's plain compositor (`composite_tiles_plain_v2`),
the Horner form of the exponent only.

Per tile, chunks of 128 entries aligned to the global entry order, alpha
as a (pixels, entries) matrix, transmittance by a cumulative product along
the entries, and an exit once every pixel of the tile has T <= 1/255.
Alpha per entry and pixel: op * 2^min(power2, 0) in splat mode, with the
conic rows pre-scaled by -0.5 * log2(e); in ellipse/point mode the flat
opacity inside the 2-sigma cut. Alpha below 1/255 is dropped. The output
is (H, W, 4) f32: premultiplied RGB and A = 1 - T.

`dtype` is the precision of the blend arithmetic: float32 as the frame
states it, or a lower one for the benchmark's precision control.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.f16 import f16_bits_to_f32, u32, unpack2xf16
from .binning import MEAN_FIX_BIAS, MEAN_FIX_SCALE, ROW, SortedEntries, TileConfig

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1.0 / 255.0
FLAT_POWER_CUTOFF = -2.0  # ellipse/point: flat fill inside the 2-sigma boundary
LOG2E = 1.4426950408889634
_TILES_PER_STEP = 256


def _u8_unit(w, shift):
    return ((w >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)


def _tiles_to_image(tiles: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """(n_tiles, tile * tile, 4) per-tile pixels -> the (H, W, 4) image."""
    tile = cfg.tile
    img = tiles.reshape(cfg.tiles_y, cfg.tiles_x, tile, tile, 4).permute(0, 2, 1, 3, 4)
    img = img.reshape(cfg.tiles_y * tile, cfg.tiles_x * tile, 4)
    return img[: cfg.height, : cfg.width]


def _in_image(cfg: TileConfig, lane: torch.Tensor) -> torch.Tensor:
    """(n_tiles, tile * tile) bool: the tile pixel lies inside the image."""
    tid = torch.arange(cfg.n_tiles, device=lane.device)[:, None]
    return (((tid // cfg.tiles_x) * cfg.tile + lane // cfg.tile < cfg.height)
            & ((tid % cfg.tiles_x) * cfg.tile + lane % cfg.tile < cfg.width))


def _excl_incl(a: torch.Tensor) -> tuple:
    """Exclusive and inclusive cumulative products of 1 - a along the entries."""
    incl = torch.cumprod(1.0 - a, dim=-1)
    return torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1), incl


def _chunk_loop(cfg: TileConfig, n_chunks: torch.Tensor, blend,
                stats: dict | None, dtype=torch.float32) -> torch.Tensor:
    """The plain compositors' chunk loop: tiles advance one 128-entry chunk at a
    time together, at most _TILES_PER_STEP at a time (bounds the (tiles,
    pixels, 128) temporaries), while the tile has a chunk left and any of
    its pixels has T > T_EPS. `blend(c, idx)` gives chunk c of the tiles
    idx as alpha (A, P, C), r, g, b (A, 1, C) and live (A, C). Each pixel
    adds T * sum(excl * alpha * colour) and takes the chunk's product of
    (1 - alpha) into T. With `stats`, counts in stats["pairs"] the (pixel
    inside the image, live entry) blends this data needs: for each pixel,
    its live entries up to and including the one that brings its own T to
    <= T_EPS; in stats["rows"] the chunks the tiles read, and in
    stats["entries"] the live entries of those chunks."""
    p = cfg.tile * cfg.tile
    dev = n_chunks.device
    t_all = torch.ones((cfg.n_tiles, p, 1), device=dev, dtype=dtype)
    rgb_all = torch.zeros((cfg.n_tiles, p, 3), device=dev, dtype=dtype)
    if stats is not None:
        pairs = torch.zeros((), dtype=torch.int64, device=dev)
        entries = torch.zeros((), dtype=torch.int64, device=dev)
        rows = 0
        in_image = _in_image(cfg, torch.arange(p, device=dev))
    max_chunks = int(n_chunks.max()) if cfg.n_tiles else 0
    for c in range(max_chunks):
        active = ((c < n_chunks) & (t_all.amax(dim=(1, 2)) > T_EPS)).nonzero().flatten()
        for g in range(0, active.numel(), _TILES_PER_STEP):
            idx = active[g:g + _TILES_PER_STEP]
            a, r, gr, b, live = blend(c, idx)
            excl, incl = _excl_incl(a)
            w = excl * a
            t = t_all[idx]
            if stats is not None:
                pairs += (live[:, None, :] & (t * excl > T_EPS) & in_image[idx][..., None]).sum()
                entries += live.sum()
            sums = torch.stack([(w * r).sum(-1), (w * gr).sum(-1), (w * b).sum(-1)], dim=-1)
            rgb_all[idx] = rgb_all[idx] + t * sums
            t_all[idx] = t * incl[..., -1:]
        if stats is not None:
            rows += active.numel()
    if stats is not None:
        stats["pairs"], stats["rows"], stats["entries"] = int(pairs), rows, int(entries)
    return _tiles_to_image(torch.cat([rgb_all, 1.0 - t_all], dim=-1).float(), cfg)


def _decode(chunk, live):
    """(..., C, 4) int64 words -> per-entry rows (op, mx, my, ca, cb, cc, r,
    g, b): the conic unscaled, dead entries at op 0."""
    key, p1, p2, p3 = chunk.unbind(-1)
    op = torch.where(live, _u8_unit(key, 0), 0.0)
    inv = 1.0 / MEAN_FIX_SCALE
    mx = (p1 & 0xFFF).to(torch.float32) * inv - MEAN_FIX_BIAS
    my = ((p1 >> 12) & 0xFFF).to(torch.float32) * inv - MEAN_FIX_BIAS
    ca, cb = unpack2xf16(p2)
    cc = f16_bits_to_f32(p3 & 0xFFFF)
    return op, mx, my, ca, cb, cc, _u8_unit(p3, 16), _u8_unit(p3, 24), _u8_unit(p1, 24)


def _power2_horner(mx, my, ca, cb, cc, px, py):
    """log2-unit exponent from the pre-scaled conic rows, Horner form."""
    l2 = float(np.float32(LOG2E))
    s = float(np.float32(-0.5) * np.float32(LOG2E))
    a2, b2, c2 = ca * s, cb * -l2, cc * s
    dx = px - mx
    dy = py - my
    return (a2 * dx + b2 * dy) * dx + (c2 * dy) * dy


def composite_tiles_plain_v2(entries: SortedEntries, cfg: TileConfig, flat_mode: bool = False,
                             stats: dict | None = None, dtype=torch.float32) -> torch.Tensor:
    """Plain version of K3: chunks aligned to the global entry order,
    entries outside the tile's run dead (see `_chunk_loop`, which also fills
    `stats`); the blend arithmetic in `dtype`."""
    tile = cfg.tile
    ent = u32(entries.entries)
    dev = ent.device
    ent = torch.cat([ent, ent.new_zeros(((-ent.shape[0]) % ROW, 4))])
    starts = entries.tile_starts.to(torch.int64)
    ends = starts + entries.tile_counts.to(torch.int64)
    row0 = starts // ROW
    lane = torch.arange(tile * tile, device=dev)
    px = ((lane % tile).to(torch.float32) + 0.5)[:, None].to(dtype)  # (P, 1) tile-local
    py = ((lane // tile).to(torch.float32) + 0.5)[:, None].to(dtype)
    col = torch.arange(ROW, device=dev)
    cut = float(np.float32(FLAT_POWER_CUTOFF * LOG2E))

    def blend(c, idx):
        gidx = (row0[idx] + c)[:, None] * ROW + col  # (A, C) global entry index
        live = (gidx >= starts[idx, None]) & (gidx < ends[idx, None])
        op, mx, my, ca, cb, cc, r, gr, b = (v[:, None, :].to(dtype)
                                            for v in _decode(ent[gidx], live))
        power2 = _power2_horner(mx, my, ca, cb, cc, px, py)  # (A, P, C)
        if flat_mode:
            a = torch.where(power2 >= cut, op, 0.0)
        else:
            a = op * torch.exp2(torch.clamp_max(power2, 0.0))
        return torch.where(a < ALPHA_EPS, 0.0, a), r, gr, b, live

    n_chunks = torch.where(ends > starts, (ends + ROW - 1) // ROW - row0, 0)
    return _chunk_loop(cfg, n_chunks, blend, stats, dtype)


def over_background(img: torch.Tensor, background) -> torch.Tensor:
    """Premultiplied (H, W, 4) over an opaque background colour -> (H, W, 3)."""
    bg = torch.as_tensor(background, dtype=torch.float32, device=img.device)
    return img[..., :3] + (1.0 - img[..., 3:4]) * bg
