"""Tile-local front-to-back alpha compositing of the sorted entries.

`composite_tiles_v2` is the counterpart of the JAX package's
`composite_tiles_pallas_v2`. On CUDA entries it launches kernel K3
(`csrc/composite_v2.cu`), the one counterpart of both of its Pallas kernels
(row-major and transposed), for every `transposed` and `mxu`; on CPU
entries it runs the plain version, `composite_tiles_plain_v2`, a port of
`composite_tiles_jnp_v2` (and of the Pallas kernel's `mxu` exponent): per
tile, chunks of 128 entries aligned to the global entry order, alpha as a
(pixels, entries) matrix, transmittance by a cumulative product along the
entries, and an exit once every pixel of the tile has T <= 1/255. K3 walks
the same chunks and exits at the same test, so the two differ by rounding.

Alpha per entry and pixel: op * 2^min(power2, 0) in splat mode, with the
conic rows pre-scaled by -0.5 * log2(e); in ellipse/point mode the flat
opacity inside the 2-sigma cut. Alpha below 1/255 is dropped. The output
is (H, W, 4) f32: premultiplied RGB and A = 1 - T.

Both CUDA compositors take any tile: up to 64 px one block a tile, up to
256 a thread block cluster of row bands, and over 256 parts of 32 px in two
launches (each part walks until its own pixels close and records that
chunk; then every part resumes to the tile's last such chunk), all of which
keep the reference's whole-tile exit test (`csrc/composite.cuh`). K3 also
splits tiles of 23 to 32 px into two launches: every tile walks at most a
budget of chunks in one block, and the tiles still open with chunks left
then resume at one pixel a thread across a cluster of blocks on several
SMs, bit for bit the one-block walk; while spans record, the tiles and
chunks its first launch hands on are counted on the device
(`utils/trace.py::k3_handed`).

`composite_tiles` is the v1 compositor over the unquantized `EntryPlanes`
(the JAX `composite_tiles`): kernel K6 (`csrc/composite_v1.cu`) on CUDA
planes, `composite_tiles_plain` (a port of `composite_tiles_jnp`) on CPU
planes. It works in natural-log units with absolute pixel coordinates and
clamps each alpha to ALPHA_MAX per pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.f16 import f16_bits_to_f32, u32, unpack2xf16
from ..core.f16 import fma_f32 as _fma
from ..utils import trace
from . import kernels
from .binning import (ALPHA_MAX, MEAN_FIX_BIAS, MEAN_FIX_SCALE, N_PLANES, ROW, EntryPlanes,
                      SortedEntries, TileConfig)

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1.0 / 255.0
FLAT_POWER_CUTOFF = -2.0  # ellipse/point: flat fill inside the 2-sigma boundary
LOG2E = 1.4426950408889634
_TILES_PER_STEP = 256
# Tiles over this size run on the card as parts of _PART px in two launches
# (csrc/composite.cuh: kMaxClusterTile, kPart).
_MAX_CLUSTER_TILE = 256
_PART = 32
# Tiles up to this many px whose pass 2 has more than one band of this many
# pixels run K3 in two launches split by a chunk budget (csrc/composite.cuh:
# budgeted, kMaxBudgetTile, kTailBandPixels): 23 to 32 px.
_MAX_BUDGET_TILE = 32
_TAIL_BAND_PIXELS = 256
# The launchers' answer when cudaOccupancyMaxActiveClusters finds no place on
# the card for one tile's cluster of blocks (csrc/composite.cuh).
_NO_CLUSTER = -2


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
                stats: dict | None) -> torch.Tensor:
    """The plain compositors' chunk loop: tiles advance one 128-entry chunk at a
    time together, at most _TILES_PER_STEP at a time (bounds the (tiles,
    pixels, 128) temporaries), while the tile has a chunk left and any of
    its pixels has T > T_EPS. `blend(c, idx)` gives chunk c of the tiles
    idx as alpha (A, P, C), r, g, b (A, 1, C) and live (A, C). Each pixel
    adds T * sum(excl * alpha * colour) and takes the chunk's product of
    (1 - alpha) into T. With `stats`, counts in stats["pairs"] the (pixel
    inside the image, live entry) blends this data needs: for each pixel,
    its live entries up to and including the one that brings its own T to
    <= T_EPS; in stats["rows"] the chunks the tiles read; and in
    stats["walked"] the chunks each tile read ((n_tiles,) int64)."""
    p = cfg.tile * cfg.tile
    dev = n_chunks.device
    t_all = torch.ones((cfg.n_tiles, p, 1), device=dev)
    rgb_all = torch.zeros((cfg.n_tiles, p, 3), device=dev)
    if stats is not None:
        pairs = torch.zeros((), dtype=torch.int64, device=dev)
        walked = torch.zeros(cfg.n_tiles, dtype=torch.int64, device=dev)
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
            sums = torch.stack([(w * r).sum(-1), (w * gr).sum(-1), (w * b).sum(-1)], dim=-1)
            rgb_all[idx] = rgb_all[idx] + t * sums
            t_all[idx] = t * incl[..., -1:]
        if stats is not None:
            walked[active] += 1
    if stats is not None:
        stats["pairs"], stats["rows"] = int(pairs), int(walked.sum())
        stats["walked"] = walked.cpu()
    return _tiles_to_image(torch.cat([rgb_all, 1.0 - t_all], dim=-1), cfg)


def composite_tiles_plain(planes: EntryPlanes, cfg: TileConfig, flat_mode: bool = False,
                          stats: dict | None = None) -> torch.Tensor:
    """Plain version of K6, a port of the JAX `composite_tiles_jnp`: per
    tile, one 128-entry row of its run at a time (see `_chunk_loop`, which
    also fills `stats`)."""
    tile = cfg.tile
    ent = planes.ent
    dev = ent.device
    row_starts = planes.row_starts.to(torch.int64)
    counts = planes.tile_counts.to(torch.int64)
    lane = torch.arange(tile * tile, device=dev)
    tid = torch.arange(cfg.n_tiles, device=dev)[:, None]
    px = ((tid % cfg.tiles_x) * tile + lane % tile).to(torch.float32) + 0.5  # (T, P) absolute
    py = ((tid // cfg.tiles_x) * tile + lane // tile).to(torch.float32) + 0.5
    col = torch.arange(ROW, device=dev)

    def blend(c, idx):
        mx, my, ca, cb, cc, op, r, gr, b = ent[:, row_starts[idx] + c, None, :]  # (A, 1, C)
        dx = px[idx][..., None] - mx  # (A, P, C)
        dy = py[idx][..., None] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        if flat_mode:
            a = torch.where(power >= FLAT_POWER_CUTOFF, op, 0.0)
        else:
            a = op * torch.exp(torch.clamp_max(power, 0.0))
        a = torch.clamp_max(a, ALPHA_MAX)
        a = torch.where(a < ALPHA_EPS, 0.0, a)
        return a, r, gr, b, c * ROW + col < counts[idx, None]

    return _chunk_loop(cfg, (counts + ROW - 1) // ROW, blend, stats)


def _require_tile(cfg: TileConfig) -> None:
    if cfg.tile < 1:
        raise ValueError(f"tile {cfg.tile}: the CUDA compositors take tiles of 1 pixel or more")


def _part_scratch(cfg: TileConfig, device) -> torch.Tensor | None:
    """The exit chunks of a two-launch tile over _MAX_CLUSTER_TILE px: each
    tile's, then each of its parts' (zeros); None for smaller tiles."""
    if cfg.tile <= _MAX_CLUSTER_TILE:
        return None
    parts = (-(-cfg.tile // _PART)) ** 2
    return torch.zeros(cfg.n_tiles * (1 + parts), dtype=torch.int32, device=device)


def _budgeted(tile: int) -> bool:
    """K3 splits the tile's walk by a chunk budget: a first pass over every
    tile, then the tiles that outlast it resumed across a cluster of blocks
    (`csrc/composite.cuh`: budgeted)."""
    return tile <= _MAX_BUDGET_TILE and tile * tile // _TAIL_BAND_PIXELS > 1


def composite_launches(tile: int) -> int:
    """K3's launches a call at `tile` (`LAUNCHES["composite"]`): two where a
    tile's walk is split (tiles of 23 to 32 px, and over 256), else one."""
    return 2 if _budgeted(tile) or tile > _MAX_CLUSTER_TILE else 1


def composite_budget() -> int:
    """The chunks a budgeted tile walks in K3's first pass before it is
    handed to the second (`csrc/composite_v2.cu::kChunkBudget`; builds the
    kernels at first use)."""
    return kernels.library().gs_composite_v2_budget()


def _check_launch(rc: int, name: str, cfg: TileConfig) -> None:
    """Raise on a launcher's error; tiles of 65 to 256 px run as a thread
    block cluster, which the card may have no place for."""
    if rc == _NO_CLUSTER:
        blocks = -(-cfg.tile * -(-cfg.tile // 4) // 1024)  # composite.cuh::bands_for
        raise RuntimeError(f"{name}: tile {cfg.tile} needs a cluster of {blocks} blocks of up "
                           f"to 1024 threads; cudaOccupancyMaxActiveClusters returned 0")
    kernels.check(rc, name)


def _composite_tiles_v1_cuda(planes: EntryPlanes, cfg: TileConfig,
                             flat_mode: bool) -> torch.Tensor:
    _require_tile(cfg)
    lib = kernels.library()
    ent = planes.ent
    kernels.require(ent, "ent", torch.float32, (N_PLANES, ent.shape[1], ROW))
    kernels.require(planes.row_starts, "row_starts", torch.int32, (cfg.n_tiles,), ent.device)
    kernels.require(planes.tile_counts, "tile_counts", torch.int32, (cfg.n_tiles,), ent.device)
    out = torch.empty((cfg.height, cfg.width, 4), dtype=torch.float32, device=ent.device)
    scratch = _part_scratch(cfg, ent.device)
    p = kernels.ptr
    _check_launch(lib.gs_composite_v1(p(ent), ent.shape[1], p(planes.row_starts),
                                      p(planes.tile_counts), cfg.n_tiles, cfg.tile, cfg.tiles_x,
                                      cfg.width, cfg.height, int(flat_mode), p(scratch),
                                      p(out), kernels.stream()), "gs_composite_v1", cfg)
    kernels.LAUNCHES["composite_v1"] += 1 if scratch is None else 2
    return out


def composite_tiles(planes: EntryPlanes, cfg: TileConfig, flat_mode: bool = False) -> torch.Tensor:
    """EntryPlanes -> (H, W, 4) premultiplied RGBA, the v1 compositor:
    kernel K6 on CUDA, the plain version on the CPU."""
    if planes.ent.device.type == "cpu":
        return composite_tiles_plain(planes, cfg, flat_mode)
    return _composite_tiles_v1_cuda(planes, cfg, flat_mode)


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


def _power2_quadratic(mx, my, ca, cb, cc, px, py):
    """log2-unit exponent in the quadratic-basis form of the JAX kernel's
    `mxu` mode: F = [px^2, py^2, px py, px, py, 1] (per pixel) dotted with
    per-entry coefficients G. Expanded about the tile origin it cancels
    terms of up to ~1e4, so the rounding of each step shows: the
    coefficients and the dot are evaluated as the reference evaluates them
    on the CPU, whose compiler contracts a * b + c * d into fma(a, b, c * d)
    and accumulates the dot as a chain of fmas in term order. K3 repeats
    this with explicit fmaf."""
    l2 = float(np.float32(LOG2E))
    h = float(np.float32(-0.5) * np.float32(LOG2E))
    g = (h * ca, h * cc, -l2 * cb, l2 * _fma(ca, mx, cb * my), l2 * _fma(cc, my, cb * mx),
         -l2 * _fma(cb * mx, my, 0.5 * _fma(ca * mx, mx, (cc * my) * my)))
    f = (px * px, py * py, px * py, px, py, torch.ones_like(px))
    power = f[0] * g[0]
    for fk, gk in zip(f[1:], g[1:]):
        power = _fma(fk, gk, power)
    return power


def composite_tiles_plain_v2(entries: SortedEntries, cfg: TileConfig, flat_mode: bool = False,
                             stats: dict | None = None, mxu: bool = False) -> torch.Tensor:
    """Plain version of K3: chunks aligned to the global entry order,
    entries outside the tile's run dead (see `_chunk_loop`, which also fills
    `stats`). `mxu` evaluates the exponent in the quadratic-basis form
    (splat mode only; flat mode keeps the Horner form, as the reference
    does)."""
    tile = cfg.tile
    power2_fn = _power2_quadratic if mxu and not flat_mode else _power2_horner
    ent = u32(entries.entries)
    dev = ent.device
    ent = torch.cat([ent, ent.new_zeros(((-ent.shape[0]) % ROW, 4))])
    starts = entries.tile_starts.to(torch.int64)
    ends = starts + entries.tile_counts.to(torch.int64)
    row0 = starts // ROW
    lane = torch.arange(tile * tile, device=dev)
    px = ((lane % tile).to(torch.float32) + 0.5)[:, None]  # (P, 1) tile-local
    py = ((lane // tile).to(torch.float32) + 0.5)[:, None]
    col = torch.arange(ROW, device=dev)
    cut = float(np.float32(FLAT_POWER_CUTOFF * LOG2E))

    def blend(c, idx):
        gidx = (row0[idx] + c)[:, None] * ROW + col  # (A, C) global entry index
        live = (gidx >= starts[idx, None]) & (gidx < ends[idx, None])
        op, mx, my, ca, cb, cc, r, gr, b = (v[:, None, :] for v in _decode(ent[gidx], live))
        power2 = power2_fn(mx, my, ca, cb, cc, px, py)  # (A, P, C)
        if flat_mode:
            a = torch.where(power2 >= cut, op, 0.0)
        else:
            a = op * torch.exp2(torch.clamp_max(power2, 0.0))
        return torch.where(a < ALPHA_EPS, 0.0, a), r, gr, b, live

    n_chunks = torch.where(ends > starts, (ends + ROW - 1) // ROW - row0, 0)
    return _chunk_loop(cfg, n_chunks, blend, stats)


def composite_buffers(cfg: TileConfig, device) -> dict:
    """What K3 writes compositing under `cfg`: the image, and where the
    tile's walk is split in two launches the list and state the first hands
    the second (or the parts' exit chunks, over 256 px). A caller that
    composites every frame keeps one set (`composite_tiles_v2(bufs=)`)."""
    bufs = {"out": torch.empty((cfg.height, cfg.width, 4), dtype=torch.float32, device=device),
            "scratch": None, "state": None}
    if _budgeted(cfg.tile):
        # The list of tiles pass 1 hands on (its counts zeroed by the
        # launcher) and their pixels' state.
        bufs["scratch"] = torch.empty(2 + cfg.n_tiles, dtype=torch.int32, device=device)
        bufs["state"] = torch.empty((cfg.n_tiles * cfg.tile * cfg.tile, 4), dtype=torch.float32,
                                    device=device)
    elif cfg.tile > _MAX_CLUSTER_TILE:
        bufs["scratch"] = _part_scratch(cfg, device)
    return bufs


def _composite_tiles_cuda(entries: SortedEntries, cfg: TileConfig, flat_mode: bool,
                          mxu: bool, bufs: dict | None) -> torch.Tensor:
    """K3 (`mxu`: the quadratic-basis exponent in splat mode)."""
    _require_tile(cfg)
    lib = kernels.library()
    ent = entries.entries
    kernels.require(ent, "entries", torch.int32, (ent.shape[0], 4))
    kernels.require(entries.tile_starts, "tile_starts", torch.int32, (cfg.n_tiles,), ent.device)
    kernels.require(entries.tile_counts, "tile_counts", torch.int32, (cfg.n_tiles,), ent.device)
    dev = ent.device
    if bufs is None:
        bufs = composite_buffers(cfg, dev)
    elif cfg.tile > _MAX_CLUSTER_TILE:
        bufs["scratch"].zero_()  # the parts' exit chunks start at 0
    out = bufs["out"]
    kernels.require(out, "out", torch.float32, (cfg.height, cfg.width, 4), dev)
    handed = trace.k3_handed(dev) if _budgeted(cfg.tile) else None
    p = kernels.ptr
    _check_launch(lib.gs_composite_v2(p(ent), p(entries.tile_starts), p(entries.tile_counts),
                                      cfg.n_tiles, cfg.tile, cfg.tiles_x, cfg.width, cfg.height,
                                      int(flat_mode), int(mxu and not flat_mode),
                                      p(bufs["scratch"]), p(bufs["state"]), p(handed), p(out),
                                      kernels.stream()),
                  "gs_composite_v2", cfg)
    kernels.LAUNCHES["composite"] += composite_launches(cfg.tile)
    return out


def composite_tiles_v2(entries: SortedEntries, cfg: TileConfig, flat_mode: bool = False,
                       transposed: bool = True, mxu: bool = False,
                       bufs: dict | None = None) -> torch.Tensor:
    """SortedEntries -> (H, W, 4) premultiplied RGBA: kernel K3 on CUDA, the
    plain version on the CPU (with `mxu`). `transposed` mirrors the JAX
    `composite_tiles_pallas_v2`, where it picks a TPU lane layout; both
    layouts compute one function, so it selects nothing here. On a card K3
    writes into `bufs` (`composite_buffers(cfg)`) where given, else into new
    ones."""
    del transposed
    if entries.entries.device.type == "cpu":
        return composite_tiles_plain_v2(entries, cfg, flat_mode, mxu=mxu)
    return _composite_tiles_cuda(entries, cfg, flat_mode, mxu, bufs)


def over_background(img: torch.Tensor, background, out: torch.Tensor | None = None,
                    scratch: torch.Tensor | None = None) -> torch.Tensor:
    """Premultiplied (H, W, 4) over an opaque background colour -> (H, W, 3)
    (the compositor's last step: span `k3.composite`). `background`: (3,)
    on the image's device (no wait), or host values, which on a card are
    copied from pageable memory (torch waits for the stream). With `out`,
    an (H, W, 3) f32 tensor, and `scratch`, an (H, W, 1) one, the result is
    written into `out` and nothing is allocated (the same operations)."""
    with trace.span("k3.composite"):
        if torch.is_tensor(background) and background.device == img.device:
            bg = background
        else:
            with trace.host_read(img.is_cuda):
                bg = torch.as_tensor(background, dtype=torch.float32, device=img.device)
        if out is None:
            return img[..., :3] + (1.0 - img[..., 3:4]) * bg
        torch.neg(img[..., 3:4], out=scratch).add_(1.0)  # 1 - a, as rounded above
        torch.mul(scratch, bg, out=out)
        return torch.add(img[..., :3], out, out=out)
