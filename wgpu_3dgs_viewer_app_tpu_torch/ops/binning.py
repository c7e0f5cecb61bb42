"""Tile binning: per-splat tile enumeration and entry packing (plain torch),
the sorted-entry container and the per-tile ranges.

Each live splat is duplicated into up to `max_dup` screen tiles, visited
centre-out, and each (splat, tile) pair becomes one 16-byte entry of four
u32 words, bit-identical to `wgpu_3dgs_viewer_app_tpu.ops.binning`:

  key = tile | log-depth | alpha8   (one ascending sort gives every tile a
        contiguous front-to-back run; SENTINEL marks dead slots. Merged
        multi-model frames add a model-rank field above the depth, ROADMAP)
  p1  = b8 << 24 | mean_y u12 << 12 | mean_x u12  (tile-relative means,
        1/16-px fixed point, biased +128 px)
  p2  = conic_a f16 | conic_b f16 << 16
  p3  = conic_c f16 | r8 << 16 | g8 << 24

Entries live in one (E, 4) int32 tensor, so the compositor reads an entry
with one 16-byte load. The plain path computes words as int64 values in
[0, 2**32) and stores their int32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.f16 import as_i32, f16_bits_to_f32, f32_to_f16_bits, pack2xf16, u32, unpack2xf16
from .preprocess import PreprocessOut

# Peak splat opacity. The key's alpha byte is clamped to ALPHA_U8_MAX, so
# the compositor needs no per-pixel clamp.
ALPHA_MAX = 0.99
ALPHA_U8_MAX = int(ALPHA_MAX * 255)  # 252

# Key of a dead slot: sorts after every live key.
SENTINEL = 0xFFFFFFFF

# Entries per compositor chunk of the plain compositor.
ROW = 128

MEAN_FIX_SCALE = 16.0   # 1/16-px fixed point for tile-relative means
MEAN_FIX_BIAS = 128.0

# Fixed log-depth quantisation range [0.05, 2e4]: frame-independent, so
# ties do not reorder as the camera moves.
DEPTH_LN_MIN = -3.0  # ln(0.05)
DEPTH_LN_MAX = 9.905  # ln(2e4)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Screen and tiling geometry.

    `max_dup` caps the tile entries per splat (D); a splat whose culled
    tile rect exceeds D loses its farthest cells (centre-out order)."""

    width: int
    height: int
    tile: int = 16
    max_dup: int = 8

    ALPHA_BITS = 8
    # Depth-key resolution below which the log-depth quantisation visibly
    # misorders splats.
    MIN_DEPTH_BITS = 6

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_bits(self) -> int:
        # Room for n_tiles real tiles plus the all-ones sentinel bucket.
        return max(1, self.n_tiles.bit_length())

    @property
    def v2_depth_bits(self) -> int:
        bits = 32 - self.tile_bits - self.ALPHA_BITS
        if bits < self.MIN_DEPTH_BITS:
            raise ValueError(f"key layout leaves {bits} depth bits (tile_bits="
                             f"{self.tile_bits}); need >= {self.MIN_DEPTH_BITS}")
        return bits

    @property
    def _tile_shift(self) -> int:
        return self.v2_depth_bits + self.ALPHA_BITS

    @property
    def depth_scale(self) -> float:
        """Log-depth -> key steps (applied in f32)."""
        return float(2 ** self.v2_depth_bits - 1) / (DEPTH_LN_MAX - DEPTH_LN_MIN)


@dataclasses.dataclass
class SortedEntries:
    """Key-sorted live entries plus per-tile ranges: tile t owns entries
    [tile_starts[t], tile_starts[t] + tile_counts[t])."""

    entries: torch.Tensor      # (E, 4) int32: key, p1, p2, p3
    tile_starts: torch.Tensor  # (n_tiles,) int32
    tile_counts: torch.Tensor  # (n_tiles,) int32
    n_valid: int               # live entries


def depth_alpha_key_lo(depth, alpha, cfg: TileConfig) -> torch.Tensor:
    """Low key bits: log-depth | alpha u8 (int64)."""
    qmax = float(2 ** cfg.v2_depth_bits - 1)
    ld = torch.log(torch.clamp_min(depth, 1e-6))
    dkey = torch.clamp((ld - DEPTH_LN_MIN) * cfg.depth_scale, 0.0, qmax).to(torch.int64)
    alpha_u8 = torch.clamp(alpha * 255.0 + 0.5, 0.0, float(ALPHA_U8_MAX)).to(torch.int64)
    return (dkey << cfg.ALPHA_BITS) | alpha_u8


def _tight_cull_params(r_signed, p2s, p3s):
    """Tight-cull precursors from the signed live radius (<= 0: invalid)
    and the PACKED (f16-rounded) conic, so culling matches the conic the
    compositor evaluates.

    With radius = sigma_max * cut and lambda_min(conic) = 1/sigma_max^2 the
    live boundary of q(d) = a dx^2 + 2b dx dy + c dy^2 is cut2 =
    radius^2 * lambda_min; the cut ellipse's AABB half-extents are
    radius * sqrt(c * lambda_min / det) (x) and radius * sqrt(a * lambda_min
    / det) (y). Returns ((cut2, a, b, c, 1/a, 1/c), rx, ry)."""
    a, b = unpack2xf16(p2s)
    c = f16_bits_to_f32(p3s & 0xFFFF)
    det = torch.clamp_min(a * c - b * b, 1e-20)
    half = 0.5 * (a + c)
    lam_min = torch.clamp_min(half - torch.sqrt(torch.clamp_min(half * half - det, 0.0)), 1e-12)
    r = torch.clamp_min(r_signed, 0.0)
    cut2 = torch.where(r_signed > 0, r * r * lam_min, torch.full_like(r, -1.0))
    scale = torch.sqrt(torch.clamp_min(cut2, 0.0) / det)
    # min() guards f16-degenerate conics (the AABB is inside the circle).
    rx = torch.minimum(torch.sqrt(torch.clamp_min(c, 0.0)) * scale, r)
    ry = torch.minimum(torch.sqrt(torch.clamp_min(a, 0.0)) * scale, r)
    inv_a = 1.0 / torch.clamp_min(a, 1e-12)
    inv_c = 1.0 / torch.clamp_min(c, 1e-12)
    return (cut2, a, b, c, inv_a, inv_c), rx, ry


def _splat_rect(x, y, rx, ry, cfg: TileConfig):
    """Tile rect of the per-axis half-extents: (tx0, rw, ty0, rh, rw*rh)."""
    tile = float(cfg.tile)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int64)

    tx0, tx1 = cell(x - rx, cfg.tiles_x - 1), cell(x + rx, cfg.tiles_x - 1)
    ty0, ty1 = cell(y - ry, cfg.tiles_y - 1), cell(y + ry, cfg.tiles_y - 1)
    rw = tx1 - tx0 + 1
    rh = ty1 - ty0 + 1
    return tx0, rw, ty0, rh, rw * rh


def _enum_cell(d: int, tx0, rw, ty0, rh):
    """Centre-out cell d of a splat's tile rect: offsets alternate around the
    mean's cell in both axes, so truncation at max_dup drops far corners."""
    dt = torch.full_like(rw, d)
    m = torch.remainder(dt, rw)                    # within-row step
    k = torch.div(dt, rw, rounding_mode="floor")   # row step
    off_x = ((m + 1) >> 1) * torch.where((m & 1) == 1, 1, -1)
    off_y = ((k + 1) >> 1) * torch.where((k & 1) == 1, 1, -1)
    return tx0 + ((rw - 1) >> 1) + off_x, ty0 + ((rh - 1) >> 1) + off_y


def _cell_live(d: int, x, y, cull, tx0, rw, ty0, rh, n_touched, cfg: TileConfig):
    """Exact tile test of candidate cell d: keep the cell iff min over the
    tile rect of q(dx, dy) <= cut2. The minimum is 0 with the centre inside,
    else it lies on an edge, where the 1D minimiser has a closed form."""
    cut2, ca, cb, cc, inv_a, inv_c = cull
    tile = float(cfg.tile)
    etx, ety = _enum_cell(d, tx0, rw, ty0, rh)
    dx0 = etx.to(torch.float32) * tile - x
    dx1 = dx0 + tile
    dy0 = ety.to(torch.float32) * tile - y
    dy1 = dy0 + tile
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)

    def q(dx, dy):
        return (ca * dx + 2.0 * cb * dy) * dx + cc * dy * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    yv0 = clip(-cb * dx0 * inv_c, dy0, dy1)  # vertical edge x = dx0
    yv1 = clip(-cb * dx1 * inv_c, dy0, dy1)
    xh0 = clip(-cb * dy0 * inv_a, dx0, dx1)  # horizontal edge y = dy0
    xh1 = clip(-cb * dy1 * inv_a, dx0, dx1)
    qmin = torch.minimum(torch.minimum(q(dx0, yv0), q(dx1, yv1)),
                         torch.minimum(q(xh0, dy0), q(xh1, dy1)))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    return (d < n_touched) & (qmin <= cut2), etx, ety


def _cell_entry(live, etx, ety, x, y, key_lo, p1_base, cfg: TileConfig):
    """One slot -> its (key, p1) words; dead slots get SENTINEL and 0."""
    tile = float(cfg.tile)
    tile_id = ety * cfg.tiles_x + etx
    key = torch.where(live, (tile_id << cfg._tile_shift) | key_lo, SENTINEL)

    def fix(v, origin):
        v = (v - origin * tile + MEAN_FIX_BIAS) * MEAN_FIX_SCALE + 0.5
        return torch.clamp(v, 0.0, 4095.0).to(torch.int64)

    p1 = fix(x, etx.to(torch.float32)) | (fix(y, ety.to(torch.float32)) << 12) | p1_base
    return key, torch.where(live, p1, 0)


def _u8(c):
    return torch.clamp(c * 255.0 + 0.5, 0, 255).to(torch.int64)


def enumerate_entries_from_pre(pre: PreprocessOut, cfg: TileConfig) -> torch.Tensor:
    """Duplicate + pack: (N * max_dup, 4) int32 entries, slot d of splat s
    at row s * max_dup + d; dead slots are (SENTINEL, 0, 0, 0)."""
    x, y = pre.mean_x, pre.mean_y
    key_lo = depth_alpha_key_lo(pre.depth, pre.alpha, cfg)
    p1_base = _u8(pre.col_b) << 24
    p2s = pack2xf16(pre.conic_a, pre.conic_b)
    p3s = f32_to_f16_bits(pre.conic_c) | (_u8(pre.col_r) << 16) | (_u8(pre.col_g) << 24)
    # Validity rides the signed radius: r <= 0 gives cut2 = -1, never live.
    r_signed = torch.where(pre.valid, pre.radius, torch.full_like(pre.radius, -1.0))
    cull, rx, ry = _tight_cull_params(r_signed, p2s, p3s)
    tx0, rw, ty0, rh, n_touched = _splat_rect(x, y, rx, ry, cfg)
    cols = []
    for d in range(cfg.max_dup):
        live, etx, ety = _cell_live(d, x, y, cull, tx0, rw, ty0, rh, n_touched, cfg)
        key, p1 = _cell_entry(live, etx, ety, x, y, key_lo, p1_base, cfg)
        zero = torch.zeros_like(p2s)
        cols.append(torch.stack([key, p1, torch.where(live, p2s, zero),
                                 torch.where(live, p3s, zero)], dim=-1))
    return as_i32(torch.stack(cols, dim=1).reshape(-1, 4))


def tile_edges_plain(keys: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """(n_tiles + 1,) int64 run edges of each tile in ascending `keys`
    (int32 bit patterns), compared as unsigned words."""
    boundaries = torch.arange(cfg.n_tiles + 1, device=keys.device, dtype=torch.int64)
    return torch.searchsorted(u32(keys), boundaries << cfg._tile_shift, side="left")


def sorted_entries_from_edges(entries: torch.Tensor, edges: torch.Tensor,
                              cfg: TileConfig) -> SortedEntries:
    starts = edges[:-1]
    return SortedEntries(
        entries=entries,
        tile_starts=starts.to(torch.int32),
        tile_counts=(edges[1:] - starts).to(torch.int32),
        n_valid=int(edges[cfg.n_tiles]),
    )
