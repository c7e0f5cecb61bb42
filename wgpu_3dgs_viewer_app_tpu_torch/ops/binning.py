"""Tile binning: per-splat tile enumeration and entry packing from a
`PreprocessOut` (kernel K5 on the card, plain torch on the CPU), the
sorted-entry container and the per-tile ranges.

Each live splat is duplicated into up to `max_dup` screen tiles, visited
centre-out, and each (splat, tile) pair becomes one 16-byte entry of four
u32 words, bit-identical to `wgpu_3dgs_viewer_app_tpu.ops.binning`:

  key = tile | model_rank | log-depth | alpha8   (one ascending sort gives
        every tile a contiguous front-to-back run; SENTINEL marks dead
        slots. The rank field has `TileConfig.model_bits` bits, taken from
        the depth field: 0 on a single-model frame; on a merged multi-model
        frame the nearest model has rank 0, so a tile's run is grouped by
        model, nearest first, and depth-sorted within each model)
  p1  = b8 << 24 | mean_y u12 << 12 | mean_x u12  (tile-relative means,
        1/16-px fixed point, biased +128 px)
  p2  = conic_a f16 | conic_b f16 << 16
  p3  = conic_c f16 | r8 << 16 | g8 << 24

Entries live in one (E, 4) int32 tensor, so the compositor reads an entry
with one 16-byte load. The plain path computes words as int64 values in
[0, 2**32) and stores their int32 bit patterns.

`enumerate_entries_from_pre` is the counterpart of the JAX function of the
same name (the staged front-end's second stage; its Pallas kernel is
`_enum_pack_kernel`): on CUDA planes it launches kernel K5
(`csrc/enum_pack.cu`), on CPU planes it runs `enumerate_entries_from_pre_plain`.
`build_sorted_entries` adds the entry sort (K2).

The v1 chain, the unquantized path, at the end of the module:
`build_tile_lists` keys each (splat, tile) slot as tile | top bits of the
raw f32 depth, enumerates the tile rect in row order with no tight cull
and sorts (K2); `build_entry_planes` gathers the sorted splats' f32 fields
into 128-aligned per-tile runs on nine planes, which the v1 compositor
(`composite.composite_tiles`, kernel K6) reads.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.f16 import as_i32, f16_bits_to_f32, f32_to_f16_bits, pack2xf16, u32, unpack2xf16
from ..utils import trace
from . import kernels
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
    tile rect exceeds D loses its farthest cells (centre-out order).
    `model_bits` > 0 puts a model-rank field of that many bits between the
    tile and the depth in the key (merged multi-model frames); every bit
    comes out of the depth field."""

    width: int
    height: int
    tile: int = 16
    max_dup: int = 8
    model_bits: int = 0

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
    def depth_bits(self) -> int:
        """Depth bits of the v1 key, tile | top bits of the f32 depth."""
        return 32 - self.tile_bits

    @property
    def v2_depth_bits(self) -> int:
        bits = 32 - self.tile_bits - self.ALPHA_BITS - self.model_bits
        if bits < self.MIN_DEPTH_BITS:
            raise ValueError(f"key layout leaves {bits} depth bits (tile_bits="
                             f"{self.tile_bits}, model_bits={self.model_bits}); need >= "
                             f"{self.MIN_DEPTH_BITS}: reduce the model or tile count")
        return bits

    @property
    def _rank_shift(self) -> int:
        return self.v2_depth_bits + self.ALPHA_BITS

    @property
    def _tile_shift(self) -> int:
        return self._rank_shift + self.model_bits

    @property
    def depth_scale(self) -> float:
        """Log-depth -> key steps (applied in f32)."""
        return float(2 ** self.v2_depth_bits - 1) / (DEPTH_LN_MAX - DEPTH_LN_MIN)


class SortedEntries:
    """Key-sorted live entries plus per-tile ranges: tile t owns entries
    [tile_starts[t], tile_starts[t] + tile_counts[t]).

    `entries` (E, 4) int32 (key, p1, p2, p3) holds the live entries in its
    first `n_valid` rows; K2 on a card sizes its buffers by the slots it
    sorted and leaves the live count on the device, where it is given as a
    (1,) tensor and read (the host waits for the device) only when
    `n_valid` is asked for. `tile_starts` and `tile_counts`: (n_tiles,)
    int32."""

    def __init__(self, entries: torch.Tensor, tile_starts: torch.Tensor,
                 tile_counts: torch.Tensor, n_valid):
        self.entries, self.tile_starts, self.tile_counts = entries, tile_starts, tile_counts
        self._n_valid = n_valid

    @property
    def n_valid(self) -> int:
        """The live entries (read from the device at the first ask)."""
        n = self._n_valid
        if torch.is_tensor(n):
            with trace.host_read(n.is_cuda):
                n = self._n_valid = int(n.item())
        return n

    def live(self) -> torch.Tensor:
        """The (n_valid, 4) live entries."""
        return self.entries[: self.n_valid]

    def ranged(self, tile_starts: torch.Tensor, tile_counts: torch.Tensor) -> "SortedEntries":
        """The same entries and live count (unread where it is unread) with
        other tile ranges."""
        return SortedEntries(self.entries, tile_starts, tile_counts, self._n_valid)


def check_model_rank(cfg: TileConfig, model_rank: int) -> int:
    """The rank as an int that fits the key's rank field (0 without one)."""
    rank = int(model_rank)
    if not 0 <= rank < max(1 << cfg.model_bits, 1):
        raise ValueError(f"model_rank {rank} does not fit model_bits={cfg.model_bits}")
    return rank


def depth_alpha_key_lo(depth, alpha, cfg: TileConfig, model_rank: int = 0) -> torch.Tensor:
    """Low key bits: model_rank | log-depth | alpha u8 (int64). The rank
    (nearest model = 0) must be 0 unless `cfg.model_bits` > 0."""
    qmax = float(2 ** cfg.v2_depth_bits - 1)
    ld = torch.log(torch.clamp_min(depth, 1e-6))
    dkey = torch.clamp((ld - DEPTH_LN_MIN) * cfg.depth_scale, 0.0, qmax).to(torch.int64)
    alpha_u8 = torch.clamp(alpha * 255.0 + 0.5, 0.0, float(ALPHA_U8_MAX)).to(torch.int64)
    return (check_model_rank(cfg, model_rank) << cfg._rank_shift) | (dkey << cfg.ALPHA_BITS) | alpha_u8


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


def enumerate_entries_from_pre_plain(pre: PreprocessOut, cfg: TileConfig,
                                     model_rank: int = 0) -> torch.Tensor:
    """Plain version of K5. Duplicate + pack: (N * max_dup, 4) int32
    entries, slot d of splat s at row s * max_dup + d; dead slots are
    (SENTINEL, 0, 0, 0)."""
    x, y = pre.mean_x, pre.mean_y
    key_lo = depth_alpha_key_lo(pre.depth, pre.alpha, cfg, model_rank)
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


# The planes K5 reads, in the argument order of `csrc/enum_pack.cu::gs_enum_pack`.
_ENUM_PLANES = ("mean_x", "mean_y", "depth", "radius", "conic_a", "conic_b", "conic_c",
                "col_r", "col_g", "col_b", "alpha")


def _enumerate_entries_from_pre_cuda(pre: PreprocessOut, cfg: TileConfig,
                                     model_rank: int, out=None) -> torch.Tensor:
    lib = kernels.library()
    n = pre.mean_x.shape[0]
    dev = pre.mean_x.device
    for name in _ENUM_PLANES:
        kernels.require(getattr(pre, name), name, torch.float32, (n,), dev)
    kernels.require(pre.valid, "valid", torch.bool, (n,), dev)
    rank = check_model_rank(cfg, model_rank)
    if out is None:
        out = torch.empty((n * cfg.max_dup, 4), dtype=torch.int32, device=dev)
    else:
        kernels.require(out, "out", torch.int32, (n * cfg.max_dup, 4), dev)
    kernels.check(lib.gs_enum_pack(
        n, cfg.tile, cfg.tiles_x, cfg.tiles_y, cfg.max_dup, cfg._tile_shift, cfg._rank_shift,
        rank, cfg.depth_scale, float(2 ** cfg.v2_depth_bits - 1),
        *(kernels.ptr(getattr(pre, name)) for name in _ENUM_PLANES), kernels.ptr(pre.valid),
        kernels.ptr(out), kernels.stream()), "gs_enum_pack")
    kernels.LAUNCHES["enum_pack"] += 1
    return out


def enumerate_entries_from_pre(pre: PreprocessOut, cfg: TileConfig, model_rank: int = 0,
                               out=None) -> torch.Tensor:
    """PreprocessOut -> (N * max_dup, 4) int32 entries: kernel K5 on CUDA
    planes, the plain version on CPU planes. `model_rank` keys the merged
    multi-model frame (needs `cfg.model_bits` > 0; nearest model = 0).
    `out`: an (N * max_dup, 4) int32 tensor (or a row slice of a larger
    one) to write into."""
    if pre.mean_x.device.type == "cpu":
        ent = enumerate_entries_from_pre_plain(pre, cfg, model_rank)
        return ent if out is None else out.copy_(ent)
    return _enumerate_entries_from_pre_cuda(pre, cfg, model_rank, out)


def build_sorted_entries(pre: PreprocessOut, cfg: TileConfig,
                         model_rank: int = 0) -> SortedEntries:
    """PreprocessOut -> SortedEntries: the enumeration (K5) then the entry
    sort (K2), the second half of the staged front-end."""
    from .sort import sort_entries

    return sort_entries(enumerate_entries_from_pre(pre, cfg, model_rank), cfg)


def tile_edges_plain(keys: torch.Tensor, cfg: TileConfig, shift: int) -> torch.Tensor:
    """(n_tiles + 1,) int64 run edges of each tile in ascending `keys`
    (int32 bit patterns), compared as unsigned words; the tile field sits
    at bit `shift` and up."""
    boundaries = torch.arange(cfg.n_tiles + 1, device=keys.device, dtype=torch.int64)
    return torch.searchsorted(u32(keys), boundaries << shift, side="left")


def sorted_entries_from_edges(entries: torch.Tensor, edges: torch.Tensor,
                              cfg: TileConfig) -> SortedEntries:
    starts = edges[:-1]
    return SortedEntries(
        entries=entries,
        tile_starts=starts.to(torch.int32),
        tile_counts=(edges[1:] - starts).to(torch.int32),
        n_valid=int(edges[cfg.n_tiles]),
    )


# ---------------------------------------------------------------------------
# v1: unquantized tile lists and f32 entry planes.
# ---------------------------------------------------------------------------

# Field-plane order of `EntryPlanes.ent`.
PLANE_FIELDS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "alpha", "r", "g", "b")
N_PLANES = len(PLANE_FIELDS)
_PRE_FIELDS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "alpha", "col_r", "col_g",
               "col_b")


def depth_key_bits(depth: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Positive f32 depth -> its top `depth_bits` f32 bits (int64): positive
    f32 bit patterns order as their values."""
    return u32(torch.clamp_min(depth, 0.0).view(torch.int32)) >> (32 - depth_bits)


@dataclasses.dataclass
class TileLists:
    """Sorted live (splat, tile) slots of the v1 chain: tile t owns
    sorted slots [tile_starts[t], tile_starts[t] + tile_counts[t]). Unlike
    the JAX `TileLists` (N * D long, sentinel tail) it holds the live
    prefix only."""

    sorted_keys: torch.Tensor  # (n_valid,) int32 bit patterns: tile | depth bits
    sorted_idx: torch.Tensor   # (n_valid,) int32 splat index
    tile_starts: torch.Tensor  # (n_tiles,) int32
    tile_counts: torch.Tensor  # (n_tiles,) int32
    n_valid: int


def tile_list_entries(pre: PreprocessOut, cfg: TileConfig) -> torch.Tensor:
    """The v1 slots before the sort, (N * max_dup, 4) int32 rows (key,
    splat index, 0, 0), slot d of splat s at row s * max_dup + d: the tile
    rect of the splat's radius, enumerated in row order (d % rw, d // rw);
    slots past the rect, and every slot of an invalid splat, get SENTINEL."""
    n, dev = pre.mean_x.shape[0], pre.mean_x.device
    tile = float(cfg.tile)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int64)

    x, y, r = pre.mean_x, pre.mean_y, pre.radius
    tx0, tx1 = cell(x - r, cfg.tiles_x - 1), cell(x + r, cfg.tiles_x - 1)
    ty0, ty1 = cell(y - r, cfg.tiles_y - 1), cell(y + r, cfg.tiles_y - 1)
    rw, rh = tx1 - tx0 + 1, ty1 - ty0 + 1
    # An invalid splat's rect may be empty; its slots are dead either way.
    rw_safe = torch.clamp_min(rw, 1)
    dkey = depth_key_bits(pre.depth, cfg.depth_bits)
    # Column by column into the int32 rows: at 6M splats an (N, D) int64
    # temporary is 192 MB, so none is made.
    ent = torch.zeros((n, cfg.max_dup, 4), dtype=torch.int32, device=dev)
    ent[:, :, 1] = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    for j in range(cfg.max_dup):
        dx, dy = j % rw_safe, j // rw_safe
        tile_id = (ty0 + dy) * cfg.tiles_x + (tx0 + dx)
        live = pre.valid & (j < rw * rh) & (dy < rh)
        ent[:, j, 0] = as_i32(torch.where(live, (tile_id << cfg.depth_bits) | dkey, SENTINEL))
    return ent.view(-1, 4)


def build_tile_lists(pre: PreprocessOut, cfg: TileConfig) -> TileLists:
    """PreprocessOut -> TileLists: the v1 slots (plain torch, as the
    reference's are XLA) sorted by the entry sort (kernel K2 on CUDA, its
    plain version on the CPU) with the tile edges read at `cfg.depth_bits`.
    Both sorts are stable and keep slot order among equal keys, as the
    reference's `lax.sort(is_stable=True)` does, so the sorted slots equal
    the reference's live prefix bit for bit."""
    from .sort import sort_entries

    se = sort_entries(tile_list_entries(pre, cfg), cfg, shift=cfg.depth_bits)
    live = se.live()
    return TileLists(sorted_keys=live[:, 0], sorted_idx=live[:, 1],
                     tile_starts=se.tile_starts, tile_counts=se.tile_counts, n_valid=se.n_valid)


@dataclasses.dataclass
class EntryPlanes:
    """Sorted splat fields of the v1 chain, 128 entries a row, one plane a
    field (`PLANE_FIELDS`): tile t's run starts at row row_starts[t] and
    is padded to whole rows with zero-alpha entries."""

    ent: torch.Tensor          # (N_PLANES, R, ROW) f32
    row_starts: torch.Tensor   # (n_tiles,) int32
    tile_counts: torch.Tensor  # (n_tiles,) int32


def build_entry_planes(pre: PreprocessOut, lists: TileLists, cfg: TileConfig) -> EntryPlanes:
    """Gather the sorted splats' f32 fields into the 128-aligned field-plane
    layout (plain torch gathers on either device, as the reference's are
    XLA). R = ceil(n_valid / 128) + n_tiles rows: the reference sizes it by
    all N * D slots, so R differs, but `row_starts`, `tile_counts` and every
    row a tile owns are the same bits. Padding slots read splat 0's fields
    with alpha 0, as the reference's do."""
    dev = pre.mean_x.device
    e, n_tiles = lists.n_valid, cfg.n_tiles
    counts = lists.tile_counts.to(torch.int64)
    aligned = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum((counts + ROW - 1) // ROW * ROW, 0, out=aligned[1:])
    n_rows = -(-e // ROW) + n_tiles
    row_ids = torch.arange(n_rows, device=dev)
    row_t = torch.searchsorted(aligned // ROW, row_ids, right=True) - 1
    row_t = torch.clamp(row_t, 0, n_tiles - 1)
    starts = lists.tile_starts.to(torch.int64)
    row_delta = (starts - aligned[:-1])[row_t]
    row_end = (starts + counts)[row_t]
    src_slot = (row_ids[:, None] * ROW + torch.arange(ROW, device=dev)) + row_delta[:, None]
    live = (src_slot < row_end[:, None]).reshape(-1)
    del row_ids, row_t, row_delta, row_end
    src_slot = torch.clamp(src_slot.reshape(-1), 0, max(e - 1, 0))
    if e:
        src = torch.where(live, lists.sorted_idx[src_slot].to(torch.int64), 0)
    else:
        src = torch.zeros_like(src_slot)
    del src_slot
    ent = torch.empty((N_PLANES, n_rows * ROW), dtype=torch.float32, device=dev)
    for i, name in enumerate(_PRE_FIELDS):
        torch.index_select(getattr(pre, name), 0, src, out=ent[i])
    ent[PLANE_FIELDS.index("alpha")].masked_fill_(~live, 0.0)
    return EntryPlanes(ent=ent.view(N_PLANES, n_rows, ROW),
                       row_starts=(aligned[:-1] // ROW).to(torch.int32),
                       tile_counts=lists.tile_counts.to(torch.int32))
