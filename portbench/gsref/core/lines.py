"""Screen-space line rasterization and point projection, shared by the
measurement overlay and the mask gizmos.

Counterpart of `wgpu_3dgs_viewer_app_tpu.core.lines`: the same visual
contract (screen-space width, per-segment colour, alpha blend, segments
drawn in order) and the same per-pixel arithmetic. The JAX version scans
every segment over the whole frame. Here a segment only touches the pixels
of its box, grown by half its width plus 1 px (outside it the cover is
exactly 0, and a blend with cover 0 leaves a pixel as it was).

`segment_table` does the per-segment part on the host: it drops the
segments that cover nothing and rounds each kept segment's constants once.
Both versions of the per-pixel part read that table, so they share its
rounding:
- on a CUDA image, kernel K9 (`ops.overlay`, `csrc/overlay.cu`) walks each
  16x16 tile's segments in order, one thread a pixel;
- on the CPU, `rasterize_lines_plain` evaluates the covers of every
  (pixel, segment) pair of the boxes in numpy and blends the pairs with
  cover > 0 in segment order, one rank at a time (rank r: the r-th segment
  that covers the pixel), so the image is the one the sequential scan makes.
Where the reference's compiled CPU code contracts a multiply-add into an
fma, so do both (one rounding in f64, one to f32), and the projection sums
its 4-term dots pairwise as the reference's CPU dot does: on the CPU the
two packages' lines agree to an ulp or two.
"""

from __future__ import annotations

import numpy as np
import torch



def project_points(pts, view, proj, width: int, height: int) -> tuple:
    """(M, 3) world -> ((M, 2) pixel, (M,) clip-w depth, (M,) in front), in
    f32 torch on the device of `pts` (the CPU for numpy input)."""
    if not torch.is_tensor(pts):
        pts = torch.from_numpy(np.ascontiguousarray(pts, np.float32))
    x, y, z = pts.to(torch.float32).unbind(1)
    m = (np.asarray(proj, np.float32) @ np.asarray(view, np.float32)).tolist()
    # clip = [p, 1] @ mvp.T, each row's dot summed pairwise.
    clip = [(x * r[0] + y * r[1]) + (z * r[2] + r[3]) for r in m]
    w = clip[3]
    in_front = w > 1e-6
    w_safe = torch.where(w.abs() < 1e-9, 1e-9, w)
    px = (clip[0] / w_safe * 0.5 + 0.5) * width
    py = (0.5 - clip[1] / w_safe * 0.5) * height
    return torch.stack([px, py], -1), w, in_front


def _host(x, dtype=np.float32) -> np.ndarray:
    return (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(dtype)


# (pixel, segment) pairs evaluated at a time: bounds the temporaries
# (~100 B a pair); a segment whose box holds more is evaluated alone.
_PAIRS_PER_BATCH = 1 << 22

# Columns of the segment table, four float4 rows of a segment: its start and
# direction; the squared length, half its width + 0.5 and its alpha; its
# rgb; its pixel box [x0, x1) x [y0, y1), clipped to the frame (integers,
# exact in f32).
SEG_AX, SEG_AY, SEG_ABX, SEG_ABY = 0, 1, 2, 3
SEG_DENOM, SEG_REACH, SEG_ALPHA = 4, 5, 6
SEG_RGB = slice(8, 11)
SEG_BOX = slice(12, 16)
SEG_WORDS = 16


def segment_table(a_px, b_px, colors, widths, live, width: int, height: int) -> np.ndarray:
    """The (M', SEG_WORDS) f32 table of the segments that can cover a pixel
    of a width x height frame, in order: those live, not transparent and
    with finite ends. Each column is rounded as the per-pixel evaluation
    needs it (`SEG_*`)."""
    f32 = np.float32
    a, b = _host(a_px).reshape(-1, 2), _host(b_px).reshape(-1, 2)
    col, lw = _host(colors).reshape(-1, 4), _host(widths).reshape(-1)
    lv = _host(live, bool).reshape(-1)
    keep = lv & (col[:, 3] != 0) & np.isfinite(a).all(1) & np.isfinite(b).all(1)
    a, b, col, lw = a[keep], b[keep], col[keep], lw[keep]
    half = np.maximum(lw * f32(0.5), f32(0.5))
    reach = (half + f32(1.5)).astype(np.float64)
    lo = np.floor(np.minimum(a, b) - reach[:, None])
    hi = np.ceil(np.maximum(a, b) + reach[:, None])
    table = np.zeros((a.shape[0], SEG_WORDS), f32)
    ab = (b - a).astype(f32)
    table[:, SEG_AX], table[:, SEG_AY] = a[:, 0], a[:, 1]
    table[:, SEG_ABX], table[:, SEG_ABY] = ab[:, 0], ab[:, 1]
    table[:, SEG_DENOM] = np.maximum(_fma(ab[:, 1], ab[:, 1], ab[:, 0] * ab[:, 0]), f32(1e-9))
    table[:, SEG_REACH] = half + f32(0.5)
    table[:, SEG_ALPHA] = col[:, 3]
    table[:, SEG_RGB] = col[:, :3]
    # A NaN width makes an empty box at 0.
    for k, (v, axis, size) in enumerate(((lo, 0, width), (lo, 1, height), (hi, 0, width),
                                         (hi, 1, height))):
        table[:, SEG_BOX.start + k] = np.clip(np.nan_to_num(v[:, axis]), 0, size)
    return table


def box_sizes(table: np.ndarray) -> np.ndarray:
    """Pixels in each table row's box (int64)."""
    x0, y0, x1, y1 = table[:, SEG_BOX].astype(np.int64).T
    return np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)


def rasterize_lines_plain(img: torch.Tensor, a_px, b_px, colors, widths, live) -> torch.Tensor:
    """Plain version of K9's segment stage (arguments as `rasterize_lines`):
    covers in numpy on the host, blends on the image's device."""
    h, w = img.shape[:2]
    table = segment_table(a_px, b_px, colors, widths, live, w, h)
    sizes = box_sizes(table)
    out = img.reshape(-1, 3).clone()
    start = 0
    while start < len(sizes):
        stop = start + 1
        total = sizes[start]
        while stop < len(sizes) and total + sizes[stop] <= _PAIRS_PER_BATCH:
            total += sizes[stop]
            stop += 1
        if total:
            _blend_segments(out, w, table[start:stop], sizes[start:stop])
        start = stop
    return out.reshape(img.shape)


def _fma(a, b, c) -> np.ndarray:
    """f32 fma(a, b, c) in numpy, as `core.f16.fma_f32` in torch: the f32
    product is exact in f64, the sum rounds once there and once more to f32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _stable_order(keys: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The stable argsort of non-negative int64 `keys` (pixel indices or
    ranks), by one unstable sort of (key, position) packed in an int64:
    numpy's stable sort is an order of magnitude slower."""
    shift = max(int(pos.size).bit_length(), 1)
    return np.sort((keys << shift) | pos) & ((1 << shift) - 1)


def _blend_segments(out: torch.Tensor, w: int, table: np.ndarray, sizes: np.ndarray) -> None:
    """Blend the segments of `table` rows in order into the (H * W, 3)
    image `out`, in place. The covers depend on the segments alone, so they
    are computed on the host, in numpy (each step one rounded f32 operation,
    as the torch ops would round it); only the blends, one launch group a
    rank, touch the image on its device."""
    f32 = np.float32
    # Per-segment values as contiguous columns (1-D gathers are the fast ones).
    ax, ay, abx, aby, denom, reach, alpha = (np.ascontiguousarray(table[:, i]) for i in range(7))
    bx0, by0, bx1 = (table[:, SEG_BOX.start + i].astype(np.int64) for i in range(3))
    bw = bx1 - bx0
    # Every (pixel, segment) pair of the segments' boxes, in segment order.
    seg = np.repeat(np.arange(len(sizes)), sizes)
    local = np.arange(seg.shape[0]) - (np.cumsum(sizes) - sizes)[seg]
    row, col_in_box = np.divmod(local, bw[seg])
    ix = bx0[seg] + col_in_box
    iy = by0[seg] + row
    xs = ix.astype(f32) + f32(0.5)
    ys = iy.astype(f32) + f32(0.5)
    denom = denom[seg]
    ax, ay, abx, aby = ax[seg], ay[seg], abx[seg], aby[seg]
    tt = np.minimum(np.maximum(_fma(xs - ax, abx, (ys - ay) * aby) / denom, f32(0.0)), f32(1.0))
    dx = xs - _fma(tt, abx, ax)
    dy = ys - _fma(tt, aby, ay)
    dist = np.sqrt(_fma(dx, dx, dy * dy))
    cover = np.minimum(np.maximum(reach[seg] - dist, f32(0.0)), f32(1.0)) * alpha[seg]
    nz = cover > 0
    pix, seg, cover = (iy * w + ix)[nz], seg[nz], cover[nz]
    if pix.size == 0:
        return
    # Per pixel, its covering segments in order: a stable sort by pixel keeps
    # the segment order inside each pixel's run; rank = place in the run.
    pos = np.arange(pix.size)
    order = _stable_order(pix, pos)
    pix, seg, cover = pix[order], seg[order], cover[order]
    run_start = np.ones(pix.size, bool)
    run_start[1:] = pix[1:] != pix[:-1]
    rank = pos - np.maximum.accumulate(np.where(run_start, pos, 0))
    # Grouped by rank; each blend is fma(img, 1 - c, c * rgb) in f32, done as
    # one f64 multiply-add (the f32 product is exact in f64) rounded to f32.
    # One upload (pixel indices are exact in f64), from pinned memory on a
    # card so that it does not wait for the frame queued before it.
    by_rank = _stable_order(rank, pos)
    pix, seg, cover = pix[by_rank], seg[by_rank], cover[by_rank, None]
    packed = torch.from_numpy(np.concatenate(
        [pix[:, None].astype(np.float64), (f32(1.0) - cover).astype(np.float64),
         (cover * table[seg, SEG_RGB]).astype(np.float64)], axis=1))
    if out.device.type == "cuda":
        packed = packed.pin_memory().to(out.device, non_blocking=True)
    pix, keep, add = packed[:, 0].long(), packed[:, 1:2], packed[:, 2:]
    start = 0
    for end in np.cumsum(np.bincount(rank)).tolist():
        p = pix[start:end]
        out[p] = torch.addcmul(add[start:end], out[p].double(), keep[start:end]).float()
        start = end
