"""The brush selection, frozen copies of the port's plain `query.selection`
paths: the squared distance of points to a stroke segment, the brush
region test of the immediate mode, the query texture's paint of one
segment, the texture sampled at the projected centres (the texture mode's
resolve) and the Set/Add/Remove combine. Plain torch in float32; the
stroke's points and radius are rounded to f32 on the host, as the port
rounds them. Ops are the strings "set", "add" and "remove"."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.preprocess import PreprocessOut, host_array

# Nothing here multiplies matrices; the reference states float32 all the same.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OPS = ("set", "add", "remove")


def _f32(v) -> np.ndarray:
    return host_array(v).astype(np.float32).reshape(-1)


def combine_selection(old_bits, new_bits, op: str) -> torch.Tensor:
    """Apply a selection op to (N,) bits -> (N,) uint8."""
    if op not in OPS:
        raise ValueError(f"selection op {op!r} is none of {OPS}")
    old_b = torch.as_tensor(old_bits) != 0
    new_b = torch.as_tensor(new_bits, device=old_b.device) != 0
    if op == "set":
        out = new_b
    elif op == "add":
        out = old_b | new_b
    else:
        out = old_b & ~new_b
    return out.to(torch.uint8)


def segment_dist2(x, y, a, b):
    """Squared distance of points (x, y) to the segment a -> b (f32)."""
    ab = b - a
    denom = max(np.float32(ab[0] * ab[0]) + np.float32(ab[1] * ab[1]), np.float32(1e-12))
    ax, ay, abx, aby = (float(v) for v in (a[0], a[1], ab[0], ab[1]))
    t = torch.clamp(((x - ax) * abx + (y - ay) * aby) / float(denom), 0.0, 1.0)
    dx = x - (ax + t * abx)
    dy = y - (ay + t * aby)
    return dx * dx + dy * dy


def select_brush_segment(pre: PreprocessOut, seg_start, seg_end, radius) -> torch.Tensor:
    """Splat centres within `radius` px of the stroke segment -> (N,) uint8."""
    r = np.float32(radius)
    dist2 = segment_dist2(pre.mean_x, pre.mean_y, _f32(seg_start), _f32(seg_end))
    return ((dist2 <= float(r * r)) & pre.valid).to(torch.uint8)


def blank_texture(width: int, height: int, device) -> torch.Tensor:
    return torch.zeros((height, width), dtype=torch.bool, device=device)


def paint_segment(tex: torch.Tensor, a, b, radius) -> torch.Tensor:
    """OR the pixels whose centres lie within `radius` of the segment
    a -> b into the (H, W) bool `tex`, in place."""
    h, w = tex.shape
    ys = torch.arange(h, dtype=torch.float32, device=tex.device)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=tex.device)[None, :] + 0.5
    xs, ys = torch.broadcast_tensors(xs, ys)
    r = np.float32(radius)
    tex |= segment_dist2(xs, ys, _f32(a), _f32(b)) <= float(r * r)
    return tex


def sample_texture_at_centers(pre: PreprocessOut, tex: torch.Tensor) -> torch.Tensor:
    """The query texture at the projected centres -> (N,) uint8: set where
    the centre lies on screen, on a painted pixel, and the splat survives
    the preprocess."""
    h, w = tex.shape
    # Clamp in f32 first so the integer cast never overflows.
    xi = pre.mean_x.clamp(-1.0, float(w)).to(torch.int64).clamp(0, w - 1)
    yi = pre.mean_y.clamp(-1.0, float(h)).to(torch.int64).clamp(0, h - 1)
    on_screen = ((pre.mean_x >= 0) & (pre.mean_x < w) & (pre.mean_y >= 0) & (pre.mean_y < h))
    return (tex[yi, xi] & on_screen & pre.valid).to(torch.uint8)
