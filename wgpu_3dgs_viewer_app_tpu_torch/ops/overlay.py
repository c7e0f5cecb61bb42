"""K9: the app frame's screen-space overlays in one launch
(`csrc/overlay.cu`, `gs_overlay`): the segments of `core.lines.
segment_table` (mask gizmos, measurement lines), the selection texture's
tint and the brush cursor ring, in the reference's paint order, each stage
optional.

Port-only, like `ops.kernels`: the reference draws these with jitted device
programs (`core/lines.py::rasterize_lines`, `query/overlay.py::
overlay_texture`, `overlay_cursor_ring`), not Pallas kernels. Their plain
versions stay in `core.lines` and `query.overlay`; `draw_overlays` runs
those on the CPU and one K9 launch on a card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.lines import SEG_WORDS, rasterize_lines_plain, segment_table
from ..query.overlay import (CURSOR_RGBA, CURSOR_THICKNESS, TEXTURE_RGBA,
                             overlay_cursor_ring_plain, overlay_texture_plain)
from ..utils import trace
from . import kernels

# gs_overlay's host parameters: the tint's rgba, the ring's rgba, then the
# ring's centre x, y, radius and thickness.
_PARAMS = 12


def _f32(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
    return np.asarray(v, np.float32).reshape(-1)


def overlay_cuda(img: torch.Tensor, table: np.ndarray | None = None,
                 texture: torch.Tensor | None = None, texture_rgba=TEXTURE_RGBA,
                 cursor: tuple | None = None, cursor_rgba=CURSOR_RGBA,
                 thickness: float = CURSOR_THICKNESS) -> torch.Tensor:
    """One K9 launch over the (H, W, 3) f32 CUDA image -> a new image: the
    rows of the host segment `table` ((M, SEG_WORDS) f32, `segment_table`;
    None or M = 0 for none) in order, then the tint of the (H, W) bool
    `texture` in `texture_rgba` (None: no tint), then the ring `cursor` =
    (centre (2,) px, radius px) in `cursor_rgba` and `thickness` (None: no
    ring). Rounds as the plain versions do, to the bit."""
    h, w = img.shape[:2]
    kernels.require(img, "img", torch.float32, (h, w, 3))
    dev = img.device
    if texture is not None:
        kernels.require(texture, "texture", torch.bool, (h, w), dev)
    n = 0 if table is None else len(table)
    seg = None
    if n:
        if not isinstance(table, np.ndarray) or table.dtype != np.float32 \
                or table.shape != (n, SEG_WORDS):
            raise ValueError(f"table: expected a float32 numpy array (M, {SEG_WORDS}), got "
                             f"{getattr(table, 'dtype', type(table))} "
                             f"{getattr(table, 'shape', None)}")
        # From pinned memory, so that the upload does not wait for the frame
        # queued before it.
        seg = torch.from_numpy(np.ascontiguousarray(table)).pin_memory().to(dev,
                                                                           non_blocking=True)
    params = np.zeros(_PARAMS, np.float32)
    params[0:4] = _f32(texture_rgba)
    params[4:8] = _f32(cursor_rgba)
    if cursor is not None:
        center, radius = cursor
        params[8:10] = _f32(center)
        params[10] = _f32(radius)[0]
        params[11] = thickness
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    p = kernels.ptr
    kernels.check(lib.gs_overlay((ctypes.c_float * _PARAMS)(*params.tolist()), h, w, n,
                                 int(cursor is not None), p(img), p(seg), p(texture), p(out),
                                 kernels.stream()), "gs_overlay")
    kernels.LAUNCHES["overlay"] += 1
    return out


def draw_overlays(img: torch.Tensor, lines: tuple | None = None,
                  texture: torch.Tensor | None = None, cursor: tuple | None = None
                  ) -> torch.Tensor:
    """The session's overlays over a frame, in the reference's paint order:
    the segments `lines` ((a, b, colors, widths, live), as `core.lines.
    rasterize_lines` takes them), the tint of the selection `texture`, the
    cursor ring `cursor` = (centre, radius); None skips a stage. On a CUDA
    frame one K9 launch (none when nothing is drawn), on the CPU the plain
    versions in turn."""
    if img.device.type == "cpu":
        with trace.span("k9.overlay"):
            if lines is not None:
                img = rasterize_lines_plain(img, *lines)
            if texture is not None:
                img = overlay_texture_plain(img, texture)
            if cursor is not None:
                img = overlay_cursor_ring_plain(img, *cursor)
            return img
    h, w = img.shape[:2]
    with trace.span("overlays.segments"):
        table = None if lines is None else segment_table(*lines, w, h)
    if (table is None or not len(table)) and texture is None and cursor is None:
        return img
    with trace.span("k9.overlay"):
        return overlay_cuda(img, table, texture, cursor=cursor)
