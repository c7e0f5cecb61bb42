"""The app frame's screen-space overlays, in the reference's paint order:
a frozen copy of the plain path of the port's `ops.overlay.draw_overlays`
(the segments of the mask gizmos and measurement lines, the selection
texture's tint, the brush cursor ring)."""

from __future__ import annotations

import torch

from ..core.lines import rasterize_lines_plain
from ..query.overlay import overlay_cursor_ring_plain, overlay_texture_plain


def draw_overlays(img: torch.Tensor, lines: tuple | None = None,
                  texture: torch.Tensor | None = None, cursor: tuple | None = None
                  ) -> torch.Tensor:
    """`lines` = (a, b, colors, widths, live), `texture` (H, W) bool,
    `cursor` = (centre, radius); None skips a stage."""
    if lines is not None:
        img = rasterize_lines_plain(img, *lines)
    if texture is not None:
        img = overlay_texture_plain(img, texture)
    if cursor is not None:
        img = overlay_cursor_ring_plain(img, *cursor)
    return img
