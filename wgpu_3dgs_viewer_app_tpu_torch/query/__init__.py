"""Selection and hit queries over the per-splat preprocess outputs
(`ops.preprocess_geometry_fused`, kernel K4 on the card)."""

from .hit import MeasurementHitMethod, alpha_at_pixel, query_hit
from .overlay import overlay_cursor_ring, overlay_texture
from .pods import QueryBrushPod, QueryHitPod, QueryNonePod, QueryRectPod, QuerySelectionOp
from .selection import (
    QueryToolset,
    apply_query_pod,
    combine_selection,
    sample_texture_at_centers,
    select_brush_segment,
    select_rect,
)

__all__ = [
    "MeasurementHitMethod",
    "alpha_at_pixel",
    "query_hit",
    "QueryBrushPod",
    "QueryHitPod",
    "QueryNonePod",
    "QueryRectPod",
    "QuerySelectionOp",
    "QueryToolset",
    "apply_query_pod",
    "combine_selection",
    "sample_texture_at_centers",
    "select_brush_segment",
    "select_rect",
    "overlay_cursor_ring",
    "overlay_texture",
]
