from .evaluate import MaskEvaluator, evaluate_mask_numpy
from .expr import MaskOp, MaskParseError, parse
from .gizmo import render_mask_gizmos, shape_segments
from .shapes import MaskOpShapePod, MaskShape, MaskShapeKind, shape_contains

__all__ = [
    "MaskEvaluator",
    "evaluate_mask_numpy",
    "MaskOp",
    "MaskParseError",
    "parse",
    "MaskOpShapePod",
    "MaskShape",
    "MaskShapeKind",
    "shape_contains",
    "render_mask_gizmos",
    "shape_segments",
]
