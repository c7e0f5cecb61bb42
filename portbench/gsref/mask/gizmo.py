"""Mask gizmos: wireframe box / ellipsoid overlays of the mask shapes.

Counterpart of `wgpu_3dgs_viewer_app_tpu.mask.gizmo`: each visible shape's
edges (12 segments a box, 3 x 32 an ellipsoid) in world space, built on the
host in numpy exactly as the JAX package builds them, projected and drawn in
the shape's colour over the frame by `core.lines.rasterize_lines` on the
frame's device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core.lines import project_points
from ..core.transform import quat_from_euler_zyx_deg, quat_to_mat3
from .shapes import MaskShape, MaskShapeKind

# Unit box edges (half-extent 0.5), 12 segments.
_BOX_CORNERS = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
    np.float32,
)
_BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _circle_segments(n: int = 32) -> np.ndarray:
    t = np.linspace(0, 2 * math.pi, n + 1)
    return np.stack([np.cos(t), np.sin(t)], -1).astype(np.float32)


def shape_segments(shape: MaskShape) -> np.ndarray:
    """World-space line segments (M, 2, 3) f32 of one shape's wireframe."""
    r = quat_to_mat3(quat_from_euler_zyx_deg(shape.rot))
    s = np.asarray(shape.scale, np.float32)
    p = np.asarray(shape.pos, np.float32)

    def xf(local):
        return (local * s) @ r.T + p

    if shape.kind == MaskShapeKind.BOX:
        # Each corner on its own, as the reference transforms them.
        corners = np.stack([xf(c) for c in _BOX_CORNERS])
        return corners[np.asarray(_BOX_EDGES)].astype(np.float32)
    c = _circle_segments() * 0.5  # radius 0.5, as the containment test
    segs = []
    for axis in range(3):
        pts = np.zeros((len(c), 3), np.float32)
        pts[:, (axis + 1) % 3] = c[:, 0]
        pts[:, (axis + 2) % 3] = c[:, 1]
        w = xf(pts)
        segs.append(np.stack([w[:-1], w[1:]], axis=1))
    return np.concatenate(segs).astype(np.float32)


def gizmo_lines(shapes: Sequence[MaskShape], view: np.ndarray, proj: np.ndarray, width: int,
                height: int, line_width: float = 1.5):
    """The visible shapes' wireframes as `rasterize_lines` arguments (pixel
    ends a and b, colours, widths, live), numpy; None if no shape is
    visible."""
    visible = [s for s in shapes if s.visible]
    if not visible:
        return None
    segs = [shape_segments(s) for s in visible]
    colors = np.concatenate([np.tile(np.asarray(s.color, np.float32), (len(g), 1))
                             for s, g in zip(visible, segs)])
    segs = np.concatenate(segs)  # (M, 2, 3)
    px, _, in_front = project_points(segs.reshape(-1, 3), view, proj, width, height)
    px = px.reshape(-1, 2, 2).numpy()
    ok = in_front.reshape(-1, 2).numpy()
    widths = np.full(len(segs), line_width, np.float32)
    return px[:, 0], px[:, 1], colors, widths, ok[:, 0] & ok[:, 1]
