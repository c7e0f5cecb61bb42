"""Measurement: hit pairs, their distance, and the line overlay.

Counterpart of `wgpu_3dgs_viewer_app_tpu.app.measurement`. A hit pair holds
two world positions (set by the session's `locate_hit`, which runs the hit
query over the query geometry, K4 on the card); its visible pairs are drawn
as screen-space lines over the frame by `core.lines.rasterize_lines`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.lines import project_points, rasterize_lines
from ..query.hit import MeasurementHitMethod


@dataclasses.dataclass
class MeasurementHit:
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))


@dataclasses.dataclass
class MeasurementHitPair:
    label: str
    visible: bool = True
    color: tuple = (1.0, 0.0, 0.0, 1.0)
    line_width: float = 1.0
    hits: List[MeasurementHit] = dataclasses.field(
        default_factory=lambda: [MeasurementHit(), MeasurementHit()]
    )

    def distance(self) -> float:
        return float(np.linalg.norm(self.hits[0].pos - self.hits[1].pos))


@dataclasses.dataclass
class Measurement:
    hit_pairs: List[MeasurementHitPair] = dataclasses.field(default_factory=list)
    hit_method: MeasurementHitMethod = MeasurementHitMethod.MOST_ALPHA


def measurement_lines(measurement: Measurement, view: np.ndarray, proj: np.ndarray, width: int,
                      height: int):
    """The visible hit pairs' lines as `rasterize_lines` arguments (pixel
    ends a and b, colours, widths, live), numpy; None if no pair is
    visible."""
    pairs = [p for p in measurement.hit_pairs if p.visible]
    if not pairs:
        return None
    pts = np.array([[p.hits[0].pos, p.hits[1].pos] for p in pairs], np.float32).reshape(-1, 3)
    px, _, in_front = project_points(pts, view, proj, width, height)
    px = px.reshape(-1, 2, 2).numpy()
    ok = in_front.reshape(-1, 2).numpy()
    colors = np.asarray([p.color for p in pairs], np.float32)
    widths = np.asarray([p.line_width for p in pairs], np.float32)
    return px[:, 0], px[:, 1], colors, widths, ok[:, 0] & ok[:, 1]


def render_measurement_overlay(img: torch.Tensor, measurement: Measurement, view: np.ndarray,
                               proj: np.ndarray) -> torch.Tensor:
    """Draw the visible hit pairs' lines over the (H, W, 3) frame."""
    lines = measurement_lines(measurement, view, proj, img.shape[1], img.shape[0])
    return img if lines is None else rasterize_lines(img, *lines)
