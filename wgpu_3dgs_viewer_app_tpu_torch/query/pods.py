"""Query pods: a copy of `wgpu_3dgs_viewer_app_tpu.query.pods` (numpy
only). `QueryNonePod`, `QueryHitPod(coords)`, rect and brush selection pods
and `QuerySelectionOp` {SET, ADD, REMOVE}.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class QuerySelectionOp(enum.Enum):
    """Ref `gs::QuerySelectionOp` (`src/tab/scene.rs:1223-1228`)."""

    SET = "set"
    ADD = "add"
    REMOVE = "remove"


@dataclasses.dataclass(frozen=True)
class QueryNonePod:
    """No active query (ref `QueryNonePod::new`, `src/tab/scene.rs:1622`)."""


@dataclasses.dataclass(frozen=True)
class QueryHitPod:
    """Hit test at a viewport pixel (ref `QueryHitPod::new`, `src/tab/scene.rs:1633`)."""

    coords: tuple  # (x, y) pixel

    def as_array(self) -> np.ndarray:
        return np.asarray(self.coords, np.float32)


@dataclasses.dataclass(frozen=True)
class QueryRectPod:
    """Rect selection region in pixels (min, max corners)."""

    top_left: tuple
    bottom_right: tuple
    op: QuerySelectionOp = QuerySelectionOp.SET


@dataclasses.dataclass(frozen=True)
class QueryBrushPod:
    """Brush stroke segment (prev -> cur) with radius, in pixels."""

    start: tuple
    end: tuple
    radius: float
    op: QuerySelectionOp = QuerySelectionOp.SET
