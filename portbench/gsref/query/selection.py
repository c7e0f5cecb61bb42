"""The rect selection, a frozen copy of the port's `query.selection.
select_rect`: a splat is selected when its projected centre falls inside
the rect and it survives the preprocess (`PreprocessOut.valid`), tested in
f32 with the rect's corners rounded to f32 on the host."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.preprocess import PreprocessOut, host_array


def _f32(v) -> np.ndarray:
    return host_array(v).astype(np.float32).reshape(-1)


def _rect(top_left, bottom_right) -> tuple:
    a, b = _f32(top_left), _f32(bottom_right)
    return np.minimum(a, b).tolist(), np.maximum(a, b).tolist()


def select_rect(pre: PreprocessOut, top_left, bottom_right) -> torch.Tensor:
    """Splat centres inside the pixel rect -> (N,) uint8."""
    tl, br = _rect(top_left, bottom_right)
    inside = ((pre.mean_x >= tl[0]) & (pre.mean_x <= br[0])
              & (pre.mean_y >= tl[1]) & (pre.mean_y <= br[1]))
    return (inside & pre.valid).to(torch.uint8)

