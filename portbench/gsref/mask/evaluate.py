"""Mask evaluation: a set-op tree over shape containments -> per-splat bits.

Counterpart of `wgpu_3dgs_viewer_app_tpu.mask.evaluate`. The tree folds into
torch elementwise operations over three flat (N,) position planes (the model
transform applied first: pods are in world space, positions model-local);
each node is one boolean op. `op=None` is Reset: every splat visible. The
(N,) uint8 bits go to `GaussianBuffers.set_mask`, where they gate the
front-end (K1) and the query geometry (K4).

The evaluator works on the device it is given; positions that are numpy
arrays are uploaded there (the upload is part of the evaluation), tensors
stay where they are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.transform import ModelTransform
from .expr import MaskOp
from .shapes import MaskOpShapePod, shape_contains_xyz

Positions = Union[torch.Tensor, np.ndarray, tuple, list]


def _components(positions: Positions, device) -> tuple:
    """(x, y, z) planes or an (N, 3) array -> three flat (N,) f32 tensors."""
    if isinstance(positions, (tuple, list)):
        planes = positions
    else:
        planes = (positions[:, 0], positions[:, 1], positions[:, 2])
    return tuple(p if torch.is_tensor(p) else
                 torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(device)
                 for p in planes)


class MaskEvaluator:
    """Evaluates a mask op tree against one model's splat centres on
    `device` (the CPU only when asked for)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def evaluate(self, op: Optional[MaskOp], shapes: Sequence[MaskOpShapePod],
                 positions: Positions,
                 model_transform: Optional[ModelTransform] = None) -> torch.Tensor:
        """(N,) uint8 mask bits (1 = keep)."""
        x, y, z = _components(positions, self.device)
        if op is None:
            return torch.ones(x.shape[0], dtype=torch.uint8, device=x.device)
        if model_transform is not None:
            m = np.asarray(model_transform.matrix(), np.float32).tolist()
            x, y, z = (m[i][0] * x + m[i][1] * y + m[i][2] * z + m[i][3] for i in range(3))
        return self._eval(op, shapes, x, y, z).to(torch.uint8)

    def _eval(self, op: MaskOp, shapes, x, y, z) -> torch.Tensor:
        k = op.kind
        if k == "shape":
            return shape_contains_xyz(shapes[op.index], x, y, z)
        if k == "complement":
            return ~self._eval(op.left, shapes, x, y, z)
        a = self._eval(op.left, shapes, x, y, z)
        b = self._eval(op.right, shapes, x, y, z)
        if k == "union":
            return a | b
        if k == "intersection":
            return a & b
        if k == "difference":
            return a & ~b
        if k == "symmetric_difference":
            return a ^ b
        raise ValueError(f"unknown mask op kind {k!r}")

