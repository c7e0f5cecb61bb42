"""Mask shapes (Box / Ellipsoid) and their containment test.

Counterpart of `wgpu_3dgs_viewer_app_tpu.mask.shapes`. A shape is a TRS
(rotation as Euler degrees, applied ZYX) and a display colour; its pod bakes
the inverse transform in numpy f32, as the JAX pod does, so the two packages
hold byte-equal pods. A point is inside a shape if, after the shape's
inverse TRS, it lies in the unit box (|local| <= 0.5 on every axis) or the
ball of radius 0.5.

Containment runs in torch on the device of the position planes, in
component form: three flat (N,) planes, each leaf 9 multiplies, 6 adds, 3
subtractions and a compare, every operation its own f32 rounding in the
reference's order (nothing is contracted into an fma), so the bits equal the
JAX evaluator's on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..core.transform import quat_from_euler_zyx_deg, quat_to_mat3


class MaskShapeKind(enum.Enum):
    BOX = "box"
    ELLIPSOID = "ellipsoid"


@dataclasses.dataclass
class MaskShape:
    """One mask shape with TRS, display colour and visibility."""

    kind: MaskShapeKind = MaskShapeKind.BOX
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rot: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1, 1, 0, 1], np.float32)
    )
    visible: bool = True

    def to_pod(self) -> "MaskOpShapePod":
        """Bake the inverse transform: world -> shape-local = S^-1 R^T (p - t)."""
        r = quat_to_mat3(quat_from_euler_zyx_deg(self.rot))
        inv_scale = 1.0 / np.maximum(np.asarray(self.scale, np.float32), 1e-12)
        inv_lin = (inv_scale[:, None] * r.T).astype(np.float32)
        return MaskOpShapePod(kind=self.kind, inv_lin=inv_lin,
                              pos=np.asarray(self.pos, np.float32))


@dataclasses.dataclass(frozen=True)
class MaskOpShapePod:
    """A shape ready for evaluation."""

    kind: MaskShapeKind
    inv_lin: np.ndarray  # (3, 3) f32 world -> local linear part
    pos: np.ndarray      # (3,) f32 shape origin


def shape_contains_xyz(pod: MaskOpShapePod, x: torch.Tensor, y: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Three flat (N,) f32 world planes -> (N,) bool containment, on their
    device."""
    il = np.asarray(pod.inv_lin, np.float32).tolist()
    px, py, pz = np.asarray(pod.pos, np.float32).tolist()
    dx, dy, dz = x - px, y - py, z - pz
    lx = il[0][0] * dx + il[0][1] * dy + il[0][2] * dz
    ly = il[1][0] * dx + il[1][1] * dy + il[1][2] * dz
    lz = il[2][0] * dx + il[2][1] * dy + il[2][2] * dz
    if pod.kind == MaskShapeKind.BOX:
        return (lx.abs() <= 0.5) & (ly.abs() <= 0.5) & (lz.abs() <= 0.5)
    return lx * lx + ly * ly + lz * lz <= 0.25

