"""Model and Gaussian transforms (host-side numpy).

Same definitions as `wgpu_3dgs_viewer_app_tpu.core.transform`: the per-model
TRS with ZYX Euler degrees, and the scene-wide display transform (size,
display mode, SH degree, no_sh0).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np


class GaussianDisplayMode(enum.IntEnum):
    SPLAT = 0
    ELLIPSE = 1
    POINT = 2


class GaussianShDegree:
    """SH degree 0..=3."""

    def __init__(self, degree: int):
        if not 0 <= degree <= 3:
            raise ValueError(f"SH degree must be in 0..=3, got {degree}")
        self._deg = int(degree)

    @property
    def degree(self) -> int:
        return self._deg

    def __eq__(self, other):
        return isinstance(other, GaussianShDegree) and other._deg == self._deg

    def __repr__(self):
        return f"GaussianShDegree({self._deg})"


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, (w, x, y, z) layout."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float64,
    )


def quat_from_euler_zyx_deg(rot_deg) -> np.ndarray:
    """Euler degrees (x, y, z) -> quaternion (w, x, y, z), q = qz * qy * qx."""
    rx, ry, rz = (math.radians(float(a)) for a in rot_deg)

    def axis_angle(axis, ang):
        s = math.sin(ang / 2)
        return np.array([math.cos(ang / 2), axis[0] * s, axis[1] * s, axis[2] * s], np.float64)

    q = quat_mul(quat_mul(axis_angle((0, 0, 1), rz), axis_angle((0, 1, 0), ry)),
                 axis_angle((1, 0, 0), rx))
    return (q / np.linalg.norm(q)).astype(np.float32)


def quat_to_mat3(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix (leading dims kept)."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3), np.float32)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


@dataclasses.dataclass
class ModelTransform:
    """Per-model TRS; `rot` is Euler degrees, applied ZYX."""

    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rot: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))

    def quat(self) -> np.ndarray:
        return quat_from_euler_zyx_deg(self.rot)

    def matrix(self) -> np.ndarray:
        """4x4 model matrix = T * R * S (column-vector convention)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_mat3(self.quat()) * np.asarray(self.scale, np.float32)[None, :]
        m[:3, 3] = np.asarray(self.pos, np.float32)
        return m


@dataclasses.dataclass
class GaussianTransform:
    """Scene-wide Gaussian display transform."""

    size: float = 1.0
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT
    sh_deg: GaussianShDegree = dataclasses.field(default_factory=lambda: GaussianShDegree(3))
    no_sh0: bool = False
