"""Cameras: view/projection matrices and the orbit control (host-side numpy).

Same conventions as `wgpu_3dgs_viewer_app_tpu.core.camera`: right-handed,
the camera looks down -Z, NDC z in [0, 1] (glam `look_at_rh` /
`perspective_rh`), column vectors (`p_clip = P @ V @ M @ p`). Matrices are
(4, 4) f32 numpy arrays; the viewer turns them into frame parameters.
"""

from __future__ import annotations

import math

import numpy as np


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_rh(fov_y: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """Right-handed perspective, depth 0..1."""
    h = 1.0 / math.tan(0.5 * fov_y)
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


class CameraTrait:
    """Anything that can produce view/projection matrices."""

    def view(self) -> np.ndarray:
        raise NotImplementedError

    def projection(self, aspect: float) -> np.ndarray:
        raise NotImplementedError

    @property
    def pos(self) -> np.ndarray:
        raise NotImplementedError


class CameraOrbitControl(CameraTrait):
    """Orbit camera: the position orbits a target point."""

    def __init__(self, target=(0, 0, 0), pos=(0, 0, -1), z=(0.1, 1e4),
                 vertical_fov=math.radians(60.0)):
        self.target = np.asarray(target, np.float32)
        self._pos = np.asarray(pos, np.float32)
        self.z_near, self.z_far = z
        self.vertical_fov = vertical_fov

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, v) -> None:
        self._pos = np.asarray(v, np.float32)

    def view(self) -> np.ndarray:
        return look_at_rh(self._pos, self.target, np.array([0, 1, 0], np.float32))

    def projection(self, aspect: float) -> np.ndarray:
        return perspective_rh(self.vertical_fov, aspect, self.z_near, self.z_far)

    def arm(self) -> np.ndarray:
        return self._pos - self.target

    def orbit_by(self, d_yaw: float, d_pitch: float) -> None:
        """Rotate the position around the target (yaw, clamped pitch)."""
        arm = self.arm()
        r = float(np.linalg.norm(arm))
        if r == 0.0:
            return
        yaw = math.atan2(arm[0], arm[2]) + d_yaw
        pitch = math.asin(np.clip(arm[1] / r, -1.0, 1.0))
        pitch = float(np.clip(pitch + d_pitch, -math.pi / 2 + 1e-3, math.pi / 2 - 1e-3))
        self._pos = self.target + r * np.array(
            [math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)],
            np.float32,
        )

    def zoom_by(self, factor: float) -> None:
        arm = self.arm()
        r = float(np.linalg.norm(arm))
        new_r = float(np.clip(r * factor, self.z_near, self.z_far))
        if r > 0:
            self._pos = self.target + arm * (new_r / r)

    def pan_by(self, delta_world) -> None:
        """Translate both target and position."""
        d = np.asarray(delta_world, np.float32)
        self.target = self.target + d
        self._pos = self._pos + d
