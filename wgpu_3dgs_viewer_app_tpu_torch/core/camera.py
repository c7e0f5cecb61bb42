"""Cameras: view/projection matrices and the orbit and first-person controls
(host-side numpy).

Same conventions as `wgpu_3dgs_viewer_app_tpu.core.camera`: right-handed,
the camera looks down -Z, NDC z in [0, 1] (glam `look_at_rh` /
`perspective_rh`), column vectors (`p_clip = P @ V @ M @ p`). Matrices are
(4, 4) f32 numpy arrays; the viewer turns them into frame parameters.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# A 3-vector on the host: (3,) f32 numpy.
Vec3 = np.ndarray


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`np.cross` of two (3,) f32 vectors, term for term as it rounds (each
    product in f32, then their difference), without its general-axis
    machinery, which costs a frame's camera ~30 us a call."""
    a0, a1, a2 = a.tolist()
    b0, b1, b2 = b.tolist()
    f32 = np.float32
    return np.array([f32(a1) * f32(b2) - f32(a2) * f32(b1),
                     f32(a2) * f32(b0) - f32(a0) * f32(b2),
                     f32(a0) * f32(b1) - f32(a1) * f32(b0)], np.float32)


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = _cross(f, up)
    s = s / np.linalg.norm(s)
    u = _cross(s, f)
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


class CameraFirstPersonControl(CameraTrait):
    """First-person camera: a position with yaw and pitch."""

    def __init__(self, z=(0.1, 1e4), vertical_fov=math.radians(60.0)):
        self._pos = np.zeros(3, np.float32)
        self.yaw = 0.0
        self.pitch = 0.0
        self.z_near, self.z_far = z
        self.vertical_fov = vertical_fov

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, v) -> None:
        self._pos = np.asarray(v, np.float32)

    def get_forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([cp * math.sin(self.yaw), math.sin(self.pitch), cp * math.cos(self.yaw)],
                        np.float32)

    def get_right(self) -> np.ndarray:
        r = np.cross(self.get_forward(), np.array([0, 1, 0], np.float32))
        n = np.linalg.norm(r)
        return r / n if n > 0 else np.array([1, 0, 0], np.float32)

    def yaw_by(self, d: float) -> None:
        self.yaw = (self.yaw + d) % (2 * math.pi)

    def pitch_by(self, d: float) -> None:
        self.pitch = float(np.clip(self.pitch + d, -math.pi / 2 + 1e-3, math.pi / 2 - 1e-3))

    def view(self) -> np.ndarray:
        return look_at_rh(self._pos, self._pos + self.get_forward(),
                          np.array([0, 1, 0], np.float32))

    def projection(self, aspect: float) -> np.ndarray:
        return perspective_rh(self.vertical_fov, aspect, self.z_near, self.z_far)


def to_first_person(control: CameraTrait) -> CameraFirstPersonControl:
    """Orbit -> first person at the same pose (a first-person control is
    returned as it is)."""
    if isinstance(control, CameraFirstPersonControl):
        return control
    if not isinstance(control, CameraOrbitControl):
        raise TypeError(f"no first-person pose for {type(control).__name__}")
    direction = control.target - control.pos
    direction = direction / np.linalg.norm(direction)
    fp = CameraFirstPersonControl(z=(control.z_near, control.z_far),
                                  vertical_fov=control.vertical_fov)
    fp.pos = control.pos.copy()
    fp.yaw = math.atan2(direction[0], direction[2])
    fp.pitch = math.asin(float(np.clip(direction[1], -1, 1)))
    return fp


def to_orbit(control: CameraTrait, arm_length: float) -> CameraOrbitControl:
    """First person -> orbit about the point `arm_length` ahead (an orbit
    control is returned as it is)."""
    if isinstance(control, CameraOrbitControl):
        return control
    if not isinstance(control, CameraFirstPersonControl):
        raise TypeError(f"no orbit pose for {type(control).__name__}")
    return CameraOrbitControl(target=control.pos + control.get_forward() * arm_length,
                              pos=control.pos.copy(), z=(control.z_near, control.z_far),
                              vertical_fov=control.vertical_fov)


@dataclasses.dataclass
class Camera:
    """Session camera: a control plus movement speed and sensitivity."""

    control: CameraTrait
    speed: float = 1.0
    sensitivity: float = 0.5

    @staticmethod
    def default() -> "Camera":
        return Camera(control=CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -1), z=(0.1, 1e4),
                                                 vertical_fov=math.radians(60.0)))
