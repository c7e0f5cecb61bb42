from .camera import CameraOrbitControl, CameraTrait, look_at_rh, perspective_rh
from .transform import (
    GaussianDisplayMode,
    GaussianShDegree,
    GaussianTransform,
    ModelTransform,
    quat_from_euler_zyx_deg,
    quat_to_mat3,
)

__all__ = [
    "CameraOrbitControl",
    "CameraTrait",
    "look_at_rh",
    "perspective_rh",
    "GaussianDisplayMode",
    "GaussianShDegree",
    "GaussianTransform",
    "ModelTransform",
    "quat_from_euler_zyx_deg",
    "quat_to_mat3",
]
