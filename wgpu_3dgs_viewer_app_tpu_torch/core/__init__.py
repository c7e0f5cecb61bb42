from .camera import Camera, CameraOrbitControl, CameraTrait, look_at_rh, perspective_rh
from .edit import (
    EDIT_FLAG_ENABLED,
    EDIT_FLAG_HIDDEN,
    EDIT_FLAG_OVERRIDE_COLOR,
    GaussianEditPod,
    SelectionHighlightPod,
    apply_edit,
    apply_edit_components,
    apply_edit_np,
    make_edit_soa,
)
from .transform import (
    GaussianDisplayMode,
    GaussianShDegree,
    GaussianTransform,
    ModelTransform,
    quat_from_euler_zyx_deg,
    quat_to_mat3,
)

__all__ = [
    "Camera",
    "CameraOrbitControl",
    "CameraTrait",
    "look_at_rh",
    "perspective_rh",
    "EDIT_FLAG_ENABLED",
    "EDIT_FLAG_HIDDEN",
    "EDIT_FLAG_OVERRIDE_COLOR",
    "GaussianEditPod",
    "SelectionHighlightPod",
    "apply_edit",
    "apply_edit_components",
    "apply_edit_np",
    "make_edit_soa",
    "GaussianDisplayMode",
    "GaussianShDegree",
    "GaussianTransform",
    "ModelTransform",
    "quat_from_euler_zyx_deg",
    "quat_to_mat3",
]
