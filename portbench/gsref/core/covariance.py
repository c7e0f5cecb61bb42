"""3D covariance construction and EWA projection to 2D conics (torch).

Component form, as in `wgpu_3dgs_viewer_app_tpu.core.covariance`: every
3x3 product is written out over flat (N,) tensors, in the reference's
operation order, so the plain path rounds like the reference and like the
front-end kernel (`csrc/fused.cu`), which repeats the same expressions.

Conventions: the view matrix is `look_at_rh` (camera looks down -Z, depth =
-z_view); pixel y points down, so the projection Jacobian's y row is negated.
"""

from __future__ import annotations

import numpy as np
import torch

# Screen-space low-pass filter added to the projected covariance.
COV2D_DILATION = 0.3


def quat_rot_components(q: torch.Tensor) -> tuple:
    """Quaternion (..., 4) (w, x, y, z), possibly unnormalised -> the nine
    rotation-matrix components as a 3x3 nested tuple of (...,) tensors.

    The norm accumulates the squares as fused multiply-adds (exact products
    in f64, one f32 rounding per step), the order in which the reference's
    `norm` rounds, and takes a correctly rounded square root, so the packed
    covariances match the reference byte for byte. The root is numpy's f64
    `sqrt` (the hardware instruction, correctly rounded): torch's CPU `sqrt`
    goes through a vector math library that is not, neither in f32 (an ulp
    off on ~0.6% of inputs) nor in f64, where the first call of a process
    under load was seen to split the array between two threads and return
    the second half at about f32 accuracy."""
    d = q.to(torch.float64)
    acc = (d[..., 0] * d[..., 0]).to(torch.float32)
    for i in range(1, q.shape[-1]):
        acc = (d[..., i] * d[..., i] + acc.to(torch.float64)).to(torch.float32)
    root = np.sqrt(acc.cpu().numpy().astype(np.float64)).astype(np.float32)
    q = q / torch.from_numpy(root).to(q.device)[..., None]
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> (..., 3, 3) rotation (small and test use)."""
    r = quat_rot_components(q)
    return torch.stack([torch.stack(row, -1) for row in r], -2)


def cov3d_from_scale_rot(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T as (..., 6) uniques (xx, xy, xz, yy, yz, zz).

    `scale`: (..., 3) linear scales; `quat`: (..., 4) (w, x, y, z)."""
    r = quat_rot_components(quat)
    s2 = (scale[..., 0] ** 2, scale[..., 1] ** 2, scale[..., 2] ** 2)

    def sig(i, j):
        return r[i][0] * s2[0] * r[j][0] + r[i][1] * s2[1] * r[j][1] + r[i][2] * s2[2] * r[j][2]

    return torch.stack(
        [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)], dim=-1
    )


def transform_cov6_t(cov6c: tuple, m) -> tuple:
    """Congruence transform Sigma' = M Sigma M^T for a scalar (3, 3) M
    (nested sequence of floats). `cov6c`: six (N,) uniques."""
    xx, xy, xz, yy, yz, zz = cov6c
    s = ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))

    def t(i, k):
        return m[i][0] * s[0][k] + m[i][1] * s[1][k] + m[i][2] * s[2][k]

    def out(i, j):
        return t(i, 0) * m[j][0] + t(i, 1) * m[j][1] + t(i, 2) * m[j][2]

    return (out(0, 0), out(0, 1), out(0, 2), out(1, 1), out(1, 2), out(2, 2))


def unpack_cov3d(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) uniques -> (..., 3, 3) symmetric matrix (small and test use)."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def project_cov3d_to_cov2d(cov6c: tuple, t_view: tuple, view3, focal: tuple,
                           tan_half_fov: tuple) -> tuple:
    """EWA projection: world covariance -> 2D pixel covariance (a, b, c),
    including the low-pass dilation.

    `t_view`: three (N,) view-space centre components; `view3`: (3, 3) view
    rotation (nested floats); `focal`: (fx, fy) in pixels; `tan_half_fov`
    bounds the centre clamp. cov2d = (J W) Sigma (J W)^T with
    J = [[fx/d, 0, fx*tx/d^2], [0, -fy/d, -fy*ty/d^2]].
    """
    fx, fy = focal
    tx, ty, tz = t_view
    d = torch.clamp_min(-tz, 1e-6)
    # Clamp the projected centre to 1.3x the frustum (bounds the Jacobian);
    # the limits round like the reference's f32 scalar product.
    limx, limy = (float(np.float32(1.3) * np.float32(t)) for t in tan_half_fov)
    txc = torch.clamp(tx / d, -limx, limx) * d
    tyc = torch.clamp(ty / d, -limy, limy) * d

    inv_d = 1.0 / d
    inv_d2 = inv_d * inv_d
    j00 = fx * inv_d
    j02 = fx * txc * inv_d2
    j11 = -fy * inv_d
    j12 = -fy * tyc * inv_d2

    p = [j00 * view3[0][k] + j02 * view3[2][k] for k in range(3)]
    q = [j11 * view3[1][k] + j12 * view3[2][k] for k in range(3)]

    xx, xy, xz, yy, yz, zz = cov6c
    sp0 = xx * p[0] + xy * p[1] + xz * p[2]
    sp1 = xy * p[0] + yy * p[1] + yz * p[2]
    sp2 = xz * p[0] + yz * p[1] + zz * p[2]
    sq0 = xx * q[0] + xy * q[1] + xz * q[2]
    sq1 = xy * q[0] + yy * q[1] + yz * q[2]
    sq2 = xz * q[0] + yz * q[1] + zz * q[2]

    a = p[0] * sp0 + p[1] * sp1 + p[2] * sp2 + COV2D_DILATION
    b = q[0] * sp0 + q[1] * sp1 + q[2] * sp2
    c = q[0] * sq0 + q[1] * sq1 + q[2] * sq2 + COV2D_DILATION
    return (a, b, c)


def cov2d_to_conic_radius(cov2d: tuple) -> tuple:
    """2D covariance (a, b, c) -> ((A, B, C) conic, 3-sigma radius px, det > 0)."""
    a, b, c = cov2d
    det = a * c - b * b
    valid = det > 0.0
    inv_det = torch.where(valid, 1.0 / torch.clamp_min(det, 1e-12), torch.zeros_like(det))
    conic = (c * inv_det, -b * inv_det, a * inv_det)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
    return conic, radius, valid
