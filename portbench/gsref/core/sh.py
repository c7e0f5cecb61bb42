"""Spherical harmonics evaluation (degree 0..3) in component form (torch).

The standard real-SH basis of Inria 3DGS PLYs (f_dc + 45 f_rest
coefficients), with the terms and summation order of
`wgpu_3dgs_viewer_app_tpu.core.sh`; `csrc/fused.cu` repeats them.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis_terms(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, degree: int) -> list:
    """Rest-coefficient basis values as a list of (N,) tensors."""
    terms = []
    if degree >= 1:
        terms += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        terms += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - yy),
        ]
    return terms


def eval_sh_rest_channels(coeff_fn, dirs_x, dirs_y, dirs_z, degree: int) -> list:
    """Rest-SH contribution per channel: [r, g, b] (N,) deltas.

    `coeff_fn(k, c)` returns the (N,) f32 coefficient of rest-coefficient k,
    channel c (dequantised on the fly)."""
    basis = sh_basis_terms(dirs_x, dirs_y, dirs_z, degree)
    out = []
    for c in range(3):
        acc = None
        for k, bk in enumerate(basis):
            term = bk * coeff_fn(k, c)
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(dirs_x))
    return out
