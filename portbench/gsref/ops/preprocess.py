"""Per-splat preprocess, plain torch: a frozen copy of the port's plain
`ops.preprocess.preprocess`, gates included.

model + view transform -> 3D cov -> EWA conic -> SH->RGB -> gates and edits
(mask bits, per-splat edit, scene-wide selection edit, highlight) ->
opacity-aware extent -> frustum/alpha cull. Culled splats keep their slot
with valid=False and alpha 0. `dtype` is the precision of the arithmetic:
float32 as the frame states it, or a lower one for the benchmark's
precision control; the outputs are float32 either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.covariance import cov2d_to_conic_radius, project_cov3d_to_cov2d, transform_cov6_t
from ..core.edit import apply_edit_components
from ..core.sh import eval_sh_rest_channels
from ..data.compression import Compressions, cov3d_components, make_sh_coeff_fn, unpack_color0

ALPHA_EPS = 1.0 / 255.0


def host_array(x) -> np.ndarray:
    """A host copy of a scalar, array or tensor."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def selection_edit_scalars(selection_edit) -> tuple:
    """Scene-wide selection edit (flags, rgb (3,), params (4,)) -> (int
    flags, 3 + 4 f32-exact floats), as the kernels take them."""
    flags, rgb, params = selection_edit
    flags = int(host_array(flags).astype(np.int64).reshape(()))
    rgb = host_array(rgb).astype(np.float32).reshape(3).tolist()
    params = host_array(params).astype(np.float32).reshape(4).tolist()
    return flags & 0xFFFFFFFF, rgb, params


def highlight_scalars(highlight_rgba) -> list:
    """Highlight rgba (4,) -> four f32-exact floats."""
    return host_array(highlight_rgba).astype(np.float32).reshape(4).tolist()


def _and(a, b):
    return b if a is None else a & b


@dataclasses.dataclass
class PreprocessOut:
    """Per-splat screen-space quantities, each a flat (N,) tensor (f32;
    `valid` bool). The stacked `mean2d`/`conic`/`rgb` views serve the
    query code."""

    mean_x: torch.Tensor   # pixel coords
    mean_y: torch.Tensor
    conic_a: torch.Tensor  # inverse 2D covariance (A, B, C)
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    col_r: torch.Tensor
    col_g: torch.Tensor
    col_b: torch.Tensor
    alpha: torch.Tensor    # opacity; 0 where culled
    depth: torch.Tensor    # view-space depth (> 0 in front)
    radius: torch.Tensor   # pixel radius of the live extent
    valid: torch.Tensor    # survives culling and gating

    @property
    def mean2d(self) -> torch.Tensor:  # (N, 2)
        return torch.stack([self.mean_x, self.mean_y], dim=-1)

    @property
    def conic(self) -> torch.Tensor:  # (N, 3)
        return torch.stack([self.conic_a, self.conic_b, self.conic_c], dim=-1)

    @property
    def rgb(self) -> torch.Tensor:  # (N, 3)
        return torch.stack([self.col_r, self.col_g, self.col_b], dim=-1)


def _f32(x) -> float:
    """A Python float holding an exact f32 value."""
    return float(np.float32(x))


def camera_position_from_view(view) -> np.ndarray:
    """Camera world position (3,) f32 from a rigid view matrix: -R^T t."""
    view = np.asarray(view, np.float32)
    return (-(view[:3, :3].T @ view[:3, 3])).astype(np.float32)


def frame_scalars(view, proj, model, width: int, height: int, size: float = 1.0,
                  z_near: float = 0.1, z_far: float = 1e4) -> dict:
    """Per-frame scalars, each rounded to f32 as the reference computes
    them. `view`, `proj`, `model`: (4, 4) f32 matrices."""
    view = np.asarray(view, np.float32)
    proj = np.asarray(proj, np.float32)
    model = np.asarray(model, np.float32)
    f32 = np.float32
    size32 = f32(size)
    r = view[:3, :3]
    p00, p11 = proj[0, 0], proj[1, 1]
    r_pt = max(f32(2.0) * size32, f32(1.0))
    return {
        "m3": model[:3, :3].tolist(),
        "mt": model[:3, 3].tolist(),
        "v3": r.tolist(),
        "vt": view[:3, 3].tolist(),
        "p00": float(p00),
        "p11": float(p11),
        "fx": float(f32(0.5 * width) * p00),
        "fy": float(f32(0.5 * height) * p11),
        "tanx": float(f32(1.0) / p00),
        "tany": float(f32(1.0) / p11),
        # Centre-clamp limits of the EWA Jacobian (core.covariance).
        "limx": float(f32(1.3) * (f32(1.0) / p00)),
        "limy": float(f32(1.3) * (f32(1.0) / p11)),
        "width": float(width),
        "height": float(height),
        "size": float(size32),
        "size2": float(size32 * size32),
        "cam": camera_position_from_view(view).tolist(),
        "z_near": _f32(z_near),
        "z_far": _f32(z_far),
        "r_pt": float(r_pt),
        "inv_pt": float(f32(4.0) / (r_pt * r_pt)),
    }


def _affine(m, t, x, y, z) -> tuple:
    """Three (N,) components through a scalar (3, 3) + (3,) affine."""
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z + t[0],
        m[1][0] * x + m[1][1] * y + m[1][2] * z + t[1],
        m[2][0] * x + m[2][1] * y + m[2][2] * z + t[2],
    )


def preprocess(
    pod: dict,
    comp: Compressions,
    view,
    proj,
    model,
    width: int,
    height: int,
    sh_degree: int = 3,
    no_sh0: bool = False,
    size: float = 1.0,
    display_mode: int = 0,
    z_near: float = 0.1,
    z_far: float = 1e4,
    mask_bits=None,
    edit=None,
    selection_bits=None,
    selection_edit=None,
    highlight_rgba=None,
    dtype=torch.float32,
) -> PreprocessOut:
    """The per-splat preprocess over the flat word pod (tensors on any
    device). `view`, `proj`, `model`: (4, 4) f32 host matrices.

    Gates, as in the JAX preprocess: `mask_bits` (N,) keeps splats whose
    bit is set; `edit` is the per-splat edit SoA (flags (N,), rgb (N, 3),
    params (N, 4)); `selection_edit` (flags, rgb (3,), params (4,)) and
    `highlight_rgba` (4,) apply to the splats whose `selection_bits` (N,)
    bit is set, and only when `selection_bits` is given. Edits act before
    the opacity-aware extent, so an edited alpha shapes radius and key."""
    fs = frame_scalars(view, proj, model, width, height, size, z_near, z_far)
    pos = pod["pos"].to(dtype)
    (c0_r, c0_g, c0_b), alpha = unpack_color0(pod)
    c0_r, c0_g, c0_b, alpha = (v.to(dtype) for v in (c0_r, c0_g, c0_b, alpha))
    cov6c = tuple(c.to(dtype) for c in cov3d_components(pod))
    sh_coeff = make_sh_coeff_fn(pod, comp)

    # --- model transform; the covariance scales by size^2 ---
    wx, wy, wz = _affine(fs["m3"], fs["mt"], pos[0], pos[1], pos[2])
    cov6_w = tuple(c * fs["size2"] for c in transform_cov6_t(cov6c, fs["m3"]))

    # --- view transform, depth, projection to pixels ---
    tvx, tvy, tvz = _affine(fs["v3"], fs["vt"], wx, wy, wz)
    depth = -tvz
    d = torch.clamp_min(depth, 1e-6)
    ndc_x = fs["p00"] * tvx / d
    ndc_y = fs["p11"] * tvy / d
    px = (ndc_x * 0.5 + 0.5) * fs["width"]
    py = (0.5 - ndc_y * 0.5) * fs["height"]

    cov2d = project_cov3d_to_cov2d(cov6_w, (tvx, tvy, tvz), fs["v3"], (fs["fx"], fs["fy"]),
                                   (fs["tanx"], fs["tany"]))
    (ca, cb, cc), radius, det_ok = cov2d_to_conic_radius(cov2d)
    if display_mode == 2:
        # POINT: a flat disc of fixed pixel radius; the conic makes the
        # compositor's flat cut (power >= -2) equal dist <= r.
        radius = torch.full_like(px, fs["r_pt"])
        ca = torch.full_like(px, fs["inv_pt"])
        cb = torch.zeros_like(px)
        cc = ca

    # --- SH -> RGB; the degree-0 term is the u8 color0 ---
    base = (c0_r, c0_g, c0_b) if not no_sh0 else (0.5, 0.5, 0.5)
    if sh_degree >= 1:
        cam = fs["cam"]
        dx, dy, dz = wx - cam[0], wy - cam[1], wz - cam[2]
        inv_n = torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-18))
        dr, dg, db = eval_sh_rest_channels(lambda k, c: sh_coeff(k, c).to(dtype), dx * inv_n,
                                           dy * inv_n, dz * inv_n, sh_degree)
        col = (dr + base[0], dg + base[1], db + base[2])
    else:
        col = tuple(b if torch.is_tensor(b) else torch.full_like(c0_r, b) for b in base)
    col_r, col_g, col_b = (torch.clamp(c, 0.0, 1.0) for c in col)

    # --- gates and edits: mask, per-splat edit, selection edit, highlight ---
    dev = pos.device
    gate = None
    if mask_bits is not None:
        gate = torch.as_tensor(mask_bits, device=dev) != 0
    if edit is not None:
        e_flags, e_rgb, e_params = (torch.as_tensor(x, device=dev) for x in edit)
        col_r, col_g, col_b, alpha, hidden = apply_edit_components(
            col_r, col_g, col_b, alpha, e_flags, *e_rgb.to(dtype).unbind(-1),
            *e_params.to(dtype).unbind(-1))
        gate = _and(gate, ~hidden)
    if selection_bits is not None and (selection_edit is not None or highlight_rgba is not None):
        sel = torch.as_tensor(selection_bits, device=dev) != 0
        if selection_edit is not None:
            s_flags, s_rgb, s_params = selection_edit_scalars(selection_edit)
            consts = torch.tensor(s_rgb + s_params, dtype=dtype, device=dev)
            flags = torch.where(sel, s_flags, 0)
            col_r, col_g, col_b, alpha, hidden = apply_edit_components(
                col_r, col_g, col_b, alpha, flags, *consts.unbind())
            gate = _and(gate, ~hidden)
        if highlight_rgba is not None:
            hl = np.asarray(highlight_scalars(highlight_rgba), np.float32)
            keep = float(np.float32(1.0) - hl[3])
            col_r, col_g, col_b = (torch.where(sel, c * keep + float(hl[k] * hl[3]), c)
                                   for k, c in enumerate((col_r, col_g, col_b)))

    # --- opacity-aware extent: exact live radius sigma*sqrt(2 ln(a/eps))
    # in splat mode, the 2-sigma flat cut in ellipse mode ---
    if display_mode == 0:
        cut = torch.sqrt(2.0 * torch.clamp_min(torch.log(alpha * (1.0 / ALPHA_EPS)), 0.0))
        radius = radius * (cut * (1.0 / 3.0))
    elif display_mode == 1:
        radius = radius * (2.0 / 3.0)

    on_screen = ((px + radius > 0) & (px - radius < fs["width"])
                 & (py + radius > 0) & (py - radius < fs["height"]))
    valid = (det_ok & (depth > fs["z_near"]) & (depth < fs["z_far"]) & on_screen
             & (alpha > ALPHA_EPS) & (radius > 0))
    if gate is not None:
        valid = valid & gate
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    f = lambda v: v.to(torch.float32)  # noqa: E731
    return PreprocessOut(
        mean_x=f(px), mean_y=f(py), conic_a=f(ca), conic_b=f(cb), conic_c=f(cc),
        col_r=f(col_r), col_g=f(col_g), col_b=f(col_b),
        alpha=f(alpha), depth=f(depth), radius=f(radius), valid=valid,
    )
