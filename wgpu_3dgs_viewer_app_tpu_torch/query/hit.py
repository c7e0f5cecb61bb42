"""Hit queries: which splat lies under a pixel, and where on the pixel's
ray. Counterpart of `wgpu_3dgs_viewer_app_tpu.query.hit`: resolution runs on
the device as reductions over the per-splat preprocess outputs, and only
the (found, world position) result is a host-sized value.

A splat is a candidate when its Gaussian alpha at the pixel clears a
threshold. MOST_ALPHA picks the candidate with the largest composited
contribution (T * alpha, front to back by depth); CLOSEST the smallest
depth.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..ops.preprocess import PreprocessOut, host_array


class MeasurementHitMethod(enum.Enum):
    """Hit resolution method; MOST_ALPHA by default."""

    MOST_ALPHA = "most_alpha"
    CLOSEST = "closest"


def alpha_at_pixel(pre: PreprocessOut, pixel) -> torch.Tensor:
    """Per-splat Gaussian alpha at one pixel -> (N,) f32."""
    px, py = host_array(pixel).astype(np.float32).reshape(2).tolist()
    dx = px - pre.mean_x
    dy = py - pre.mean_y
    power = -0.5 * (pre.conic_a * (dx * dx) + pre.conic_c * (dy * dy)) - pre.conic_b * dx * dy
    alpha = pre.alpha * torch.exp(torch.clamp_max(power, 0.0))
    return torch.where(pre.valid & (power <= 0.0), alpha, torch.zeros_like(alpha))


def _pixel_ray_world(pixel, view, proj, width: int, height: int) -> tuple:
    """World-space ray (origin, direction at unit depth) through a pixel, f32."""
    f32 = np.float32
    px, py = host_array(pixel).astype(f32).reshape(2)
    view, proj = np.asarray(view, f32), np.asarray(proj, f32)
    u = (px / f32(width)) * f32(2.0) - f32(1.0)
    v = f32(1.0) - (py / f32(height)) * f32(2.0)
    dir_view = np.array([u * (f32(1.0) / proj[0, 0]), v * (f32(1.0) / proj[1, 1]), -1.0], f32)
    r = view[:3, :3]
    return (-(r.T @ view[:3, 3])).astype(f32), (r.T @ dir_view).astype(f32)


def query_hit(pre: PreprocessOut, pixel, view, proj, width: int, height: int,
              method: MeasurementHitMethod = MeasurementHitMethod.MOST_ALPHA,
              alpha_threshold: float = 0.05) -> tuple:
    """Resolve a hit at `pixel` -> (found () bool, world_pos (3,) f32), both
    on the device of `pre`. The position lies on the pixel's ray at the
    winning splat's view depth."""
    alpha = alpha_at_pixel(pre, pixel)
    inf = torch.full_like(pre.depth, float("inf"))
    if method == MeasurementHitMethod.CLOSEST:
        cand = alpha > 1.0 / 255.0
        win = torch.argmin(torch.where(cand, pre.depth, inf))
        found = cand[win]
    else:
        cand = alpha >= alpha_threshold
        # Weight = composited contribution T_i * a_i, front to back.
        order = torch.sort(torch.where(cand, pre.depth, inf), stable=True).indices
        a_sorted = torch.where(cand[order], alpha[order], torch.zeros_like(alpha))
        incl = torch.cumprod(1.0 - a_sorted, dim=0)
        t_excl = torch.cat([torch.ones_like(incl[:1]), incl[:-1]])
        win = order[torch.argmax(t_excl * a_sorted)]
        found = cand.any()
    cam_pos, dir_world = (torch.from_numpy(v).to(pre.depth.device)
                          for v in _pixel_ray_world(pixel, view, proj, width, height))
    return found, cam_pos + dir_world * pre.depth[win]
