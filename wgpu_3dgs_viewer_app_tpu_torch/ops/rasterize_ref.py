"""Brute-force per-pixel reference rasteriser (test oracle).

Composites every splat against every pixel in exact global front-to-back
depth order with full f32 depth: no tiling, no duplication cap, no key
quantisation. O(N * H * W) with a Python loop over splats: small scenes
only. Port of `wgpu_3dgs_viewer_app_tpu.ops.rasterize_ref`.
"""

from __future__ import annotations

import torch

from .binning import ALPHA_MAX
from .composite import ALPHA_EPS, FLAT_POWER_CUTOFF
from .preprocess import PreprocessOut


def rasterize_reference(pre: PreprocessOut, width: int, height: int,
                        flat_mode: bool = False) -> torch.Tensor:
    """Returns (H, W, 4) premultiplied rgb + alpha."""
    dev = pre.mean_x.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    t = torch.ones((height, width), device=dev)
    acc = torch.zeros((height, width, 3), device=dev)
    for i in torch.argsort(pre.depth, stable=True).tolist():
        if not bool(pre.valid[i]):
            continue
        dx = px - pre.mean_x[i]
        dy = py - pre.mean_y[i]
        power = (-0.5 * (pre.conic_a[i] * dx * dx + pre.conic_c[i] * dy * dy)
                 - pre.conic_b[i] * dx * dy)
        if flat_mode:
            av = torch.where(power >= FLAT_POWER_CUTOFF, pre.alpha[i], 0.0)
        else:
            av = pre.alpha[i] * torch.exp(torch.clamp_max(power, 0.0))
        av = torch.clamp_max(av, ALPHA_MAX)
        av = torch.where(av < ALPHA_EPS, 0.0, av)
        col = torch.stack([pre.col_r[i], pre.col_g[i], pre.col_b[i]])
        acc = acc + (t * av)[..., None] * col
        t = t * (1.0 - av)
    return torch.cat([acc, (1.0 - t)[..., None]], dim=-1)
