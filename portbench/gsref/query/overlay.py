"""Selection overlays on a composited (H, W, 3) frame: the in-progress
rect/brush region and the brush cursor ring. Counterpart of
`wgpu_3dgs_viewer_app_tpu.query.overlay`. On a CUDA frame each is one
launch of kernel K9 (`ops.overlay`, `csrc/overlay.cu`) with that stage
alone; on the CPU its plain version, a torch image pass, runs.
"""

from __future__ import annotations

import torch

TEXTURE_RGBA = (1.0, 0.0, 1.0, 0.25)
CURSOR_RGBA = (1.0, 1.0, 1.0, 0.9)
CURSOR_THICKNESS = 1.5


def overlay_texture_plain(img: torch.Tensor, texture: torch.Tensor,
                          color=TEXTURE_RGBA) -> torch.Tensor:
    """Plain version of K9's tint stage."""
    c = torch.as_tensor(color, dtype=torch.float32, device=img.device)
    t = texture.to(torch.float32)[..., None] * c[3]
    return img * (1.0 - t) + t * c[:3]


def overlay_cursor_ring_plain(img: torch.Tensor, center, radius, color=CURSOR_RGBA,
                              thickness: float = CURSOR_THICKNESS) -> torch.Tensor:
    """Plain version of K9's ring stage."""
    h, w = img.shape[:2]
    c = torch.as_tensor(color, dtype=torch.float32, device=img.device)
    center = torch.as_tensor(center, dtype=torch.float32, device=img.device)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=img.device)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] + 0.5
    d = torch.sqrt((xs - center[0]) ** 2 + (ys - center[1]) ** 2)
    cover = torch.clamp(thickness - torch.abs(d - radius), 0.0, 1.0) * c[3]
    return img * (1.0 - cover[..., None]) + cover[..., None] * c[:3]
