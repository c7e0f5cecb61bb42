"""Gaussian edit pods and colour-edit math, the counterpart of
`wgpu_3dgs_viewer_app_tpu.core.edit`.

The per-splat edit state is a struct of arrays: `flags` (N,) u32 bit
patterns (int32 on a device), `rgb` (N, 3) f32 (hsv shift/scales, or the
override colour), `params` (N, 4) f32 (contrast, exposure, gamma, alpha).
Identity defaults: hsv (0, 1, 1), contrast 0, exposure 0, gamma 1, alpha 1.
An edit whose ENABLED bit is clear is an exact no-op.

`apply_edit_components` applies the edit one tensor per channel, with the
remainders open-coded through floor and the power as exp2(g * log2 x): the
plain version of the edit inside the port's kernels K1 and K4, which
evaluate the same expressions in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EDIT_FLAG_ENABLED = 1 << 0
EDIT_FLAG_HIDDEN = 1 << 1
EDIT_FLAG_OVERRIDE_COLOR = 1 << 2


@dataclasses.dataclass(frozen=True)
class GaussianEditPod:
    """One edit record: flags, rgb-or-hsv, contrast, exposure, gamma, alpha."""

    flags: int = 0
    rgb_or_hsv: tuple = (0.0, 1.0, 1.0)
    contrast: float = 0.0
    exposure: float = 0.0
    gamma: float = 1.0
    alpha: float = 1.0

    @staticmethod
    def identity() -> "GaussianEditPod":
        return GaussianEditPod()

    def as_arrays(self):
        return (
            np.uint32(self.flags),
            np.asarray(self.rgb_or_hsv, np.float32),
            np.asarray([self.contrast, self.exposure, self.gamma, self.alpha], np.float32),
        )


def _flag_masks(flags):
    flags = flags.to(torch.int64) & 0xFFFFFFFF
    enabled = (flags & EDIT_FLAG_ENABLED) != 0
    hidden = enabled & ((flags & EDIT_FLAG_HIDDEN) != 0)
    override = (flags & EDIT_FLAG_OVERRIDE_COLOR) != 0
    return enabled, hidden, override


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV with h in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(v)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    sd = torch.clamp_min(delta, 1e-12)
    hr = ((g - b) / sd) % 6.0
    hg = (b - r) / sd + 2.0
    hb = (r - g) / sd + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    h = torch.where(delta > 0, h, zero)
    return torch.stack([h, s, v], -1)


def _select6(i, options) -> torch.Tensor:
    out = options[5]
    for k in range(4, -1, -1):
        out = torch.where(i == k, options[k], out)
    return out


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV (h in [0, 1)) -> RGB."""
    h, s, v = hsv[..., 0] % 1.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    r = _select6(i, (v, q, p, p, t, v))
    g = _select6(i, (t, v, v, q, p, p))
    b = _select6(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], -1)


def apply_edit_components(r, g, b, opacity, flags, er, eg, eb, e_contrast, e_exposure,
                          e_gamma, e_alpha):
    """Component-form `apply_edit`: each operand a tensor broadcastable to
    (N,). Returns (r', g', b', opacity', hidden). The kernels' edit
    (`csrc/splat.cuh::gs_apply_edit`) repeats these expressions in order."""
    enabled, hidden, override = _flag_masks(flags)
    zero = torch.zeros_like(r)
    rc = torch.clamp(r, 0.0, 1.0)
    gc = torch.clamp(g, 0.0, 1.0)
    bc = torch.clamp(b, 0.0, 1.0)
    # --- rgb -> hsv ---
    maxc = torch.maximum(torch.maximum(rc, gc), bc)
    minc = torch.minimum(torch.minimum(rc, gc), bc)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    sd = torch.clamp_min(delta, 1e-12)
    hr = (gc - bc) / sd
    hr = hr - 6.0 * torch.floor(hr * (1.0 / 6.0))  # % 6
    hg = (bc - rc) / sd + 2.0
    hb = (rc - gc) / sd + 4.0
    h = torch.where(maxc == rc, hr, torch.where(maxc == gc, hg, hb)) * (1.0 / 6.0)
    h = torch.where(delta > 0, h, zero)
    # --- adjust: hue shift, saturation and value scale ---
    h = h + er
    s = s * eg
    v = v * eb
    # --- hsv -> rgb ---
    h = h - torch.floor(h)  # % 1
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    ii = i.to(torch.int32) % 6
    rh = _select6(ii, (v, q, p, p, t, v))
    gh = _select6(ii, (t, v, v, q, p, p))
    bh = _select6(ii, (p, p, t, v, v, q))
    ro = torch.where(override, er, rh)
    go = torch.where(override, eg, gh)
    bo = torch.where(override, eb, bh)

    gam = torch.clamp_min(e_gamma, 1e-6)

    def tone(x):
        x = (x - 0.5) * (1.0 + e_contrast) + 0.5
        x = torch.clamp(x * torch.exp2(e_exposure), 0.0, 1.0)
        # x^gam with x in [0, 1] as exp2(gam * log2 x); 0 stays 0.
        return torch.where(x > 0.0, torch.exp2(gam * torch.log2(torch.clamp_min(x, 1e-30))), zero)

    ro, go, bo = tone(ro), tone(go), tone(bo)
    return (torch.where(enabled, ro, r), torch.where(enabled, go, g), torch.where(enabled, bo, b),
            torch.where(enabled, opacity * e_alpha, opacity), hidden)

