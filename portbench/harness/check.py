"""What decides `correct`: the outputs the window kept, held against the
plain reference at the same inputs, each number beside its limit.

Numbers (each the worst over the kept samples):
- `img_gap_p9999`: the 99.99th percentile of a frame's pixel-channel gaps
  from the reference's frame: every gap but the widest 0.01% (~620 of a
  1080p frame's 6.2M channel values). The widest gap itself is no limit:
  the port packs with a compiled codec whose f16 covariance differs from
  the reference's numpy pack by a step in a few words, and on a near-flat
  splat seen edge-on such a step moves a handful of pixels far (widest
  gaps of 0.002 on most seeds, 0.017 and 0.060 on two of 36);
- `img_gaps_over_0.1`: a frame's channel values whose gap is over 0.1:
  none on any sound run, so that a fault confined to a few hundred
  pixels, which the 99.99th percentile would leave out, is counted;
- `img_mean_abs`: a frame's mean gap;
- `jpeg_coef_max_abs`, `jpeg_coef_mean_abs`: a served JPEG's quantised
  DCT coefficients, read back from the file, against those of the
  reference's frame (dummy blocks past the image's edge left out);
- `mask_bits_differ`, `sel_bits_differ`: the session's mask and selection
  bits as the window left them, against the reference's from the same
  shapes, rect and camera (splats that differ);
- `failed`: steps of the window that raised.
A cell's limits are `limits/<workload>.json`; a number over its limit, or
one the cell should give and did not, makes the run not correct."""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref
from . import spec

HIGHLIGHT_RGBA = (1.0, 0.0, 1.0, 127 / 255)   # the session's default highlight colour
# The app's orbit drag: radians a pixel (the camera's default sensitivity
# 0.5 times the viewport's 0.005).
ORBIT_RAD_PER_PX = 0.5 * 0.005


TAIL = 1e-4   # the share of a frame's widest gaps `img_gap_p9999` leaves out
WIDE = 0.1    # a gap `img_gaps_over_0.1` counts


def image_gaps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(widest gap, the gap at the 99.99th percentile, mean gap, channel
    values whose gap is over WIDE)."""
    d = (got.to(want.device, torch.float32) - want).abs().flatten()
    k = max(1, int(np.ceil(TAIL * d.numel())))
    return (float(d.max()), float(torch.topk(d, k).values[-1]), float(d.mean()),
            int((d > WIDE).sum()))


def _worst(numbers: dict, name: str, value: float) -> None:
    numbers[name] = max(numbers.get(name, value), value)


def selection_bits(R: ref.Reference, op: str, sel: dict) -> torch.Tensor:
    """The reference's selection bits of a selection gesture's inputs, by
    the gesture's own file (`gestures/<name>.py`), gated by the mask as it
    stood then."""
    mask_then = R.mask_bits(op, ref.mask_shapes(sel["shapes"]))
    return spec.load("gestures", sel["gesture"]).selection_bits(R, sel, mask_then)


def session_gates(R: ref.Reference, traffic: dict, snap: dict) -> dict:
    """The gates of the session's frame at a kept step, worked out again
    from the shapes and the last rect selection's inputs."""
    op = traffic["mask"]["op"]
    shapes = ref.mask_shapes(snap["shapes"])
    gates = {"mask_bits": R.mask_bits(op, shapes)}
    sel = snap["selection"]
    if sel is not None:
        gates["selection_bits"] = selection_bits(R, op, sel)
        gates["selection_edit"] = ref.selection_edit_arrays(traffic["selection_edit"])
        gates["highlight_rgba"] = np.asarray(HIGHLIGHT_RGBA, np.float32)
    return gates


def judge_frames(R: ref.Reference, cell, samples: list, numbers: dict) -> None:
    """Each kept frame against the reference's at its camera and state."""
    for snap in samples:
        cam = ref.camera_at(cell.config, snap["yaw"])
        if "shapes" not in snap:    # a viewer frame: no gates, no gizmos
            want = R.frame(cam)
        else:
            want = R.frame(cam, gates=[session_gates(R, cell.traffic, snap)],
                           shapes=ref.mask_shapes(snap["shapes"]))
        mx, tail, mean, wide = image_gaps(snap["img"], want)
        _worst(numbers, "img_max_abs", mx)
        _worst(numbers, "img_gap_p9999", tail)
        _worst(numbers, "img_mean_abs", mean)
        _worst(numbers, "img_gaps_over_0.1", wide)
        del want


def real_blocks(width: int, height: int) -> np.ndarray:
    """Which blocks of a 4:2:0 scan are the image's own (the dummy luma
    blocks that fill the last MCU row and column are not)."""
    from gsref.utils.jpeg import mcu_grid

    mr, mc, hb, wb = mcu_grid(width, height)
    blk = np.arange(mr * mc * 6) % 6
    mcu = np.arange(mr * mc * 6) // 6
    by, bx = (mcu // mc) * 2 + blk // 2, (mcu % mc) * 2 + blk % 2
    return (blk >= 4) | ((by < hb) & (bx < wb))


def judge_served(R: ref.Reference, cell, samples: list, yaw0: float, numbers: dict) -> None:
    """Each kept served frame's coefficients against the reference frame's
    at the camera its orbit drags led to."""
    from gsref.utils import jpeg, jpeg_decode

    q = int(cell.traffic.get("quality", 85))
    real = real_blocks(cell.config["width"], cell.config["height"])
    for snap in samples:
        cam = ref.camera_at(cell.config, yaw0)
        for dx in snap["events"]:
            cam.orbit_by(-dx * ORBIT_RAD_PER_PX, 0.0)
        snap = dict(snap, selection=None)
        want = R.frame(cam, gates=[session_gates(R, cell.traffic, snap)],
                       shapes=ref.mask_shapes(snap["shapes"]))
        want = jpeg.coefficients(jpeg.frame_to_u8(want), q).cpu().numpy()
        w, h, _, got = jpeg_decode.decode_coefficients(snap["jpeg"])
        if (w, h) != (cell.config["width"], cell.config["height"]) or got.shape != want.shape:
            numbers["jpeg_coef_max_abs"] = float("inf")
            continue
        gap = np.abs(got[real].astype(np.int64) - want[real])
        _worst(numbers, "jpeg_coef_max_abs", float(gap.max()))
        _worst(numbers, "jpeg_coef_mean_abs", float(gap.mean()))


def judge_bits(R: ref.Reference, cell, final: dict, numbers: dict) -> None:
    op = cell.traffic["mask"]["op"]
    want = R.mask_bits(op, ref.mask_shapes(final["shapes"]))
    numbers["mask_bits_differ"] = int((final["mask"].to(want.device) != want).sum())
    sel = final["selection_in"]
    if sel is not None:
        want = selection_bits(R, op, sel)
        numbers["sel_bits_differ"] = int((final["selection"].to(want.device) != want).sum())


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number present and
    within its limit."""
    rows = [(name, numbers.get(name), lim) for name, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
