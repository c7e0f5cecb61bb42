"""Gesture `mask_drag`: one of the mix's mask shapes, drawn from the seed,
moved from its place by a seeded offset of up to `drag.offset` scene
scales on each axis, and EvaluateMask sent on the command bus. The
reference works the mask out again from the shapes the sample keeps."""

import numpy as np


def apply(d) -> None:
    t = d.traffic["drag"]
    k = int(d.rng.integers(len(d.shapes)))
    scale = float(d.config["scene"]["models"][0]["scene_scale"])
    off = d.rng.uniform(-1.0, 1.0, 3).astype(np.float32) * np.float32(t["offset"] * scale)
    d.shapes[k]["pos"] = d.base_shapes[k]["pos"] + off
    d.session.mask.shapes[k].pos = d.shapes[k]["pos"].copy()
    d.evaluate_mask()
