"""Gesture `brush`: one pointer event of a brush stroke a frame, through the
session's QueryToolset, and the reference's replay of the strokes.

A stroke is `brush.events` events: `start` on the first, `update_pos` on
each later one, and `end_selection_gesture()` on the last. It starts at a
seeded point in the central `brush.start_frac` of the viewport and moves
`brush.step_px` px an event (seeded) along a seeded heading that turns by
up to `brush.turn_deg` an event, turned back where it would leave the
viewport. Strokes run the mix's `brush.cycle` of (op, mode) in turn; a
stroke's points come from the seed and the stroke's number alone, so the
same step gives the same event however often it runs.

The driver (`entries/select_session.py`) keeps the strokes since the last
SET that took effect, each with the points the port was sent; the
reference replays them (`selection_bits`): a texture stroke once it has
ended (paint its segments, sample the texture at the centres of the
degree-0 preprocess at the stroke's camera, combine with the stroke's op),
an immediate stroke event by event (its first event carries the stroke's
op, later ones ADD where the op is SET, as the toolset emits them)."""

import math

import numpy as np
import torch

from harness import reference as ref


def stroke_points(traffic: dict, seed: int, k: int, width: int, height: int) -> list:
    """The `brush.events` pointer positions (x, y) of stroke `k`, as f32
    values, inside the viewport."""
    b = traffic["brush"]
    rng = np.random.Generator(np.random.SFC64([int(seed), k % (1 << 32), 0xB805]))
    lo = 0.5 * (1.0 - float(b["start_frac"]))
    x, y = float(rng.uniform(lo, 1.0 - lo)) * width, float(rng.uniform(lo, 1.0 - lo)) * height
    heading = float(rng.uniform(0.0, 2.0 * math.pi))
    turn = math.radians(float(b["turn_deg"]))
    pts = [(x, y)]
    for _ in range(int(b["events"]) - 1):
        heading += float(rng.uniform(-turn, turn))
        step = float(rng.uniform(*b["step_px"]))
        nx, ny = x + step * math.cos(heading), y + step * math.sin(heading)
        if not 0.0 <= nx <= width:
            heading = math.pi - heading
        if not 0.0 <= ny <= height:
            heading = -heading
        x = min(max(x + step * math.cos(heading), 0.0), float(width))
        y = min(max(y + step * math.sin(heading), 0.0), float(height))
        pts.append((x, y))
    return [tuple(float(v) for v in np.asarray(p, np.float32)) for p in pts]


def apply(d) -> None:
    """The pointer event of the driver's step `d.i`: start, move or end the
    brush stroke `d.i // events`, in the mode and with the op its place in
    the cycle gives."""
    from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset

    b = d.traffic["brush"]
    n = int(b["events"])
    k, e = divmod(d.i, n)
    s = d.session
    st = d.stroke
    if st is None or st["k"] != k:
        op, mode = b["cycle"][k % len(b["cycle"])]
        st = d.begin_stroke({"k": k, "op": op, "texture": mode == "texture", "yaw": d.yaw,
                             "pts": [], "done": False,
                             "plan": stroke_points(d.traffic, d.seed, k, d.config["width"],
                                                   d.config["height"])})
        s.toolset.set_use_texture(st["texture"])
        s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp(op), st["plan"][e])
    else:
        s.toolset.update_pos(st["plan"][e])
    st["pts"].append(st["plan"][e])
    if e == n - 1:
        d.mark_release()
        s.end_selection_gesture()
        st["done"] = True
    d.took_effect(st)


def _geometry(R, yaw: float, mask):
    """The reference's degree-0 preprocess of the model at the orbit yaw,
    gated by the mask: the centres and the flags the queries read."""
    from gsref.ops.preprocess import preprocess

    m = R.models[0]
    cam = ref.camera_at(R.config, yaw)
    return preprocess(m.pod, R.comp, cam.view(), cam.projection(R.cfg.width / R.cfg.height),
                      m.transform.matrix(), R.cfg.width, R.cfg.height, sh_degree=0,
                      display_mode=R.mode, mask_bits=mask, edit=m.edit, dtype=R.dtype)


def selection_bits(R, sel: dict, mask_then):
    """The reference's selection bits after the strokes of `sel` (the
    strokes since the last SET that took effect, each with the points the
    port was sent), gated by the mask as it stood then."""
    from gsref.query import brush as gb

    r = sel["radius"]
    bits = torch.zeros(R.models[0].count, dtype=torch.uint8, device=R.device)
    for st in sel["strokes"]:
        if not st["pts"] or (st["texture"] and not st["done"]):
            continue
        pre = _geometry(R, st["yaw"], mask_then)
        segs = list(zip(st["pts"][:1] + st["pts"][:-1], st["pts"]))
        if st["texture"]:
            tex = gb.blank_texture(R.cfg.width, R.cfg.height, R.device)
            for a, b in segs:
                gb.paint_segment(tex, a, b, r)
            bits = gb.combine_selection(bits, gb.sample_texture_at_centers(pre, tex), st["op"])
        else:
            for j, (a, b) in enumerate(segs):
                op = "add" if j and st["op"] == "set" else st["op"]
                bits = gb.combine_selection(bits, gb.select_brush_segment(pre, a, b, r), op)
        del pre
    return bits
