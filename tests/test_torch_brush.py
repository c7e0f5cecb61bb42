"""The app's brush selection against the benchmark's plain brush reference
(`portbench/gsref/query/brush.py`, replayed by `portbench/gestures/
brush.py`), on the CPU: the port's `GaussianSplattingSession` at 20k
seeded splats and 160x120 runs one cycle of the benchmark's four strokes
(SET, ADD, REMOVE in texture mode, ADD in immediate mode) through its
`QueryToolset` and `end_selection_gesture`, each stroke at a camera of its
own. After each stroke its selection bits are the reference's replay of
the strokes, bit for bit; its frame in mid-stroke, before the overlays, is
the reference's frame with the same gates within the benchmark cell's
limits; and the overlays drawn over it (the texture's tint in texture
mode, the cursor ring) are `gsref`'s, bit for bit. Imports no JAX."""

import copy
import io
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from gsref.ops.overlay import draw_overlays  # noqa: E402
from gsref.query import brush as gb  # noqa: E402
from harness import check, drive, reference, scene, spec  # noqa: E402

from wgpu_3dgs_viewer_app_tpu_torch.app import (Action, GaussianSplattingSession,  # noqa: E402
                                                SelectionEdit, SelectionMethod)
from wgpu_3dgs_viewer_app_tpu_torch.data import Gaussians, write_ply  # noqa: E402
from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset  # noqa: E402

# A seed whose REMOVE and immediate ADD strokes cross the strokes before them.
W, H, SPLATS, SEED = 160, 120, 20_000, 2**31 + 811
YAW0 = 0.7
# The cell's stroke scaled to a 120-row view: radius 40 and 8-24 px steps
# at 1080 rows are ~4.4 and ~1-3 px here.
BRUSH = {"radius": 5, "events": 12, "step_px": [2, 6]}


def _cell():
    config = spec.load_json(BENCH / "configs" / "select2m.json")
    config.update(width=W, height=H)
    config["scene"] = copy.deepcopy(config["scene"])
    config["scene"]["models"][0]["splats"] = SPLATS
    traffic = spec.load_json(BENCH / "traffic" / "brush.json")
    traffic["brush"] = {**traffic["brush"], **BRUSH}
    limits = spec.load_json(BENCH / "limits" / "select2m.brush.json")
    return config, traffic, limits


def _session(config, traffic, arrays):
    s = GaussianSplattingSession(width=W, height=H, compressions=drive.port_compressions(config),
                                 device="cpu", tile=config["tile"], max_dup=config["max_dup"])
    s.gaussian_transform = drive.port_gaussian_transform(config)
    buf = io.BytesIO()
    write_ply(buf, Gaussians(**arrays))
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    s.evaluate_mask(None)                      # no mask: every bit set
    s.action = Action.SELECTION
    s.selection.method = SelectionMethod.BRUSH
    s.selection.brush_radius = BRUSH["radius"]
    s.toolset.update_brush_radius(BRUSH["radius"])
    s.selection.edit = SelectionEdit(hsv=tuple(traffic["selection_edit"]["hsv"]),
                                     alpha=traffic["selection_edit"]["alpha"])
    return s


@pytest.fixture(scope="module")
def cycle():
    """One cycle of the four strokes through the session; per stroke: the
    bits after it, the strokes replayed for them, and its mid-stroke frame
    (before and after the overlays) with the inputs that made it."""
    config, traffic, limits = _cell()
    arrays = scene.make_models(config, SEED, "cpu")[0]
    s = _session(config, traffic, arrays)
    key = next(iter(s.viewer.models))
    plain = {}
    render = s.render_overlays

    def keep_plain(img):
        plain["img"] = img
        return render(img)
    s.render_overlays = keep_plain
    strokes, out = [], []
    step = math.radians(traffic["yaw_step_deg"])
    for k, (op, mode) in enumerate(traffic["brush"]["cycle"]):
        yaw = YAW0 + k * BRUSH["events"] * step
        cam = reference.camera_at(config, yaw)
        s.camera.control.target = np.asarray(cam.target, np.float32)
        s.camera.control.pos = np.asarray(cam.pos, np.float32)
        st = {"op": op, "texture": mode == "texture", "yaw": yaw, "done": False, "pts": []}
        strokes.append(st)
        pts = spec.load("gestures", "brush").stroke_points(traffic, SEED, k, W, H)
        mid = len(pts) // 2
        for e, p in enumerate(pts):
            if e == 0:
                s.toolset.set_use_texture(st["texture"])
                s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp(op), p)
            else:
                s.toolset.update_pos(p)
            st["pts"].append(p)
            if e == len(pts) - 1:
                s.end_selection_gesture()
                st["done"] = True
            elif e == mid:
                img = s.update()
                frame = {"plain": plain["img"], "img": img, "yaw": yaw, "cursor": p,
                         "selection": _snapshot(strokes)}
            else:
                s.apply_selection_queries()   # what update() does with the event's pods
        out.append({"bits": s.viewer.models[key].buffers.selection.clone(),
                    "selection": _snapshot(strokes), "frame": frame})
    R = reference.Reference(config, [arrays], "cpu")
    return {"config": config, "traffic": traffic, "limits": limits, "R": R, "strokes": out}


def _snapshot(strokes) -> dict:
    return {"gesture": "brush", "radius": float(BRUSH["radius"]), "shapes": [],
            "strokes": [dict(st, pts=list(st["pts"])) for st in strokes]}


@pytest.mark.parametrize("k,kind", enumerate(["set_texture", "add_texture", "remove_texture",
                                              "add_immediate"]))
def test_brush_stroke_matches_the_reference(cycle, k, kind):
    R, traffic, limits = cycle["R"], cycle["traffic"], cycle["limits"]
    got = cycle["strokes"][k]
    mask = R.mask_bits(traffic["mask"]["op"], [])
    assert int(mask.sum()) == SPLATS
    want = check.selection_bits(R, traffic["mask"]["op"], got["selection"])
    assert torch.equal(got["bits"], want), int((got["bits"] != want).sum())
    assert 0 < int(want.sum()) < SPLATS
    if k:   # each stroke moves the selection its op's way
        prev = cycle["strokes"][k - 1]["bits"]
        grown, shrunk = bool((want > prev).any()), bool((want < prev).any())
        assert (grown, shrunk) == ((False, True) if kind.startswith("remove") else (True, False))

    f = got["frame"]
    gates = check.session_gates(R, traffic, {"shapes": [], "selection": f["selection"]})
    ref_img = R.frame(reference.camera_at(cycle["config"], f["yaw"]), gates=[gates])
    _, tail, mean, wide = check.image_gaps(f["plain"], ref_img)
    ok, rows = check.verdict({"img_gap_p9999": tail, "img_mean_abs": mean,
                              "img_gaps_over_0.1": wide},
                             {n: limits[n] for n in ("img_gap_p9999", "img_mean_abs",
                                                     "img_gaps_over_0.1")})
    assert ok, rows

    cur = f["selection"]["strokes"][-1]
    texture = None
    if cur["texture"]:
        texture = gb.blank_texture(W, H, "cpu")
        for a, b in zip(cur["pts"][:1] + cur["pts"][:-1], cur["pts"]):
            gb.paint_segment(texture, a, b, BRUSH["radius"])
        assert texture.any()
    want_img = draw_overlays(f["plain"], None, texture, (f["cursor"], float(BRUSH["radius"])))
    assert torch.equal(f["img"], want_img)
    assert not torch.equal(f["img"], f["plain"])

