"""The brush cell `select2m.brush` on the CPU at a toy size (4k splats,
64x64, strokes of 4 events of radius 4 px): a dry run of its entry against
the spied port, a sound run that comes out correct, and faults planted in
the port's brush that must each come out not correct (one event of every
stroke left unpainted, REMOVE applied as ADD, the resolve run at the
previous stroke's camera); and the import guard over the new reference
file. Every frame of a toy window is kept and judged, so the warm-up's
whole cycle of strokes, which the window's first frames still show, is
judged in every run."""

import ast

import pytest

import _portbench_toy as toy
import test_portbench_dryrun as dryrun
import test_portbench_imports as imports
from harness import drive, scene

BRUSH = {"radius": 4, "events": 4, "step_px": [2, 6]}


def _cell(**traffic):
    cell = toy.toy_cell("select2m.brush", splats=4000, size=64, warm_steps=16, **traffic)
    cell.traffic["brush"] = {**cell.traffic["brush"], **BRUSH}
    return cell


def test_traffic_drives_the_session_stroke_by_stroke(monkeypatch):
    """Eight frames: one `update()` each, `end_selection_gesture` on the
    last event of each stroke, a release time for each, and the strokes
    since the last SET that took effect, each with the points it was sent."""
    cell = _cell()
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    spy = dryrun.Spy(monkeypatch)
    d = drive.make(cell, models, toy.SEED, "cpu", trace=True)
    assert "evaluate_mask" not in vars(d.session)   # the session entry's syncing wrapper
    d.warm(16)
    spy.calls.clear()
    for i in range(8):
        d.step(i)
    c = spy.calls
    assert c.count("GaussianSplattingSession.update") == 8
    assert c.count("GaussianSplattingSession.end_selection_gesture") == 2
    assert c.count("MultiModelViewer.render") == 8 and len(d.gesture_ms) == 2
    sel = d.final_bits()["selection_in"]
    assert [(s["op"], s["texture"], s["done"], len(s["pts"])) for s in sel["strokes"]] == [
        ("set", True, True, 4), ("add", True, True, 4)]
    assert sel["strokes"][1]["yaw"] - sel["strokes"][0]["yaw"] == pytest.approx(d.step_rad * 4)
    assert len(d.kept()) == 5 and all("img" in s and s["shapes"] == [] for s in d.kept())
    assert d.info["k4_cov3d"] == "half" and d.info["k4_masked"]
    d.close()


def _run(**traffic):
    return toy.run_toy(_cell(sample_frames=64, **traffic), seconds=0.6)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["sel_bits_differ"]["value"] == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def _unpainted_event(monkeypatch):
    from wgpu_3dgs_viewer_app_tpu_torch.query import selection

    paint = selection._paint_segment
    calls = [0]

    def skip_last(tex, a, b, radius):
        calls[0] += 1               # one paint an event; every fourth ends a stroke
        return tex if calls[0] % BRUSH["events"] == 0 else paint(tex, a, b, radius)
    monkeypatch.setattr(selection, "_paint_segment", skip_last)


def _remove_as_add(monkeypatch):
    from wgpu_3dgs_viewer_app_tpu_torch.app import state
    from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp

    combine = state.combine_selection

    def as_add(old, new, op):
        return combine(old, new, QuerySelectionOp.ADD if op == QuerySelectionOp.REMOVE else op)
    monkeypatch.setattr(state, "combine_selection", as_add)


def _stale_resolve_camera(monkeypatch):
    from wgpu_3dgs_viewer_app_tpu_torch.app import state

    end = state.GaussianSplattingSession.end_selection_gesture
    last = {}

    def stale(self):
        ctl = self.camera.control
        now = (ctl.target.copy(), ctl.pos.copy())
        if "pose" in last:
            ctl.target, ctl.pos = last["pose"]
        try:
            end(self)
        finally:
            ctl.target, ctl.pos = now
            last["pose"] = now
    monkeypatch.setattr(state.GaussianSplattingSession, "end_selection_gesture", stale)


FAULTS = {"event_unpainted": _unpainted_event, "remove_as_add": _remove_as_add,
          "resolve_at_previous_camera": _stale_resolve_camera}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_reference_brush_imports_nothing_of_the_port():
    path = imports.HERE / "gsref" / "query" / "brush.py"
    assert path in sorted((imports.HERE / "gsref").rglob("*.py"))   # under the guard's glob
    assert not imports._imports(path) & {"wgpu_3dgs_viewer_app_tpu_torch", *imports.FORBIDDEN}
    sets = {ast.unparse(n.targets[0]): ast.unparse(n.value)
            for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.Assign)}
    assert sets["torch.backends.cuda.matmul.allow_tf32"] == "False"
