"""A dry run of the harness on the CPU: BENCHMARK.json against the
contract's shape, every cell's files found by name, every traffic mix
driven a few steps at a toy size with the port's entry points spied on,
and every per-layer metric's cells reporting the end-to-end metric it
moves."""

import json
import re

import pytest

import _portbench_toy as toy
from harness import drive, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"frame_ms", "frame_ms_p95", "edit_ms_p95", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_by_name(workload):
    cell = spec.resolve(workload, BENCH)
    assert cell.config["name"] == next(w for w in BENCH["workloads"]
                                       if w["name"] == workload)["config"]
    assert (spec.HERE / "entries" / f"{cell.traffic['entry']}.py").is_file()
    assert issubclass(spec.load("entries", cell.traffic["entry"]).Driver, drive.Driver)
    for g in cell.traffic.get("gestures", []):
        assert callable(spec.load("gestures", g).apply)
    assert cell.limits, "a cell without comparison limits"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "a cell without a per-layer metric"
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for m in cell.end_to_end:
        assert callable(spec.end_to_end_reader(m["name"]))


def test_end_to_end_readers_read_the_window():
    window = {"window_s": 2.0, "steps": 400, "step_ms": [float(i % 10) for i in range(400)],
              "gesture_ms": [20.0] * 16, "setup_s": 12.5}
    got = {m["name"]: spec.end_to_end_reader(m["name"])(window) for m in BENCH["end_to_end"]}
    assert got["setup_s"] == 12.5
    for name, v in got.items():
        assert v is not None and v > 0, name


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            assert spec.reports(e2e[m["moves"]], w), (m["name"], w)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {"front-end K1", "entry sort K2", "compositor K3", "device",
            "app session"} <= set(layers)


class Spy:
    """Records the calls of the port's entry points while they run."""

    def __init__(self, monkeypatch):
        from wgpu_3dgs_viewer_app_tpu_torch.app import GaussianSplattingSession, ViewerServer
        from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer

        self.calls = []
        for cls, name in ((MultiModelViewer, "render"), (GaussianSplattingSession, "update"),
                          (GaussianSplattingSession, "evaluate_mask"),
                          (GaussianSplattingSession, "end_selection_gesture"),
                          (ViewerServer, "frame_jpeg"), (ViewerServer, "handle_event")):
            monkeypatch.setattr(cls, name, self.wrap(f"{cls.__name__}.{name}",
                                                     getattr(cls, name)))

    def wrap(self, tag, fn):
        def spied(*a, **kw):
            self.calls.append(tag)
            return fn(*a, **kw)
        return spied


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]]
                         + ["inria6m.served"])
def test_traffic_drives_its_entry(workload, monkeypatch):
    """A few steps of each mix at 4k splats, 64x64, against the spied port."""
    cell = toy.toy_cell(workload, splats=4000, size=64, gesture_every=2, warm_steps=1)
    from harness import scene

    models = scene.make_models(cell.config, toy.SEED, "cpu")
    spy = Spy(monkeypatch)
    d = drive.make(cell, models, toy.SEED, "cpu", trace=False)
    spy.calls.clear()
    for i in range(4):
        d.step(i)
    entry = cell.traffic["entry"]
    c = spy.calls
    if entry == "viewer":
        assert c == ["MultiModelViewer.render"] * 4
    elif entry == "session":
        assert c.count("GaussianSplattingSession.update") == 4
        assert c.count("GaussianSplattingSession.end_selection_gesture") == 1
        assert c.count("GaussianSplattingSession.evaluate_mask") == 1
        assert d.gesture_ms and len(d.gesture_ms) == 2
    else:
        assert c.count("ViewerServer.handle_event") == 4
        assert c.count("ViewerServer.frame_jpeg") == 4
        assert c.count("GaussianSplattingSession.update") == 4
    assert len(d.samples.items) == min(4, d.samples.k)
    d.close()
