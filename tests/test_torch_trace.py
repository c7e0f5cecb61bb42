"""The port's spans and counters (`utils/trace.py`), on the CPU: with
tracing off a viewer frame and a session frame record nothing, allocate
nothing in the tracing module and give the image they give with it on, bit
for bit; under torch.profiler each span of a session frame is a profiler
event of the same name, nested as the records are; self time, the cap on
records, the frame ids on two threads, the host-read spans and the
served frame's stages; `ops.kernels.LAUNCHES` is the module's launch
counter; K3's handed-on counter and the benchmark's reader of it; the
query spans of a brush event, its release and an immediate-mode frame, and
the benchmark's readers of them and of K4's roofline. Imports no JAX."""

import importlib.util
import io
import threading
import tracemalloc
from pathlib import Path

import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu_torch.app import (Action, GaussianSplattingSession, SceneCommand,
                                                SceneCommandKind, SelectionMethod, ViewerServer)
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.mask import MaskShape
from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset
from wgpu_3dgs_viewer_app_tpu_torch.utils import trace
from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

W, H = 64, 48
SESSION_SPANS = ["session.update", "session.drain", "session.evaluate_mask", "mask.upload",
                 "session.queries", "viewer.render", "viewer.prologue", "k1.frontend",
                 "k2.sort", "k3.composite", "k3.composite", "session.overlays",
                 "overlays.segments", "k9.overlay"]


def _scene(n=1500, seed=1):
    return make_random_scene(n, seed=seed, extent=1.0, scale_range=(0.01, 0.04))


@pytest.fixture(scope="module")
def session():
    buf = io.BytesIO()
    write_ply(buf, _scene())
    s = GaussianSplattingSession(width=W, height=H, device="cpu")
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    s.mask.add_shape(MaskShape())
    s.mask.op_code = "0"
    s.update()
    return s


def _evaluate(s):
    s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=s.mask.parse_op()))


def _allocated_in_trace(fn):
    """fn() -> (its result, bytes still allocated by lines of utils/trace.py)."""
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        out = fn()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    diff = after.filter_traces(only).compare_to(before.filter_traces(only), "filename")
    return out, sum(d.size_diff for d in diff if d.size_diff > 0)


def test_off_records_nothing_and_renders_the_same(session):
    v = Viewer(_scene(seed=2), W, H, device="cpu")
    cam = session.camera.control
    trace.reset()
    v.render(cam)   # warm
    img_off, grown = _allocated_in_trace(lambda: v.render(cam))
    assert grown == 0 and trace.records == [] and not torch.autograd._profiler_enabled()
    with trace.collect():
        img_on = v.render(cam)
    # K3's span twice: the compositor, then the blend over the background.
    assert [r.name for r in trace.records] == ["viewer.render", "viewer.prologue",
                                               "k1.frontend", "k2.sort", "k3.composite",
                                               "k3.composite"]
    assert torch.equal(img_off, img_on)

    trace.reset()
    _evaluate(session)
    sess_off, grown = _allocated_in_trace(session.update)
    assert grown == 0 and trace.records == []
    _evaluate(session)
    with trace.collect():
        sess_on = session.update()
    # A CPU frame waits for no device: no `host.read`.
    assert [r.name for r in trace.records] == SESSION_SPANS
    assert torch.equal(sess_off, sess_on)


def test_spans_are_profiler_events_nested_as_recorded(session):
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    _evaluate(session)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.update()
    recs = list(trace.records)
    assert [r.name for r in recs] == SESSION_SPANS
    assert trace.frame_roots(recs) == [0]
    assert all(r.frame == 0 for r in recs) and recs[0].parent is None
    names = set(SESSION_SPANS)
    by_name: dict = {}
    for e in sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start):
        by_name.setdefault(e.name, []).append(e)
    # The k-th record of a name is the k-th event of that name (a name that
    # repeats in the frame, K3's, repeats in turn, never nested).
    seen: dict = {}
    ev = []
    for r in recs:
        k = seen[r.name] = seen.get(r.name, -1) + 1
        ev.append(by_name[r.name][k])
    assert sum(map(len, by_name.values())) == len(recs)
    for i, r in enumerate(recs[1:], 1):
        up = ev[i].cpu_parent
        while up is not None and up.name not in names:
            up = up.cpu_parent
        assert up is not None and up.name == recs[r.parent].name, r
        assert up.time_range.start == ev[r.parent].time_range.start, r


def test_self_time_of_a_hand_built_tree():
    R = trace.Record
    recs = [R("viewer.render", 0, 100),
            R("k2.sort", 10, 60, parent=0, frame=0),
            R("host.read", 20, 30, parent=1, frame=0),
            R("host.read", 25, 40, parent=1, frame=0),   # overlaps the one before
            R("host.read", 55, 70, parent=1, frame=0),   # runs past its parent's end
            R("k3.composite", 70, 90, parent=0, frame=0),
            R("viewer.render", 200, 210)]
    assert trace.self_ns(recs) == [100 - 50 - 20, 50 - 20 - 5, 10, 15, 15, 20, 10]
    assert trace.frame_roots(recs) == [0, 6]
    assert trace.frame_ms(0, recs) == pytest.approx(
        {"viewer.render": 1e-4, "k2.sort": 5e-5, "host.read": 4e-5, "k3.composite": 2e-5})


def test_cap_counts_dropped_spans(monkeypatch):
    trace.reset()
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.collect():
        with trace.span("viewer.render") as i:
            with trace.span("k2.sort"):
                with trace.host_read():
                    pass
            with trace.span("k3.composite") as j:
                pass
        with trace.span("viewer.render"):
            pass
    assert i == 0 and j is None
    assert [r.name for r in trace.records] == ["viewer.render", "k2.sort", "host.read"]
    assert trace.dropped == 2
    trace.reset()
    assert trace.records == [] and trace.dropped == 0


def test_host_read_spans_only_while_on_and_on_a_card():
    """A host read records a `host.read` span only while spans record and
    only on a card's path (`cuda`); off, it is the shared null context."""
    trace.reset()
    with trace.host_read() as i:
        pass
    assert i is None and trace.records == [] and trace.host_read() is trace.host_read(False)
    with trace.collect():
        with trace.host_read(cuda=False) as j:
            pass
        with trace.host_read() as k:
            pass
    assert j is None and k == 0
    assert [r.name for r in trace.records] == ["host.read"]


def test_frames_on_two_threads_keep_their_own_roots():
    trace.reset()
    go = threading.Barrier(2, timeout=30)

    def frame(name):
        with trace.span(name):
            go.wait()
            with trace.span("k2.sort"):
                go.wait()

    with trace.collect():
        ts = [threading.Thread(target=frame, args=(n,)) for n in ("viewer.render", "server.frame")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    recs = trace.records
    roots = trace.frame_roots(recs)
    assert sorted(recs[i].name for i in roots) == ["server.frame", "viewer.render"]
    for r in recs:
        if r.name == "k2.sort":
            assert r.parent == r.frame and r.parent in roots
    assert {recs[r.frame].name for r in recs if r.name == "k2.sort"} == {"viewer.render",
                                                                      "server.frame"}


def test_served_frame_stages_come_from_its_spans(session):
    vs = ViewerServer(session)
    vs.frame_jpeg(85)
    assert vs.frame_ms == {}
    vs.handle_event({"type": "orbit", "dx": 5.0, "dy": 0.0})
    trace.reset()
    with trace.collect():
        vs.frame_jpeg(85)
    root = trace.frame_roots(trace.records)
    assert [trace.records[i].name for i in root] == ["server.frame"]
    names = [r.name for r in trace.records]
    assert names[:2] == ["server.frame", "server.update"] and "session.update" in names
    assert names[-4:] == ["jpeg.device", "jpeg.device", "jpeg.copy", "jpeg.entropy"]
    ms = trace.frame_ms(root[0])
    assert vs.frame_ms == {"update": ms["server.update"], "device": ms["jpeg.device"],
                           "copy": ms["jpeg.copy"], "host": ms["jpeg.entropy"]}


def test_launches_is_the_trace_launch_counter():
    assert kernels.LAUNCHES is trace.launches
    kernels.LAUNCHES["sort"] += 3
    assert trace.launches["sort"] >= 3
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES.values()) == {0} and kernels.LAUNCHES is trace.launches


def _benchmark_reader(name: str):
    """The benchmark's reader of the per-layer metric `name`."""
    path = Path(__file__).resolve().parents[1] / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_k3_handed_counter_and_its_reader(monkeypatch):
    """K3's handed-on counter, here added into by hand on the CPU as the
    card's first pass adds into it: no buffer while spans are off, one a
    device while they record, read as (tiles, chunks) and dropped by
    `reset`. Its reader, `k3_composite.resumed_tiles`, gives tiles a frame
    over the recorded frames, and None without frames, without the counter
    (a frame with no K3) or without `k3_resumed` (a port that lacks it)."""
    read = _benchmark_reader("k3_composite.resumed_tiles")
    trace.reset()
    assert trace.k3_handed("cpu") is None and trace.k3_resumed() is None
    assert read({}) is None
    with trace.collect():
        for _ in range(4):
            with trace.span("viewer.render"):
                buf = trace.k3_handed("cpu")
                buf += torch.tensor([3, 17])
        assert trace.k3_handed(torch.device("cpu")) is buf
        assert buf.dtype == torch.int64 and buf.shape == (2,)
    assert trace.k3_handed("cpu") is None
    assert trace.k3_resumed() == (12, 68)
    assert read({}) == 3.0
    monkeypatch.delattr(trace, "k3_resumed")
    assert read({}) is None
    monkeypatch.undo()
    trace.reset()
    assert trace.k3_resumed() is None and read({}) is None
    with trace.collect():
        with trace.span("viewer.render"):
            pass
    assert read({}) is None
    trace.reset()


def _brush_session():
    buf = io.BytesIO()
    write_ply(buf, _scene())
    s = GaussianSplattingSession(width=W, height=H, device="cpu")
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    s.action = Action.SELECTION
    s.selection.method = SelectionMethod.BRUSH
    s.toolset.update_brush_radius(6.0)
    return s


def test_query_spans_of_brush_events_and_releases():
    """A texture-mode pointer event records `query.paint` (a root: the app
    sends its events between frames); its release records `query.resolve`
    with `query.geometry` (the camera and K4's wrapper) inside it; an
    immediate-mode event's frame records `query.geometry` and then
    `query.region` under `session.queries`."""
    s = _brush_session()
    c = (W / 2, H / 2)
    trace.reset()
    with trace.collect():
        s.toolset.set_use_texture(True)
        s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp.SET, c)
        s.toolset.update_pos((c[0] + 6, c[1] + 2))
    assert [(r.name, r.parent) for r in trace.records] == [("query.paint", None)] * 2
    trace.reset()
    with trace.collect():
        s.end_selection_gesture()
    assert [(r.name, r.parent) for r in trace.records] == [("query.resolve", None),
                                                            ("query.geometry", 0)]
    assert int(s.viewer.models["m.ply"].buffers.selection.sum()) > 0
    s.toolset.set_use_texture(False)
    s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp.ADD, c)
    trace.reset()
    with trace.collect():
        s.update()
    recs = trace.records
    q = [r.name for r in recs].index("session.queries")
    assert [(r.name, r.parent) for r in recs[q + 1:q + 3]] == [("query.geometry", q),
                                                                ("query.region", q)]
    assert recs[q].parent == 0 and recs[0].name == "session.update"
    s.end_selection_gesture()
    trace.reset()


def test_query_readers_on_hand_built_records(monkeypatch):
    """`query.paint_ms` (ms a frame of `query.paint`), `query.resolve_ms`
    (ms a release: the `query.resolve` spans over their count) and
    `k4_geometry.roofline_pct` (the work of the counted K4 launches,
    `portbench/metrics/_k4_work.py`, against the stage's device time), and
    None where what they read is missing."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "portbench"))
    paint, resolve = _benchmark_reader("query.paint_ms"), _benchmark_reader("query.resolve_ms")
    R, MS = trace.Record, 1_000_000
    recs = []
    for k in range(4):      # four frames, each after two painted events
        t0 = 20 * k * MS
        recs += [R("query.paint", t0, t0 + MS // 4), R("query.paint", t0 + MS, t0 + 5 * MS // 4)]
        if k in (1, 3):     # two releases, 1 and 2 ms
            recs += [R("query.resolve", t0 + 2 * MS, t0 + (2 + k // 2 + 1) * MS),
                     R("query.geometry", t0 + 2 * MS, t0 + 3 * MS)]
            recs[-1].parent = len(recs) - 2
        recs.append(R("session.update", t0 + 5 * MS, t0 + 15 * MS))
        recs[-1].frame = len(recs) - 1
    monkeypatch.setattr(trace, "records", recs)
    assert paint({}) == pytest.approx(0.5)
    assert resolve({}) == pytest.approx(1.5)
    monkeypatch.setattr(trace, "records", [r for r in recs if r.name != "query.resolve"])
    assert resolve({}) is None and paint({}) == pytest.approx(0.5)
    monkeypatch.setattr(trace, "records", [])
    assert paint({}) is None and resolve({}) is None

    roof = _benchmark_reader("k4_geometry.roofline_pct")
    peaks = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}
    ctx = {"trace": {"stage_s": {"k4_geometry": 35 * 40e-6}, "launched": {"geometry": 35}},
           "info": {"splats": 2_000_000, "k4_cov3d": "half", "k4_masked": True},
           "peaks": peaks}
    # 2M splats x (12 + 12 + 4 + 1 read, 9 written) B = 76 MB a launch: 22.69 us of 40.
    assert roof(ctx) == pytest.approx(100 * 76e6 / 3.35e12 / 40e-6)
    single = dict(ctx, info={**ctx["info"], "k4_cov3d": "single", "k4_masked": False})
    assert roof(single) == pytest.approx(100 * 2e6 * 49 / 3.35e12 / 40e-6)
    for bad in ({**ctx, "trace": None}, {**ctx, "info": {}},
                {**ctx, "trace": {**ctx["trace"], "short": {"fused": (1, 2)}}},
                {**ctx, "trace": {"stage_s": {}, "launched": {"geometry": 35}}},
                {**ctx, "trace": {**ctx["trace"], "launched": {"geometry": 0}}}):
        assert roof(bad) is None
