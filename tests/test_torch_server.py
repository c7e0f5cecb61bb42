"""The port's web viewer (`app/server.py`) on the CPU against the JAX
package's: a `ViewerServer` of each package over a session fed the same PLY
bytes (JAX with `use_pallas=False`, the port with `device="cpu"`). Held:
`state_json` equal key for key (all but `fps`, and `parallel`, which the
JAX server fills from any sharded render of the test process) after the
streamed load and after a `handle_set` of every key; the camera's view and
projection within 1e-6 and the frames within the golden gate after the
same events; every command's result; the export bytes. The JAX buffers pad
a model's capacity to whole 128s (TPU lanes) and its state reports that
capacity as the model's count; the port keeps no padding, so the states
are compared on scenes of whole 128s, and one test holds the difference at
400 splats (the port reports 400, JAX 512). Also the port's
ports of the JAX server tests (frame cache, compression switch,
first-person events, export off the lock), one HTTP round trip over every
route, and a fresh frame tensor from every `update()`."""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu import app as japp
from wgpu_3dgs_viewer_app_tpu.app import server as jserver
from wgpu_3dgs_viewer_app_tpu_torch import app
from wgpu_3dgs_viewer_app_tpu_torch.app import server
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraFirstPersonControl
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, read_ply, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.utils import trace

W = H = 96
N = 1536
# View and projection of the two packages' cameras after the same events
# (numpy f32 on both sides, one code path).
CAMERA_TOL = 1e-6
EVENTS = [
    {"type": "orbit", "dx": 30.0, "dy": -12.0},
    {"type": "zoom", "dy": -120.0},
    {"type": "pan", "dx": 7.0, "dy": -4.0},
    {"type": "set_control", "control": "first_person"},
    {"type": "look", "dx": 25.0, "dy": 10.0},
    {"type": "move", "x": 0.5, "z": 1.0, "y": 0.2, "dt": 0.05},
    {"type": "set_control", "control": "orbit", "arm": 1.7},
    {"type": "look", "dx": -15.0, "dy": 6.0},
]


def _ply(n=N, seed=5, extent=1.0):
    g = make_random_scene(n, seed=seed, extent=extent, scale_range=(0.01, 0.05))
    buf = io.BytesIO()
    write_ply(buf, g)
    return buf.getvalue()


def _load(session, name, data):
    session.open_model(name, io.BytesIO(data))
    while session.loader is not None:
        session._drain_loader()


def _pair(*models):
    """A JAX and a port `ViewerServer`, each over a session with `models`
    ((name, PLY bytes)) streamed in."""
    js = japp.GaussianSplattingSession(width=W, height=H, use_pallas=False, tile=16, max_dup=8)
    ts = app.GaussianSplattingSession(width=W, height=H, device="cpu", tile=16, max_dup=8)
    for name, data in models:
        _load(js, name, data)
        _load(ts, name, data)
    return jserver.ViewerServer(js), server.ViewerServer(ts)


def _state(vs):
    st = vs.state_json()
    st.pop("fps")
    return st


def _assert_same_state(jvs, tvs):
    jst, tst = _state(jvs), _state(tvs)
    assert tst.pop("parallel") is None
    jst.pop("parallel")
    assert tst == jst


def _u8(img):
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


SETS = [
    {"gaussian_transform": {"size": 0.8, "display_mode": "ellipse", "sh_deg": 2,
                            "no_sh0": True}},
    {"action": "selection"},
    {"selected_key": "m.ply"},
    {"camera": {"fov_deg": 50.0, "speed": 2.5, "sensitivity": 0.7}},
    {"selection": {"method": "brush", "operation": "add", "immediate": True,
                   "brush_radius": 25, "show_unedited": True,
                   "edit": {"hidden": False, "hsv": [0.2, 1.1, 0.9], "contrast": 0.1,
                            "exposure": 0.2, "gamma": 1.2, "alpha": 0.5}}},
    {"model": {"key": "m.ply", "visible": True,
               "transform": {"pos": [0.1, 0.0, 0.2], "rot": [0.0, 20.0, 5.0],
                             "scale": [1.0, 1.2, 1.0]}}},
    {"compressions": {"sh": "half", "cov3d": "single"}},
    {"theme": "light"},
    {"mask_op_code": "0 | 1"},
    {"mask_shape": {"index": 0, "kind": "ellipsoid", "pos": [0.2, 0.0, 0.0],
                    "rot": [0.0, 30.0, 0.0], "scale": [0.8, 1.0, 0.9], "visible": False}},
    {"measurement": {"hit_method": "closest",
                     "pair": {"index": 0, "visible": False, "label": "door",
                              "color": [0.0, 1.0, 0.0, 1.0], "line_width": 2.0}}},
    {"selection": {"edit": None, "method": "rect", "operation": "set"}},
]


def test_state_counts_unpadded_splats():
    """At 400 splats JAX reports its padded capacity, the port the splats;
    the rest of the state is equal."""
    jvs, tvs = _pair(("m.ply", _ply(400, seed=2)))
    jst, tst = _state(jvs), _state(tvs)
    jm, tm = jst["models"]["m.ply"], tst["models"]["m.ply"]
    assert (tm["count"], tm["loaded"], tst["compressions"]["total_count"]) == (400, 400, 400)
    assert (jm["count"], jm["loaded"], jst["compressions"]["total_count"]) == (512, 400, 512)
    assert tm["compressed_size"] == "31.64 KB" and jm["compressed_size"] == "40.50 KB"
    for st in (jst, tst):
        st.pop("parallel")
        st["compressions"].pop("total_count")
        for k in ("count", "original_size", "compressed_size"):
            st["models"]["m.ply"].pop(k)
    assert tst == jst


def test_state_json_matches_jax():
    """Equal after the streamed load, then after a `handle_set` of each key
    (a mask shape and a measurement pair exist for the keys that edit them)."""
    jvs, tvs = _pair(("m.ply", _ply(384, seed=2)))
    _assert_same_state(jvs, tvs)
    for vs in (jvs, tvs):
        for cmd in ("add_mask_shape", "add_mask_shape", "add_measurement_pair"):
            assert vs.handle_command({"cmd": cmd}) == {"ok": True}
    _assert_same_state(jvs, tvs)
    for body in SETS:
        jvs.handle_set(body)
        tvs.handle_set(body)
        _assert_same_state(jvs, tvs)
    assert tvs.session.compressions.sh.value == "half"


def test_events_move_the_camera_as_jax():
    """The same event sequence: equal camera matrices, frames in the gate."""
    jvs, tvs = _pair(("m.ply", _ply()))
    aspect = W / H
    for ev in EVENTS:
        jvs.handle_event(dict(ev))
        tvs.handle_event(dict(ev))
        jc, tc = jvs.session.camera.control, tvs.session.camera.control
        assert type(tc).__name__ == type(jc).__name__
        np.testing.assert_allclose(tc.view(), jc.view(), rtol=0, atol=CAMERA_TOL)
        np.testing.assert_allclose(tc.projection(aspect), jc.projection(aspect), rtol=0,
                                   atol=CAMERA_TOL)
    assert isinstance(tvs.session.camera.control, server.CameraOrbitControl)
    got = _u8(tvs.session.update())
    ref = _u8(jvs.session.update())
    assert float(got.max()) > 20  # the scene is in view
    assert_golden_close(got.astype(np.int16), ref.astype(np.int16))


def test_commands_match_jax():
    """Every command's result dict (the unknown one's error included) and the
    state after it."""
    jvs, tvs = _pair(("a.ply", _ply(384, seed=3)), ("b.ply", _ply(256, seed=4)))
    for vs in (jvs, tvs):
        vs.handle_set({"mask_op_code": "0"})
        vs.handle_set({"selection": {"edit": {"hsv": [0.1, 1.0, 1.0], "alpha": 0.7}}})
    cmds = [{"cmd": "add_mask_shape"}, {"cmd": "evaluate_mask"}, {"cmd": "reset_mask"},
            {"cmd": "clear_selection"}, {"cmd": "commit_edit"},
            {"cmd": "add_measurement_pair"}, {"cmd": "add_measurement_pair"},
            {"cmd": "remove_measurement_pair", "index": 0},
            {"cmd": "remove_measurement_pair", "index": 7},
            {"cmd": "add_mask_shape"}, {"cmd": "remove_mask_shape", "index": 1},
            {"cmd": "remove_mask_shape"}, {"cmd": "launch_rockets"}, {},
            {"cmd": "remove_model", "key": "a.ply"}]
    for body in cmds:
        got, ref = tvs.handle_command(dict(body)), jvs.handle_command(dict(body))
        assert got == ref, body
        _assert_same_state(jvs, tvs)
    assert tvs.handle_command({"cmd": "launch_rockets"}) == {
        "ok": False, "error": "unknown command 'launch_rockets'"}
    assert list(tvs.session.viewer.models) == ["b.ply"]
    assert tvs.session.selected_key == "b.ply"


@pytest.mark.parametrize("choices", [None, {"a.ply": {"with_edit": False, "with_mask": True},
                                            "b.ply": {"export": False}}])
def test_export_bytes_match_jax(choices):
    jvs, tvs = _pair(("a.ply", _ply(300, seed=3)), ("b.ply", _ply(200, seed=4)))
    for vs in (jvs, tvs):
        mask = np.zeros(300, np.uint8)
        mask[::3] = 1
        vs.session.viewer.models["a.ply"].buffers.set_mask(mask)
    got, ref = tvs.export_bytes(choices), jvs.export_bytes(choices)
    assert got[1:] == ref[1:]
    if choices is None:  # a ZIP: compare its members (timestamps differ)
        import zipfile

        zg, zr = zipfile.ZipFile(io.BytesIO(got[0])), zipfile.ZipFile(io.BytesIO(ref[0]))
        assert zg.namelist() == zr.namelist() == ["a.ply", "b.ply"]
        for name in zg.namelist():
            assert zg.read(name) == zr.read(name)
    else:
        assert got[0] == ref[0]
        assert read_ply(io.BytesIO(got[0])).count == 100


def test_server_export_choices_and_off_lock():
    """Per-model choices select what ships, and serialisation runs outside
    the session lock."""
    import zipfile

    from wgpu_3dgs_viewer_app_tpu_torch.app import export as export_mod

    s = app.GaussianSplattingSession(width=64, height=64, device="cpu")
    for name, n in (("a.ply", 40), ("b.ply", 30)):
        _load(s, name, _ply(n, seed=n, extent=0.5))
    vs = server.ViewerServer(s)
    lock_free_during_write = []
    real_write_ply = export_mod.write_ply

    def probing_write_ply(*a, **kw):
        ok = vs.lock.acquire(blocking=False)
        if ok:
            vs.lock.release()
        lock_free_during_write.append(ok)
        return real_write_ply(*a, **kw)

    export_mod.write_ply = probing_write_ply
    try:
        blob, fname, ctype = vs.export_bytes({"a.ply": {"export": True, "with_edit": False},
                                              "b.ply": {"export": False}})
    finally:
        export_mod.write_ply = real_write_ply
    assert fname == "a.ply" and ctype == "application/octet-stream"
    assert read_ply(io.BytesIO(blob)).count == 40
    assert lock_free_during_write and all(lock_free_during_write)
    blob, fname, _ = vs.export_bytes(None)
    assert fname == "models.zip"
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert set(zf.namelist()) == {"a.ply", "b.ply"}


def _port_session(n, seed=0):
    s = app.GaussianSplattingSession(width=64, height=64, device="cpu")
    s.open_model("m.ply", io.BytesIO(_ply(n, seed=seed, extent=0.5)))
    for _ in range(50):
        s.update()
        if s.loader is None:
            break
    return s


def test_server_state_and_set_compressions():
    s = _port_session(120)
    vs = server.ViewerServer(s)
    st = vs.state_json()
    assert st["compressions"]["sh"] == "norm8"
    fs = st["compressions"]["field_sizes"]
    assert fs["pos"] == 12 and "norm8" in fs["sh"] and "half" in fs["cov3d"]
    assert st["compressions"]["total_count"] >= 120
    vs.handle_set({"compressions": {"sh": "half", "cov3d": "single"}})
    assert s.compressions.sh.value == "half"
    assert s.compressions.cov3d.value == "single"
    with trace.collect():
        blob1 = vs.frame_jpeg(quality=70, scale=0.5)
    assert blob1[:2] == b"\xff\xd8"
    blob2 = vs.frame_jpeg(quality=70, max_age=60.0, scale=0.5)
    assert blob2 == blob1  # served from the cache within max_age
    assert set(vs.frame_ms) == {"update", "device", "copy", "host"}


def test_frame_cache_idle_scene_and_dirty_invalidation():
    """An unchanged scene serves the cached frame; a mutating request
    invalidates it."""
    s = _port_session(60)
    vs = server.ViewerServer(s)
    renders = []
    real_update = s.update
    s.update = lambda: (renders.append(1), real_update())[1]
    b1 = vs.frame_jpeg(quality=70)
    b2 = vs.frame_jpeg(quality=70)  # idle: cached, no render
    assert b2 is b1 and len(renders) == 1
    assert vs.frame_jpeg(quality=60) != b""  # knob change -> re-render
    assert len(renders) == 2
    vs.handle_event({"type": "orbit", "dx": 10.0, "dy": 0.0})
    b3 = vs.frame_jpeg(quality=60)
    assert len(renders) == 3
    vs.frame_jpeg(quality=60)
    assert len(renders) == 3  # idle again
    assert b3 is not b1


def test_first_person_look_and_move_events():
    s = _port_session(50)
    vs = server.ViewerServer(s)
    vs.handle_event({"type": "set_control", "control": "first_person"})
    fp = s.camera.control
    assert isinstance(fp, CameraFirstPersonControl)
    yaw0, pitch0, pos0 = fp.yaw, fp.pitch, np.array(fp.pos)
    vs.handle_event({"type": "look", "dx": 40.0, "dy": -25.0})
    fp = s.camera.control
    assert isinstance(fp, CameraFirstPersonControl)  # stays first person
    assert fp.yaw != yaw0 and fp.pitch != pitch0
    vs.handle_event({"type": "move", "x": 1.0, "z": 0.5, "dt": 0.1})
    assert np.linalg.norm(np.array(s.camera.control.pos) - pos0) > 0
    # In orbit mode a look keeps the position and moves the target.
    vs.handle_event({"type": "set_control", "control": "orbit", "arm": 2.0})
    orb_pos0 = np.array(s.camera.control.pos)
    vs.handle_event({"type": "look", "dx": 30.0, "dy": 0.0})
    assert np.allclose(np.array(s.camera.control.pos), orb_pos0, atol=1e-5)


def test_update_returns_a_fresh_frame():
    """The server encodes outside the lock: a frame must never be written
    again by a later `update()`."""
    s = _port_session(200)
    a = s.update()
    kept = a.clone()
    s.camera.control.orbit_by(0.3, 0.1)
    b = s.update()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)


def test_http_round_trip():
    """Every route over a real socket on an ephemeral port, a 404 and a 500."""
    s = _port_session(150)
    vs = server.ViewerServer(s)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(vs))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None, headers=None):
        data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                     method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type"), e.read()

    try:
        for path, ctype in (("/", "text/html; charset=utf-8"),
                            ("/manifest.json", "application/manifest+json"),
                            ("/sw.js", "text/javascript")):
            code, ct, body = call(path)
            name = "index.html" if path == "/" else path[1:]
            assert (code, ct) == (200, ctype)
            assert body == (server.ASSETS / name).read_bytes()
        code, ct, state = call("/state")
        assert code == 200 and json.loads(state)["models"]["m.ply"]["count"] == 150
        code, ct, frame = call("/frame.jpg?quality=70&scale=0.5")
        assert (code, ct) == (200, "image/jpeg") and frame[:2] == b"\xff\xd8"
        assert call("/frame.jpg?quality=70&scale=0.5&max_age=60")[2] == frame
        assert call("/event", {"type": "orbit", "dx": 5.0, "dy": 0.0})[2] == b'{"ok": true}'
        assert call("/set", {"theme": "light"})[0] == 200 and s.theme == "light"
        assert json.loads(call("/command", {"cmd": "add_mask_shape"})[2]) == {"ok": True}
        assert json.loads(call("/command", {"cmd": "nope"})[2])["ok"] is False
        code, _, body = call("/open", _ply(80, seed=9), {"X-Filename": "up.ply"})
        assert code == 200 and json.loads(body) == {"ok": True}
        while s.loader is not None:
            s._drain_loader()
        assert len(s.viewer.models["up.ply"].buffers) == 80
        code, ct, body = call("/export")
        assert (code, ct) == (200, "application/zip")
        code, ct, body = call("/export", {"choices": {"up.ply": {"with_mask": True},
                                                      "m.ply": {"export": False}}})
        assert (code, ct) == (200, "application/octet-stream")
        assert read_ply(io.BytesIO(body)).count == 80
        assert call("/nope")[0] == 404 and call("/nope", {})[0] == 404
        code, _, body = call("/event", b"{not json")
        assert code == 500 and "error" in json.loads(body)
        assert call("/frame.jpg?quality=abc")[0] == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
