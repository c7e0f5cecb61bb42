"""The interactive web viewer: an HTTP server that streams the session's
frames as JPEG to a browser canvas, with the tab surface (camera,
transform, models, selection, mask, measurement) as a JSON state API
driven by the page in `assets/index.html`.

Counterpart of `wgpu_3dgs_viewer_app_tpu.app.server`, with the same
protocol:
  GET  /            the viewer page
  GET  /frame.jpg   one frame (the client paces the loop); ?quality, ?scale,
                    ?max_age
  GET  /state       the whole UI state as JSON
  POST /event       viewport input {type: orbit|pan|zoom|look|move|
                    set_control|action_*|brush_radius}
  POST /set         state updates from the tab panel
  POST /open        a .ply body (X-Filename header), streamed in
  POST /command     remove_model | evaluate_mask | commit_edit | ...
  GET|POST /export  the PLY (one model) or ZIP (several) with edits and
                    mask applied; POST takes per-model choices

Frames are encoded by `utils.jpeg` (no image library): its integer stages
run on the frame's device, its entropy coder on the host.
"""

from __future__ import annotations

import io
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.camera import CameraOrbitControl, to_first_person, to_orbit
from ..core.transform import GaussianDisplayMode, GaussianShDegree, ModelTransform
from ..data.compression import (COLOR_FIELD_SIZE, COV3D_FIELD_SIZES, POS_FIELD_SIZE,
                                SH_FIELD_SIZES, Compressions, Cov3dCompression,
                                ShCompression)
from ..mask.shapes import MaskShapeKind
from ..query.hit import MeasurementHitMethod
from ..query.pods import QuerySelectionOp
from ..query.selection import QueryToolset
from ..utils import trace
from ..utils.format import human_readable_size
from ..utils.jpeg import encode_frame
from ..utils.log import get_logger
from .export import ExportChoice, serialize_exports, snapshot_exports
from .measurement import MeasurementHitPair
from .state import Action, GaussianSplattingSession, SelectionEdit, SelectionMethod

_LOG = get_logger("server")
# `ViewerServer.frame_ms`'s keys and the spans they are read from.
_FRAME_STAGES = {"update": "server.update", "device": "jpeg.device", "copy": "jpeg.copy",
                 "host": "jpeg.entropy"}
ASSETS = Path(__file__).parent / "assets"


def _sharded_stats() -> dict | None:
    """Routing stats of the latest sharded render, or None when no sharded
    render has run in this process (always so for one device)."""
    mod = sys.modules.get("wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded")
    return None if mod is None else mod.last_stats()


def _compression_field_sizes() -> dict:
    """Bytes of each field under every compression option: the data behind
    the picker's size readout."""
    return {
        "pos": POS_FIELD_SIZE,
        "color": COLOR_FIELD_SIZE,
        "sh": {e.value: SH_FIELD_SIZES[e] for e in ShCompression},
        "cov3d": {e.value: COV3D_FIELD_SIZES[e] for e in Cov3dCompression},
    }


class ViewerServer:
    """Owns the session and its lock; the HTTP handlers call into it."""

    def __init__(self, session: GaussianSplattingSession):
        self.session = session
        self.lock = threading.Lock()
        self._last_frame = None  # (version, quality, scale, jpeg bytes, monotonic time)
        self._frame_gate = threading.Lock()  # one render at a time; /state never waits on it
        # Bumped by every mutating request; an unchanged scene serves the
        # cached frame, so an idle client's polling costs no device time.
        self._scene_version = 0
        # Host-clock ms of the latest rendered frame while spans record
        # (`utils.trace`), else {}: `update` (the lock and `update()`), the
        # encoder's `device` stages, the `copy` of its coefficients to the
        # host and its `host` stage (the entropy coder).
        self.frame_ms: dict = {}

    def mark_dirty(self) -> None:
        """Callers hold self.lock: the bump must order with the mutation it
        describes, or a concurrent render could tag a frame from before the
        mutation with the version after it and the cache would keep it."""
        self._scene_version += 1

    # --- frame ---

    def frame_jpeg(self, quality: int = 85, max_age: float | None = None,
                   scale: float = 1.0) -> bytes:
        """One frame as JPEG. The state lock covers `update()` only: its
        frame is a tensor of its own (never written again), so the encode
        (device stages ordered on the stream, the copy, the host coder) runs
        outside the lock. `update()` itself waits inside the lock for K2's
        live count and for the background's upload (`trace.host_read`), the
        second until the compositor has finished.
        `max_age` (seconds) serves the previous frame while it is that
        fresh; `scale` resizes the encoded image."""
        def cached():
            if self._last_frame is None:
                return None
            ver, q, sc, blob, ts = self._last_frame
            same_cfg = q == quality and sc == scale
            if max_age is not None and same_cfg and time.monotonic() - ts <= max_age:
                return blob
            # Idle scene: no mutation since that frame and no load in flight.
            if same_cfg and ver == self._scene_version and self.session.loader is None:
                return blob
            return None

        blob = cached()
        if blob is not None:
            return blob
        with self._frame_gate:
            # Polls queued on the gate behind a render of this scene take its frame.
            blob = cached()
            if blob is not None:
                return blob
            with trace.span("server.frame") as frame:
                with trace.span("server.update"), self.lock:
                    # The version is read under the lock mutators bump it
                    # under: a mutation either lands in this frame or
                    # invalidates it.
                    ver = self._scene_version
                    img = self.session.update()
                    loading = self.session.loader is not None
                blob = encode_frame(img, quality, scale)
            ms = {} if frame is None else trace.frame_ms(frame)
            self.frame_ms = ({k: ms[name] for k, name in _FRAME_STAGES.items()}
                             if all(name in ms for name in _FRAME_STAGES.values()) else {})
            # A load in flight drains inside update(), not through a
            # mutating request: such a frame is stale at once.
            self._last_frame = (ver if not loading else ver - 1, quality, scale, blob,
                                time.monotonic())
            return blob

    # --- input events ---

    def handle_event(self, ev: dict) -> None:
        with self.lock:
            self.mark_dirty()
            s = self.session
            cam = s.camera
            t = ev.get("type")
            sens = cam.sensitivity * 0.005
            if t == "orbit" and isinstance(cam.control, CameraOrbitControl):
                cam.control.orbit_by(-ev["dx"] * sens, ev["dy"] * sens)
            elif t == "zoom" and isinstance(cam.control, CameraOrbitControl):
                cam.control.zoom_by(math.pow(1.0015, ev["dy"]))
            elif t == "pan" and isinstance(cam.control, CameraOrbitControl):
                # World units per pixel at the target's depth.
                c = cam.control
                d = float(np.linalg.norm(c.arm()))
                per_px = 2.0 * d * math.tan(c.vertical_fov / 2) / s.viewer.cfg.height
                view = c.view()
                c.pan_by((-ev["dx"] * view[0, :3] + ev["dy"] * view[1, :3]) * per_px)
            elif t == "look":
                fp = to_first_person(cam.control)
                fp.yaw_by(-ev["dx"] * sens)
                fp.pitch_by(-ev["dy"] * sens)
                if isinstance(cam.control, CameraOrbitControl):
                    cam.control = to_orbit(fp, float(np.linalg.norm(cam.control.arm())))
                else:
                    cam.control = fp
            elif t == "move":
                fp = to_first_person(cam.control)
                up = np.array([0, 1, 0], np.float32)
                v = (fp.get_forward() * ev.get("z", 0) + fp.get_right() * ev.get("x", 0)
                     + up * ev.get("y", 0)) * cam.speed * ev.get("dt", 0.016)
                if isinstance(cam.control, CameraOrbitControl):
                    cam.control.pan_by(v)
                else:
                    cam.control.pos = cam.control.pos + v
            elif t == "set_control":
                if ev["control"] == "first_person":
                    cam.control = to_first_person(cam.control)
                else:
                    cam.control = to_orbit(cam.control, ev.get("arm", 1.0))
            elif t == "action_start":
                self._action_start(ev)
            elif t == "action_move":
                s.toolset.update_pos((ev["x"], ev["y"]))
            elif t == "action_end":
                if s.action == Action.SELECTION:
                    s.end_selection_gesture()
                elif s.action == Action.MEASUREMENT_LOCATE_HIT:
                    s.locate_hit((ev["x"], ev["y"]), ev.get("pair", 0), ev.get("hit", 0))
            elif t == "brush_radius":
                s.selection.brush_radius = max(1, int(s.selection.brush_radius + ev["delta"]))
                s.toolset.update_brush_radius(s.selection.brush_radius)

    def _action_start(self, ev: dict) -> None:
        s = self.session
        if s.action != Action.SELECTION:
            return
        # Modifiers: Shift adds, Ctrl removes.
        op = s.selection.operation
        if ev.get("shift"):
            op = QuerySelectionOp.ADD
        elif ev.get("ctrl"):
            op = QuerySelectionOp.REMOVE
        tool = (QueryToolset.BRUSH if s.selection.method == SelectionMethod.BRUSH
                else QueryToolset.RECT)
        s.toolset.set_use_texture(not s.selection.immediate)
        s.toolset.update_brush_radius(s.selection.brush_radius)
        s.toolset.start(tool, op, (ev["x"], ev["y"]))

    # --- state JSON (the tab surface) ---

    def state_json(self) -> dict:
        with self.lock:
            s = self.session
            cam = s.camera
            ctrl = cam.control
            models = {}
            for k, m in s.viewer.models.items():
                count = m.buffers.capacity
                models[k] = {
                    "visible": m.visible,
                    "count": count,
                    "loaded": len(m.buffers),
                    "transform": {
                        "pos": m.transform.pos.tolist(),
                        "rot": m.transform.rot.tolist(),
                        "scale": m.transform.scale.tolist(),
                    },
                    "original_size": human_readable_size(count * 248),
                    "compressed_size": human_readable_size(s.compressions.compressed_size(count)),
                }
            gt = s.gaussian_transform
            sel = s.selection
            edit = sel.edit
            return {
                "fps": round(s.fps.fps, 1),
                "theme": s.theme,
                "loading": None if s.loader is None else {
                    "key": s.loader[0],
                    "received": s.loader[1].received,
                    "count": s.loader[1].count,
                },
                "camera": {
                    "control": "orbit" if isinstance(ctrl, CameraOrbitControl) else "first_person",
                    "pos": np.asarray(ctrl.pos).tolist(),
                    "fov_deg": math.degrees(ctrl.vertical_fov),
                    "speed": cam.speed,
                    "sensitivity": cam.sensitivity,
                },
                "models": models,
                "selected_key": s.selected_key,
                "gaussian_transform": {
                    "size": gt.size,
                    "display_mode": gt.display_mode.name.lower(),
                    "sh_deg": gt.sh_deg.degree,
                    "no_sh0": gt.no_sh0,
                },
                "action": s.action.value,
                "selection": {
                    "method": sel.method.value,
                    "operation": sel.operation.value,
                    "immediate": sel.immediate,
                    "brush_radius": sel.brush_radius,
                    "highlight_color": list(sel.highlight_color),
                    "show_unedited": sel.show_unedited,
                    "edit": None if edit is None else {
                        "hidden": edit.hidden,
                        "hsv": list(edit.hsv) if edit.hsv else None,
                        "override_rgb": list(edit.override_rgb) if edit.override_rgb else None,
                        "contrast": edit.contrast,
                        "exposure": edit.exposure,
                        "gamma": edit.gamma,
                        "alpha": edit.alpha,
                    },
                },
                "mask": {
                    "op_code": s.mask.op_code,
                    "shapes": [{"kind": sh.kind.value, "pos": sh.pos.tolist(),
                                "rot": sh.rot.tolist(), "scale": sh.scale.tolist(),
                                "visible": sh.visible} for sh in s.mask.shapes],
                },
                "measurement": {
                    "hit_method": s.measurement.hit_method.value,
                    "pairs": [{"label": p.label, "visible": p.visible, "color": list(p.color),
                               "line_width": p.line_width,
                               "hits": [h.pos.tolist() for h in p.hits],
                               "distance": p.distance()} for p in s.measurement.hit_pairs],
                },
                "parallel": _sharded_stats(),
                "compressions": {
                    "sh": s.compressions.sh.value,
                    "cov3d": s.compressions.cov3d.value,
                    "field_sizes": _compression_field_sizes(),
                    "total_count": sum(m.buffers.capacity for m in s.viewer.models.values()),
                },
            }

    def handle_set(self, body: dict) -> None:
        with self.lock:
            self.mark_dirty()
            s = self.session
            for key, v in body.items():
                if key == "gaussian_transform":
                    gt = s.gaussian_transform
                    gt.size = float(v.get("size", gt.size))
                    if "display_mode" in v:
                        gt.display_mode = GaussianDisplayMode[v["display_mode"].upper()]
                    if "sh_deg" in v:
                        gt.sh_deg = GaussianShDegree(int(v["sh_deg"]))
                    gt.no_sh0 = bool(v.get("no_sh0", gt.no_sh0))
                elif key == "action":
                    s.action = Action(v)
                elif key == "selected_key":
                    s.selected_key = v
                elif key == "camera":
                    if "fov_deg" in v:
                        s.camera.control.vertical_fov = math.radians(float(v["fov_deg"]))
                    s.camera.speed = float(v.get("speed", s.camera.speed))
                    s.camera.sensitivity = float(v.get("sensitivity", s.camera.sensitivity))
                elif key == "selection":
                    self._set_selection(v)
                elif key == "model":
                    m = s.viewer.models.get(v["key"])
                    if m is None:
                        continue
                    if "visible" in v:
                        m.visible = bool(v["visible"])
                    if "transform" in v:
                        tr = v["transform"]
                        m.transform = ModelTransform(pos=np.asarray(tr["pos"], np.float32),
                                                     rot=np.asarray(tr["rot"], np.float32),
                                                     scale=np.asarray(tr["scale"], np.float32))
                elif key == "compressions":
                    cur = s.compressions
                    s.set_compressions(Compressions(
                        sh=ShCompression(v.get("sh", cur.sh.value)),
                        cov3d=Cov3dCompression(v.get("cov3d", cur.cov3d.value))))
                elif key == "theme":
                    if v in ("dark", "light"):
                        s.theme = v
                elif key == "mask_op_code":
                    s.mask.op_code = v
                elif key == "mask_shape":
                    i = v["index"]
                    if 0 <= i < len(s.mask.shapes):
                        sh = s.mask.shapes[i]
                        sh.kind = MaskShapeKind(v.get("kind", sh.kind.value))
                        sh.pos = np.asarray(v.get("pos", sh.pos), np.float32)
                        sh.rot = np.asarray(v.get("rot", sh.rot), np.float32)
                        sh.scale = np.asarray(v.get("scale", sh.scale), np.float32)
                        sh.visible = bool(v.get("visible", sh.visible))
                elif key == "measurement":
                    self._set_measurement(v)

    def _set_selection(self, v: dict) -> None:
        sel = self.session.selection
        if "method" in v:
            sel.method = SelectionMethod(v["method"])
        if "operation" in v:
            sel.operation = QuerySelectionOp(v["operation"])
        sel.immediate = bool(v.get("immediate", sel.immediate))
        if "brush_radius" in v:
            sel.brush_radius = int(v["brush_radius"])
        if "show_unedited" in v:
            sel.show_unedited = bool(v["show_unedited"])
        if "edit" in v:
            e = v["edit"]
            sel.edit = None if e is None else SelectionEdit(
                hidden=e.get("hidden", False),
                hsv=tuple(e["hsv"]) if e.get("hsv") else (0.0, 1.0, 1.0),
                override_rgb=tuple(e["override_rgb"]) if e.get("override_rgb") else None,
                contrast=e.get("contrast", 0.0),
                exposure=e.get("exposure", 0.0),
                gamma=e.get("gamma", 1.0),
                alpha=e.get("alpha", 1.0),
            )

    def _set_measurement(self, v: dict) -> None:
        meas = self.session.measurement
        if "hit_method" in v:
            meas.hit_method = MeasurementHitMethod(v["hit_method"])
        if "pair" in v:
            p = v["pair"]
            i = p["index"]
            if 0 <= i < len(meas.hit_pairs):
                pair = meas.hit_pairs[i]
                pair.visible = bool(p.get("visible", pair.visible))
                pair.label = p.get("label", pair.label)
                if "color" in p:
                    pair.color = tuple(p["color"])
                if "line_width" in p:
                    pair.line_width = float(p["line_width"])

    def handle_command(self, body: dict) -> dict:
        with self.lock:
            self.mark_dirty()
            s = self.session
            cmd = body.get("cmd")
            if cmd == "remove_model":
                s.viewer.remove_model(body["key"])
                if s.selected_key == body["key"]:
                    s.selected_key = next(iter(s.viewer.models), None)
            elif cmd == "evaluate_mask":
                s.evaluate_mask(s.mask.parse_op())
            elif cmd == "reset_mask":
                s.evaluate_mask(None)
            elif cmd == "commit_edit":
                s.commit_selection_edit()
            elif cmd == "clear_selection":
                for m in s.viewer.models.values():
                    m.buffers.set_selection(np.zeros(m.buffers.capacity, np.uint8))
            elif cmd == "add_mask_shape":
                s.mask.add_shape()
            elif cmd == "remove_mask_shape":
                i = body.get("index", -1)
                if 0 <= i < len(s.mask.shapes):
                    s.mask.shapes.pop(i)
            elif cmd == "add_measurement_pair":
                s.measurement.hit_pairs.append(
                    MeasurementHitPair(label=f"Pair {len(s.measurement.hit_pairs)}"))
            elif cmd == "remove_measurement_pair":
                i = body.get("index", -1)
                if 0 <= i < len(s.measurement.hit_pairs):
                    s.measurement.hit_pairs.pop(i)
            else:
                return {"ok": False, "error": f"unknown command {cmd!r}"}
            return {"ok": True}

    def handle_open(self, filename: str, data: bytes) -> dict:
        with self.lock:
            self.mark_dirty()
            try:
                self.session.open_model(filename, io.BytesIO(data))
                return {"ok": True}
            except Exception as e:  # a bad upload is reported to the page, not raised
                _LOG.warning("open %s failed: %s", filename, e)
                return {"ok": False, "error": str(e)}

    def export_bytes(self, choices: dict | None = None) -> tuple:
        """(bytes, file name, content type). The snapshot (the device
        sidecars' downloads) is taken under the lock; the PLY or ZIP is
        serialised outside it, so /state, /set and events stay responsive
        during a large export."""
        with self.lock:
            ch = None
            if choices:
                ch = {k: ExportChoice(export=c.get("export", True),
                                      with_edit=c.get("with_edit", True),
                                      with_mask=c.get("with_mask", True))
                      for k, c in choices.items()}
            snap = snapshot_exports(self.session.viewer, ch)
        t0 = time.perf_counter()
        buf = io.BytesIO()
        names = serialize_exports(snap, buf)
        _LOG.info("export %s: %s in %.2fs (serialized off-lock)", names,
                  human_readable_size(buf.getbuffer().nbytes), time.perf_counter() - t0)
        multi = len(names) > 1
        fname = "models.zip" if multi else (names[0] if names else "model.ply")
        if not fname.endswith((".ply", ".zip")):
            fname += ".ply"
        return buf.getvalue(), fname, "application/zip" if multi else "application/octet-stream"


def make_handler(server: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json", extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def _export(self, choices):
            data, fname, ctype = server.export_bytes(choices)
            self._send(200, data, ctype,
                       {"Content-Disposition": f'attachment; filename="{fname}"'})

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/":
                    self._send(200, (ASSETS / "index.html").read_bytes(),
                               "text/html; charset=utf-8")
                elif url.path == "/manifest.json":
                    self._send(200, (ASSETS / "manifest.json").read_bytes(),
                               "application/manifest+json")
                elif url.path == "/sw.js":
                    self._send(200, (ASSETS / "sw.js").read_bytes(), "text/javascript")
                elif url.path == "/frame.jpg":
                    qs = parse_qs(url.query)
                    q = int(qs.get("quality", ["85"])[0])
                    scale = float(qs.get("scale", ["1.0"])[0])
                    max_age = float(qs["max_age"][0]) if "max_age" in qs else None
                    self._send(200, server.frame_jpeg(q, max_age, scale), "image/jpeg")
                elif url.path == "/state":
                    self._json(server.state_json())
                elif url.path == "/export":
                    self._export(None)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # the server keeps serving; the client sees a 500
                _LOG.warning("GET %s failed: %s", self.path, e)
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                if self.path == "/event":
                    server.handle_event(json.loads(data))
                    self._json({"ok": True})
                elif self.path == "/set":
                    server.handle_set(json.loads(data))
                    self._json({"ok": True})
                elif self.path == "/command":
                    self._json(server.handle_command(json.loads(data)))
                elif self.path == "/open":
                    self._json(server.handle_open(self.headers.get("X-Filename", "model.ply"),
                                                  data))
                elif self.path == "/export":
                    self._export((json.loads(data) if data else {}).get("choices"))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # the server keeps serving; the client sees a 500
                _LOG.warning("POST %s failed: %s", self.path, e)
                self._json({"error": str(e)}, 500)

    return Handler


def serve(session: GaussianSplattingSession | None = None, host: str = "127.0.0.1",
          port: int = 8080, **session_kw) -> None:
    """Run the viewer server (blocking)."""
    vs = ViewerServer(session or GaussianSplattingSession(**session_kw))
    httpd = ThreadingHTTPServer((host, port), make_handler(vs))
    _LOG.info("serving on %s:%d", host, port)
    print(f"3DGS GPU viewer at http://{host}:{port}/")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
