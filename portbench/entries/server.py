"""Entry `server`: the session of `entries/session.py`, without gestures,
behind the port's `ViewerServer` on 127.0.0.1 (an ephemeral port, a daemon
thread); one client repeats POST /event (a seeded orbit drag) and GET
/frame.jpg, so every frame is dirty. A step is one such pair, timed by the
host clock from sending the event to the file's last byte. Judged: the
kept files' coefficients against the reference's frame at the camera the
drags led to. (No cell of BENCHMARK.json runs it yet; PERF.md says why.)"""

import json
import threading
import time
import urllib.request

import numpy as np

from harness import spec

Session = spec.load("entries", "session").Driver


class Driver(Session):
    """The session behind the port's web server; one HTTP client."""

    def __init__(self, cell, models, seed, device, trace):
        super().__init__(cell, models, seed, device, trace)
        from http.server import ThreadingHTTPServer

        from wgpu_3dgs_viewer_app_tpu_torch.app import ViewerServer, make_handler

        self.gestures = []
        self.set_camera(self.camera(0))
        self.server = ViewerServer(self.session)
        if trace:
            import wgpu_3dgs_viewer_app_tpu_torch.app.server as server_mod

            server_mod.encode_frame = self.span("server.encode_ms", server_mod.encode_frame)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(self.server))
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        t = self.traffic["orbit_drag"]
        self.drags = [float(v) for v in np.linspace(t["dx_min"], t["dx_max"], t["steps"])]
        self.events: list = []   # every orbit drag sent, in order
        self.quality = int(self.traffic.get("quality", 85))

    def _call(self, path: str, body=None) -> bytes:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    def step(self, i: int, record: bool = True) -> float:
        dx = self.drags[int(self.rng.integers(len(self.drags)))]
        t0 = time.perf_counter()
        self._call("/event", {"type": "orbit", "dx": dx, "dy": 0.0})
        blob = self._call(f"/frame.jpg?quality={self.quality}")
        ms = (time.perf_counter() - t0) * 1e3
        self.events.append(dx)
        if record:
            self.samples.offer(lambda: {"i": i, "jpeg": blob, "events": list(self.events),
                                        "shapes": [dict(d) for d in self.shapes]})
        return ms

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("the server thread did not stop")
        super().close()
