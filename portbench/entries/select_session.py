"""Entry `select_session`: the app's selection session. The session entry's
set-up (the model streamed in from PLY bytes made in memory, the mix's
mask evaluated), then the session in Action SELECTION with the brush, the
mix's selection edit live and the highlight on, and one pointer event of
the brush gesture (`gestures/brush.py`) every frame before `update()`.

The camera holds still through a stroke, at the orbit yaw of the stroke's
first event; between strokes it has moved on by `yaw_step_deg` a frame.
Every frame is timed with its event's host work inside it; `gesture_ms`
holds the release frames alone, from the call of `end_selection_gesture()`
to the synced frame that shows the resolved selection (the cell does not
report `edit_ms_p95`: its runs spread too widely; PERF.md). The kept frames are
the session's frames before their overlays (the image `render_overlays`
is given): the texture's tint and the cursor ring are not judged here.
Judged besides: the selection bits the window left, against the
reference's replay of the strokes since the last SET."""

import time

import torch

from harness import drive, spec

_session = spec.load("entries", "session")


class Driver(_session.Driver):
    """The session entry's driver, brushing a selection."""

    def __init__(self, cell, models, seed, device, trace):
        super().__init__(cell, models, seed, device, trace)
        from wgpu_3dgs_viewer_app_tpu_torch.app import Action, SelectionEdit, SelectionMethod

        s = self.session
        # The session entry's host-clock wrappers sync around their call;
        # this mix reads neither.
        for name in ("render_overlays", "evaluate_mask"):
            s.__dict__.pop(name, None)
        b = self.traffic["brush"]
        self.events = int(b["events"])
        s.action = Action.SELECTION
        s.selection.method = SelectionMethod.BRUSH
        s.selection.brush_radius = b["radius"]
        s.toolset.update_brush_radius(b["radius"])
        s.selection.edit = SelectionEdit(**{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in self.traffic["selection_edit"].items()})
        self.brush = self.gesture_mods["brush"]
        # What the K4 roofline's count needs (`metrics/_k4_work.py`).
        self.info.update(k4_cov3d=self.config["compressions"]["cov3d"],
                         k4_masked=s.viewer.models[self.key].buffers.mask is not None)
        self.i = 0
        self.stroke = None      # the stroke under way
        self.strokes = []       # the strokes since the last SET that took effect
        self.released = False
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.release_ev = torch.cuda.Event(enable_timing=True)
        render = s.render_overlays
        self.plain_img = None

        def keep_plain(img):
            self.plain_img = img
            return render(img)
        s.render_overlays = keep_plain

    def begin_stroke(self, st: dict) -> dict:
        self.stroke = st
        self.strokes.append(st)
        return st

    def took_effect(self, st: dict) -> None:
        """Drop the strokes before `st` once it has set the selection anew:
        a texture SET at its end, an immediate SET at its first event."""
        if st["op"] == "set" and (st["done"] or not st["texture"]):
            self.strokes = [st]

    def mark_release(self) -> None:
        self.released = True
        if self.cuda:
            self.release_ev.record()
        else:
            self.release_t0 = time.perf_counter()

    def warm(self, n: int = 3) -> None:
        """Plain brush frames, `warm_steps` of them: a whole cycle of strokes
        at the mix's size."""
        drive.Driver.warm(self, n)

    def step(self, i: int, record: bool = True, gesture=None) -> float:
        k = i // self.events
        self.i = i
        self.yaw = self.yaw0 + k * self.events * self.step_rad
        cam = self.camera(k * self.events)
        self.released = False
        self.timer.start()
        self.set_camera(cam)
        self.brush.apply(self)
        self.session.update()
        ms = self.timer.stop()
        self.selection = {"gesture": "brush", "radius": float(self.traffic["brush"]["radius"]),
                          "shapes": [],
                          "strokes": [{"op": st["op"], "texture": st["texture"], "yaw": st["yaw"],
                                       "done": st["done"], "pts": list(st["pts"])}
                                      for st in self.strokes]}
        if record:
            img, sel = self.plain_img, self.selection

            def snap():
                return {"i": i, "img": img.clone(), "yaw": self.yaw, "gesture": "brush",
                        "shapes": [], "selection": sel}
            self.samples.offer(snap)
            if self.released:
                self.gesture_ms.append(self.release_ev.elapsed_time(self.timer.b) if self.cuda
                                       else (time.perf_counter() - self.release_t0) * 1e3)
                self.gesture_samples.offer(snap)
        self.plain_img = None
        return ms
