"""Entry `session`: `GaussianSplattingSession.update()` with the model
streamed in at set-up from PLY bytes made in memory (the loader's path; no
file), the mix's mask shapes evaluated and their gizmos drawn every frame,
the camera orbiting. One frame in `gesture_every` is an edit gesture, in
the turn that `gestures` lists them; each is `gestures/<name>.py`, found
by its name. Judged: the kept frames (gates and gizmos worked out again by
the reference) and the mask and selection bits the window left."""

import io
import time

import numpy as np

from harness import drive, spec
from harness import reference as ref


def ply_bytes(arrays: dict) -> bytes:
    """The scene as an Inria PLY, in memory, by the reference's writer."""
    from gsref.data.gaussian import Gaussians
    from gsref.data.ply import write_ply

    buf = io.BytesIO()
    write_ply(buf, Gaussians(**arrays))
    return buf.getvalue()


class Driver(drive.Driver):
    """The app session over one model, streamed in at set-up."""

    def __init__(self, cell, models, seed, device, trace):
        super().__init__(cell, models, seed, device, trace)
        from wgpu_3dgs_viewer_app_tpu_torch.app import (GaussianSplattingSession, SceneCommand,
                                                        SceneCommandKind)
        from wgpu_3dgs_viewer_app_tpu_torch.mask import MaskShape, MaskShapeKind

        self._cmd = (SceneCommand, SceneCommandKind)
        c, t = self.config, self.traffic
        if len(models) != 1:
            raise ValueError("the session mixes take a configuration of one model")
        s = GaussianSplattingSession(width=c["width"], height=c["height"],
                                     compressions=drive.port_compressions(c), device=device,
                                     tile=c["tile"], max_dup=c["max_dup"])
        s.gaussian_transform = drive.port_gaussian_transform(c)
        t0 = time.perf_counter()
        s.open_model("scene.ply", io.BytesIO(ply_bytes(models[0])))
        while s.loader is not None:
            s._drain_loader()
        drive.sync(device)
        self.spans["loader.load_s"] = [time.perf_counter() - t0]
        self.session = s
        self.key = next(iter(s.viewer.models))
        self.base_shapes = ref.placed_shapes(c, t)
        self.shapes = [dict(d) for d in self.base_shapes]
        for d in self.shapes:
            s.mask.add_shape(MaskShape(kind=MaskShapeKind(d["kind"]), pos=d["pos"].copy(),
                                       scale=d["scale"].copy()))
        s.mask.op_code = t["mask"]["op"]
        self.evaluate_mask()
        s.update()
        drive.sync(device)
        kept = int(s.viewer.models[self.key].buffers.mask.sum())
        n = len(models[0]["pos"])
        self.info.update(splats=n, mask_kept=kept, mask_kept_share=kept / n)
        self.selection = None   # the inputs of the last selection gesture
        self.gestures = list(t.get("gestures", []))
        self.gesture_mods = {g: spec.load("gestures", g) for g in self.gestures}
        self.every = int(t.get("gesture_every", 0))
        self.gesture_ms: list = []
        self.gesture_samples = drive.Reservoir(int(t.get("sample_gestures", 1)) * max(
            len(self.gestures), 1), self.seed ^ 0xA5A5)
        self.timer = drive.Timer(device)
        self.yaw = self.yaw0
        if trace:
            s.render_overlays = self.span("session.overlay_ms", s.render_overlays)
            s.evaluate_mask = self.span("session.mask_ms", s.evaluate_mask)

    def evaluate_mask(self) -> None:
        """EvaluateMask with the session's shapes, sent on the command bus."""
        SceneCommand, SceneCommandKind = self._cmd
        self.session.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK,
                                               mask_op=self.session.mask.parse_op()))

    def set_camera(self, cam) -> None:
        ctl = self.session.camera.control
        ctl.target = np.asarray(cam.target, np.float32)
        ctl.pos = np.asarray(cam.pos, np.float32)

    def gesture_at(self, i: int) -> str | None:
        if not self.every or not self.gestures or i < 0 or (i + 1) % self.every:
            return None
        return self.gestures[((i + 1) // self.every - 1) % len(self.gestures)]

    def warm(self, n: int = 3) -> None:
        """Plain frames, then one frame of each gesture of the mix."""
        super().warm(n)
        for g in dict.fromkeys(self.gestures):
            self.step(-1, record=False, gesture=g)

    def step(self, i: int, record: bool = True, gesture: str | None = None) -> float:
        self.yaw = self.yaw0 + i * self.step_rad
        cam = self.camera(i)
        gesture = gesture or self.gesture_at(i)
        self.timer.start()
        self.set_camera(cam)
        if gesture is not None:
            self.gesture_mods[gesture].apply(self)
        img = self.session.update()
        ms = self.timer.stop()
        if record:
            def snap():
                return {"i": i, "img": img.clone(), "yaw": self.yaw, "gesture": gesture,
                        "shapes": [dict(d) for d in self.shapes], "selection": self.selection}
            self.samples.offer(snap)
            if gesture is not None:
                self.gesture_ms.append(ms)
                self.gesture_samples.offer(snap)
        return ms

    def kept(self) -> list:
        return self.samples.items + self.gesture_samples.items

    def final_bits(self) -> dict:
        """The session's mask and selection bits as the window left them,
        with the inputs that made them."""
        b = self.session.viewer.models[self.key].buffers
        return {"mask": None if b.mask is None else b.mask.clone(),
                "selection": None if b.selection is None else b.selection.clone(),
                "shapes": [dict(d) for d in self.shapes], "selection_in": self.selection}

    def close(self) -> None:
        self.session = None
