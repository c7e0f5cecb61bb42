"""Entry `viewer`: `MultiModelViewer.render` at an orbit camera, a new view
every frame (`yaw_step_deg` a frame from a seeded start yaw); no gates,
queries or overlays. Its frames are judged against the reference's at the
same camera, and its traced frames' work is counted for the rooflines."""

from harness import drive
from harness import reference as ref


class Driver(drive.Driver):
    counts_stages = True   # the traced frames are plain orbit frames

    def __init__(self, cell, models, seed, device, trace):
        super().__init__(cell, models, seed, device, trace)
        from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer

        c = self.config
        v = MultiModelViewer(c["width"], c["height"], comp=drive.port_compressions(c),
                             tile=c["tile"], max_dup=c["max_dup"], device=device,
                             fused=c.get("fused", True),
                             background=tuple(c.get("background", (0.0, 0.0, 0.0))))
        v.update_gaussian_transform(drive.port_gaussian_transform(c))
        for k, (model, arrays) in enumerate(zip(c["scene"]["models"], models)):
            key = f"model{k}"
            m = v.add_model(key, drive.port_gaussians(arrays))
            v.update_model_transform(key, drive.port_transform(model))
            edit = ref.model_edit(model, len(arrays["pos"]))
            if edit is not None:
                m.buffers.set_edits(*edit)
        self.viewer = v
        self.timer = drive.Timer(device)

    def step(self, i: int, record: bool = True) -> float:
        pc = drive.port_camera(self.camera(i))
        self.timer.start()
        img = self.viewer.render(pc)
        ms = self.timer.stop()
        if record:
            self.samples.offer(lambda: {"i": i, "img": img.clone(), "yaw": self.yaw0
                                        + i * self.step_rad})
        return ms

    def close(self) -> None:
        self.viewer = None
