"""The one traffic generator: it reads a traffic mix (`traffic/<name>.json`)
and offers it to the port through the entry the mix names, in a closed
loop: the next frame or request starts when the last one is shown.

An entry is `entries/<entry>.py`, found by the mix's `entry`; its `Driver`
sets the port up and runs one step at a time. The session entry's edit
gestures are `gestures/<name>.py`, found by the names the mix lists. What
every entry shares is here: the orbit camera, the step timer, the seeded
reservoir of kept outputs, the spans of a traced run, and the port's
records made from the configuration (compressions, display transform,
model transforms).

Every frame ends in `torch.cuda.synchronize()`. Each step's time is taken
by CUDA events around it (device timestamps; the stream is idle when a
step starts), a request's by the host clock. A seeded reservoir keeps a few
steps' outputs and the inputs that made them for the correctness check."""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from . import reference as ref
from . import spec


class Reservoir:
    """A seeded uniform sample of k items of a stream."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, make):
        """Count one item; `make()` builds it only when it is kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = make()


def port_gaussians(arrays: dict):
    from wgpu_3dgs_viewer_app_tpu_torch.data import Gaussians

    return Gaussians(**arrays)


def port_compressions(config: dict):
    from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions, Cov3dCompression, ShCompression

    c = config["compressions"]
    return Compressions(sh=ShCompression(c["sh"]), cov3d=Cov3dCompression(c["cov3d"]))


def port_gaussian_transform(config: dict):
    """The port's display transform at the configuration's display mode and
    SH degree (each checked by the reference, which runs the same)."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import GaussianTransform
    from wgpu_3dgs_viewer_app_tpu_torch.core.transform import (GaussianDisplayMode,
                                                                GaussianShDegree)

    return GaussianTransform(display_mode=GaussianDisplayMode(ref.display_mode(config)),
                             sh_deg=GaussianShDegree(ref.sh_degree(config)))


def port_transform(model: dict):
    """The port's transform of one model of the configuration's scene."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform

    return ModelTransform(pos=np.asarray(model.get("pos", (0, 0, 0)), np.float32),
                          rot=np.asarray(model.get("rot_deg", (0, 0, 0)), np.float32))


def port_camera(cam):
    """The port's orbit camera at the pose of a reference camera."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl

    return CameraOrbitControl(target=cam.target, pos=cam.pos, z=(cam.z_near, cam.z_far),
                              vertical_fov=cam.vertical_fov)


class Timer:
    """CUDA events around one step: ms from the first to the second record,
    after a sync. (On the CPU, where the harness's tests drive it, the host
    clock.)"""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.b.record()
        torch.cuda.synchronize()
        return self.a.elapsed_time(self.b)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    """What every entry shares: the orbit, the step loop, the samples."""

    counts_stages = False   # whether the traced steps' work is counted for the rooflines

    def __init__(self, cell, models: list, seed: int, device, trace: bool):
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.rng = np.random.Generator(np.random.SFC64(self.seed))
        self.yaw0 = float(self.rng.uniform(0.0, 2.0 * math.pi))
        self.step_rad = math.radians(float(self.traffic.get("yaw_step_deg", 0.0)))
        self.samples = Reservoir(int(self.traffic.get("sample_frames", 3)), self.seed ^ 0x5A5A)
        self.step_ms: list = []     # every step of the window
        self.spans: dict = {}       # name -> list of seconds (trace runs)
        self.info: dict = {}        # counts for the log and the checks

    def camera(self, i: int):
        return ref.camera_at(self.config, self.yaw0 + i * self.step_rad)

    def span(self, name: str, fn):
        """fn wrapped in a host-clock span closed by a sync on both sides
        (trace runs only)."""
        def wrapped(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.device)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapped

    def warm(self, n: int = 3) -> None:
        for i in range(-n, 0):
            self.step(i, record=False)

    def kept(self) -> list:
        """The outputs kept for the correctness check."""
        return list(self.samples.items)

    def final_bits(self):
        """The bits the window left, for the check (None: none to judge)."""
        return None

    def close(self) -> None:
        pass


def make(cell, models, seed, device, trace) -> Driver:
    """The driver of the entry the cell's traffic names (`entries/<entry>.py`)."""
    return spec.load("entries", cell.traffic["entry"]).Driver(cell, models, seed, device, trace)
