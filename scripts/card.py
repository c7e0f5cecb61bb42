#!/usr/bin/env python3
"""Timers and BASELINE scenes of the card scripts (`ab_port_kernels.py`,
`profile_port_frame.py`) on one NVIDIA GPU. It imports neither JAX nor the
JAX package.

Timers: `cuda_ms` (CUDA events), `wrapper_times` (a kernel wrapper by
events, alone under torch.profiler, and the host's time to issue),
`device_kernel_ms` and `profile_frames` (device time by kernel under
torch.profiler), `timed_frames` (the host clock around synced frames) and
`ptxas_rows` (registers and spills from the build's ptxas report).

Scenes (random splats, the default compression, tile 32, max_dup 4): BASELINE
configs 0-4 and the steps built on them. The benchmark's own scenes are
`portbench/harness/scene.py`'s; correctness lives in the card tests
(`tests/test_torch_cuda.py`, `-m cuda`).
"""

from __future__ import annotations

import time

PROFILE_TRIES = 3   # profiler sessions before a device time is written down as not measured

CONFIG2_SIZE = (1920, 1088)
CONFIG2_PLACEMENTS = ((-2.0, 0.0), (0.0, 40.0), (2.0, -40.0))  # x offset, y rotation (deg)
CONFIG3_RECT = ((400.0, 200.0), (1400.0, 800.0))  # the step's selection rect at 1920x1080

# BASELINE config 4 (bench.py:313-366): the config-1 scene at 1920x1088, three
# mask shapes (kind, position, uniform scale) and the op code over them.
CONFIG4_SIZE = (1920, 1088)
CONFIG4_SHAPES = (("box", (0.0, 0.0, 0.0), 1.5), ("ellipsoid", (0.5, 0.0, 0.0), 1.0),
                  ("box", (-0.5, 0.4, 0.0), 0.6))
CONFIG4_OP = "(0 | 1) - 2"
CONFIG4_HITS = ((960.0, 544.0), (1060.0, 580.0))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs after one warm-up, by CUDA
    events on the current stream. Host gaps inside fn count: such a time
    includes the host's time between launches, and where a wrapper's host
    work outlasts its kernel (K1 and K5 at 1M splats) it is the host's time.
    `wrapper_times`' "device_ms" is the kernel alone."""
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps: int, check=None):
    """torch.profiler over `reps` calls of fn() after one warm-up: the
    profile, or None where the profiler saw no device time. CUPTI on the
    card's host now and then records no kernel in a session, or fewer than
    were launched, so a session that saw nothing, or one that `check(prof)`
    (a message, or None when the session holds what is asked of it) finds
    wanting, is made again, up to PROFILE_TRIES times. Where some session
    saw device time but none passed `check`, its message is raised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    fault = None  # the last `check` message of a session that saw device time
    for attempt in range(PROFILE_TRIES):
        if attempt:
            print(f"  (profiler session {attempt} of {PROFILE_TRIES}: "
                  f"{fault or 'no device time'}; once more)", flush=True)
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if not any(getattr(e, "device_type", None) == DeviceType.CUDA for e in prof.events()):
            continue
        fault = check(prof) if check else None
        if fault is None:
            return prof
    if fault is not None:
        raise AssertionError(fault)
    print(f"  (the profiler saw no device time in {PROFILE_TRIES} sessions: not measured)",
          flush=True)
    return None


def device_kernel_ms(fn, reps: int, check=None):
    """Under `profiled`: (ms per call of each kernel name, the ms of each
    launch of each name in launch order), or None where the profiler saw no
    device time. `check(per_name, launches)` as in `profiled`."""
    from torch.autograd import DeviceType

    def split(prof):
        per_name, launches = {}, {}
        events = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
        for e in sorted(events, key=lambda e: e.time_range.start):
            ms = e.time_range.elapsed_us() / 1e3
            per_name[e.name] = per_name.get(e.name, 0.0) + ms / reps
            launches.setdefault(e.name, []).append(ms)
        return per_name, launches

    prof = profiled(fn, reps, check and (lambda prof: check(*split(prof))))
    return None if prof is None else split(prof)


def wrapper_times(fn, part: str, reps: int = 20) -> dict:
    """A kernel wrapper's time three ways: `ms` by CUDA events around
    back-to-back calls (`cuda_ms`), `device_ms` the one kernel whose name
    holds `part` alone under torch.profiler (None where the profiler saw no
    device time), and `host_ms` the host's time to issue one call (no
    synchronise inside the timed calls)."""
    import torch

    def one_kernel(per_name, launches):
        names = [k for k in per_name if part in k]
        return None if len(names) == 1 else f"kernel {part}: {names} among {sorted(per_name)}"

    found = device_kernel_ms(fn, reps, one_kernel)
    seen = []
    if found is not None:
        per_name, launches = found
        # The mean over the launches the profiler kept: late in a long
        # process it has kept fewer than `reps`.
        seen = launches[next(k for k in per_name if part in k)]
        if len(seen) != reps:
            print(f"  (the profiler kept {len(seen)} of {reps} launches of {part})", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    return {"ms": cuda_ms(fn, reps), "device_ms": sum(seen) / len(seen) if seen else None,
            "host_ms": host}


def ptxas_rows(part: str, usage: dict = None) -> dict:
    """ptxas's registers, stack frame and spill bytes (`usage`, by default
    this process's build: `kernels.resource_usage`) of each instantiation of
    the kernel whose mangled name holds `part`, by its template arguments;
    empty when the library was built by another process."""
    import re

    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels

    rows = {}
    for name, u in sorted((kernels.resource_usage if usage is None else usage).items()):
        if part in name and "registers" in u:
            args = re.findall(r"L[ib](\d+)E", name.split(part, 1)[1].split("EEv")[0])
            rows[f"{part}<{','.join(args)}>"] = u
    return rows


def timed_frames(frame, warmups: int = 2, frames: int = 5) -> float:
    """ms per frame by the host clock closed by a synchronise, after
    `warmups` untimed frames."""
    import torch

    for _ in range(warmups):
        frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        frame()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames


def profile_frames(step, frames: int = 3) -> tuple:
    """`profiled` over `frames` calls of step() (wall ms, device-busy ms,
    [(kernel, ms per frame, launches per frame)] by time, largest first), or
    None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType

    walls = []

    def timed():
        t0 = time.perf_counter()
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    prof = profiled(timed, 1)
    if prof is None:
        return None
    # Device-side events only: the host ops that launched them carry the
    # same device time and would count it twice.
    rows = [(e.key, e.self_device_time_total / 1e3 / frames, e.count // frames)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) * frames
    if busy <= 0:
        raise AssertionError("the profiler saw device events but no device time")
    return walls[-1], busy, sorted(rows, key=lambda r: -r[1])


def pod_tensors(g, device):
    from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words,
                                                     pack_gaussians, pod_to_tensors)

    comp = Compressions()
    return comp, pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), device)


def _random_scene(n: int, seed: int):
    """n random splats (extent 2) and the camera at (0, 0, -6) on the origin."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    g = make_random_scene(n, seed=seed, extent=2.0, scale_range=(0.004, 0.02))
    return g, CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


def config0_scene():
    """BASELINE config 0: 50k splats, drawn at 800x600 in point mode at SH 0."""
    return _random_scene(50_000, 0)


def config1_scene():
    """BASELINE config 1: 6M splats."""
    return _random_scene(6_000_000, 0)


def config3_scene():
    """BASELINE config 3: 2M splats."""
    return _random_scene(2_000_000, 1)


def config2_models(which=range(len(CONFIG2_PLACEMENTS))) -> list:
    """BASELINE config 2's models `which`: 1M random splats each, seed i."""
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    return [make_random_scene(1_000_000, seed=i, extent=1.5, scale_range=(0.004, 0.02))
            for i in which]


def config2_edit(n: int, i: int) -> tuple:
    """Model i's per-splat edit: enabled on every splat, hue shift 0.08 i,
    saturation 1.1, default params."""
    from wgpu_3dgs_viewer_app_tpu_torch.core.edit import EDIT_FLAG_ENABLED, make_edit_soa

    flags, rgb, params = make_edit_soa(n)
    flags[:] = EDIT_FLAG_ENABLED
    rgb[:] = (0.08 * i, 1.1, 1.0)
    return flags, rgb, params


def config2_camera():
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl

    return CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -7))


def config2_viewer(models: list, device, fused: bool = True, comp=None, size=CONFIG2_SIZE,
                   placements=CONFIG2_PLACEMENTS, tile: int = 32, max_dup: int = 4):
    """Config 2 on a MultiModelViewer: model i at (x offset, rotation about y
    in degrees) `placements[i]` (x = -2, 0, 2 turned 0, 40, -40 degrees by
    default), each with its edit, camera at (0, 0, -7); packed under `comp`
    (the default compression when None)."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer

    v = MultiModelViewer(*size, comp=comp or Compressions(), tile=tile, max_dup=max_dup,
                         device=device, fused=fused)
    for i, (g, (dx, rot)) in enumerate(zip(models, placements)):
        m = v.add_model(f"m{i}", g)
        v.update_model_transform(f"m{i}", ModelTransform(pos=np.float32([dx, 0.0, 0.0]),
                                                         rot=np.float32([0.0, rot, 0.0])))
        m.buffers.set_edits(*config2_edit(g.count, i))
    v.update_camera(config2_camera())
    return v


def config2_model(i: int, device) -> tuple:
    """Config 2's model i alone, as the merged frame draws it: (comp, pod,
    the config under model_bits 2, view, projection, model matrix, its edit
    on `device`)."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu_torch.ops import TileConfig

    (g,) = config2_models([i])
    comp, pod = pod_tensors(g, device)
    (w, h), cam, (dx, rot) = CONFIG2_SIZE, config2_camera(), CONFIG2_PLACEMENTS[i]
    mmat = ModelTransform(pos=np.float32([dx, 0, 0]), rot=np.float32([0, rot, 0])).matrix()
    flags, rgb, params = config2_edit(g.count, i)
    edit = tuple(torch.from_numpy(a).to(device) for a in (flags.view(np.int32), rgb, params))
    return (comp, pod, TileConfig(w, h, tile=32, max_dup=4, model_bits=2), cam.view(),
            cam.projection(w / h), mmat, edit)


def selection_pods(alpha: float = 1.0) -> tuple:
    """Config 3's selection edit (its alpha `alpha`) and highlight, as
    bench.py's config 3 sets them."""
    from wgpu_3dgs_viewer_app_tpu_torch.core.edit import (EDIT_FLAG_ENABLED, GaussianEditPod,
                                                          SelectionHighlightPod)

    return (GaussianEditPod(EDIT_FLAG_ENABLED, (0.15, 1.2, 1.0), 0.1, 0.2, 1.0, alpha),
            SelectionHighlightPod((1.0, 0.0, 1.0, 0.4)))


def gates(n: int, device, seed: int = 3) -> dict:
    """Every gate of the front-end, from one numpy seed: a mask keeping ~75%,
    per-splat edits (off, on, hidden, override), a selection of ~half with
    config 3's selection edit at alpha 0.8, and its highlight."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sel_edit, highlight = selection_pods(0.8)
    flags = rng.choice(np.uint32([0, 1, 1, 3, 5]), n).view(np.int32)
    rgb = rng.uniform([-1.0, 0.5, 0.5], [1.0, 1.5, 1.5], (n, 3)).astype(np.float32)
    params = rng.uniform([-0.3, -0.5, 0.5, 0.3], [0.3, 0.5, 2.0, 1.0], (n, 4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "mask_bits": t((rng.random(n) > 0.25).astype(np.uint8)),
        "edit": (t(flags), t(rgb), t(params)),
        "selection_bits": t((rng.random(n) > 0.5).astype(np.uint8)),
        "selection_edit": sel_edit.as_arrays(),
        "highlight_rgba": np.float32(highlight.rgba),
    }


def config3_step(v, rect=CONFIG3_RECT):
    """The config-3 step on a single-model viewer whose camera is set: query
    geometry (K4) -> select_rect -> set_selection -> selection edit and
    highlight (`selection_pods`) -> Viewer.render. Returns step() -> (frame,
    geometry, bits); scripts/profile_port_frame.py profiles it."""
    from wgpu_3dgs_viewer_app_tpu_torch.ops import preprocess_geometry_fused
    from wgpu_3dgs_viewer_app_tpu_torch.query import select_rect

    m = v.models["model"]
    sel_edit, highlight = selection_pods()

    def step():
        pre = preprocess_geometry_fused(m.buffers.pod, v.comp, v._view, v._proj,
                                        m.transform.matrix(), v.cfg.width, v.cfg.height,
                                        display_mode=0)
        bits = select_rect(pre, *rect)
        m.buffers.set_selection(bits)
        v.update_selection_edit(sel_edit)
        v.update_selection_highlight(highlight, True)
        return v.render(), pre, bits

    return step


def v1_planes(pod, comp, cfg, cam, sh_degree: int = 3, display_mode: int = 0):
    """One model's EntryPlanes through the v1 chain's first stages: the
    preprocess (K8), `build_tile_lists` (K2) and `build_entry_planes`."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (build_entry_planes, build_tile_lists,
                                                    preprocess_fused)

    pre = preprocess_fused(pod, comp, cam.view(), cam.projection(cfg.width / cfg.height),
                           np.eye(4, dtype=np.float32), cfg.width, cfg.height,
                           sh_degree=sh_degree, display_mode=display_mode)
    return build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)


def v1_frame(pod, comp, cfg, cam):
    """The v1 chain on one model: frame() -> (H, W, 3) over black, through
    `v1_planes` and `composite_tiles` (K6); scripts/profile_port_frame.py
    profiles it."""
    from wgpu_3dgs_viewer_app_tpu_torch.ops import composite_tiles, over_background

    def frame():
        return over_background(composite_tiles(v1_planes(pod, comp, cfg, cam), cfg),
                               (0.0, 0.0, 0.0))

    return frame


def rows_frame(pod, comp, cfg, cam, mxu: bool = True):
    """The row-major v2 frame on one model: frame() -> (H, W, 3) over black,
    K1 -> K2 -> `composite_tiles_v2(transposed=False, mxu=mxu)` (K3)."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (build_sorted_entries_fused,
                                                    composite_tiles_v2, over_background)

    view, proj = cam.view(), cam.projection(cfg.width / cfg.height)
    eye = np.eye(4, dtype=np.float32)

    def frame():
        se = build_sorted_entries_fused(pod, comp, cfg, view, proj, eye)
        return over_background(composite_tiles_v2(se, cfg, transposed=False, mxu=mxu),
                               (0.0, 0.0, 0.0))

    return frame
