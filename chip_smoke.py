#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, exit 0 only if all pass

Phases, each printing what it found:
  1. device: the card's name and power limit (nvidia-smi) and the seconds the
     CUDA kernels took to build from `wgpu_3dgs_viewer_app_tpu_torch/csrc`
     and the native codec from `native/gsnative.cpp` (g++, before the
     first pack);
  2. each kernel against its plain torch version on the card, with both
     times: K1 front-end (ungated and with every gate), K2 entry sort (row
     for row against the stable plain sort, with each of its kernels' bytes
     and achieved rate under torch.profiler) and the v2 compositor K3 (Horner
     form, within rounding) at the shapes of the config-1 path below; K4 query geometry
     (ungated and with the mask and edit gates) at the config-3 shapes; K5
     enumerate-and-pack on the plain preprocess of the config-1 scene and of
     one config-2 model (ranks 0 and 2), also slot for slot against K1; K1
     with a model rank at the config-2 shapes (and its bound); K3 also at
     tiles 64 (one block of 1024 threads a tile), 128 (a cluster of 4 row
     bands) and 320 (32-px parts in two launches) on the config-1 scene;
     K8, the preprocess, bit for bit its plain version (every field and
     `valid` of every splat) on the config-1 scene (ungated), the config-3
     scene (the step's rect selection with its selection edit and
     highlight, a mask and per-splat edits) and one config-2 model (its
     edits), and in every compression, SH degree and display mode at 20k
     splats, with K5's entries from K8's planes equal to those from the
     plain planes. K1, K5 and K8 are timed three ways (`wrapper_times`:
     events around the wrapper, the kernel alone under torch.profiler, the
     host's time to issue a call), with ptxas's registers and spills of
     each of their instantiations;
  3. the golden fixture rendered through the port's CLI on cuda, held to the
     repo's golden gate (`tests/test_golden.py::assert_golden_close`), and
     the CLI's orbit sequence (`--frames 3 --orbit-step 20`), each frame
     byte for byte the single render at its yaw;
  4. BASELINE config 1: a 6M-splat scene at 1920x1080, SH degree 3, norm8
     SH + half cov3d, tile 32, max_dup 4, through `Viewer.render`: 2 warm-up
     and 5 timed frames; the launch counters must show K1-K3 ran once a
     frame, and the frame must meet the plain compositor on its own sorted
     entries within 1e-4;
  5. BASELINE config 3: selection and editing on a 2M-splat scene at the
     same settings. Timed step (2 warm-up, 5 timed): the query geometry
     (K4) -> `select_rect` -> `set_selection` -> a selection edit and
     highlight -> `Viewer.render` (gated K1 -> K2 -> K3); the counters must
     show K4 and K1 ran, and the gated K1 is held against its plain version
     on the step's own gates. Then, once each and checked: a brush stroke (ADD),
     a texture-mode resolve, `commit_selection_edit` and a render with the
     per-splat edits, a `show_unedited` render (equal to the ungated one),
     a render with half the splats masked, and hit queries at the centre;
  6. BASELINE config 2: three 1M-splat models with per-model transforms and
     per-splat colour edits at 1920x1088, merged into one frame by a model
     rank in the sort key, on the fused route (K1 x3 -> K2 -> K3) and on the
     staged route (K8 -> K5, x3 -> K2 -> K3): 2 warm-up and 5
     timed frames each, the launch counts of one frame, K8 on the three
     models alone against the plain preprocess, merged = per-model
     frames blended back to front, route against route, the rank and depth
     order of the sorted entries, then a hidden model, an order flip, a
     resize and a change of compression;
  7. the two paths off the viewer's frame, on the config-1 scene: the
     v1 chain (K8 -> `build_tile_lists` (K2) -> `build_entry_planes` ->
     `composite_tiles` (K6) -> `over_background`; K8 once a frame, and
     each stage's peak memory and time alone)
     and the row-major v2 frame (K1 -> K2 -> `composite_tiles_v2(
     transposed=False, mxu=True)`, K3 in the quadratic-basis form), 2
     warm-up and 5 timed frames each with their launch counts, coverage and
     difference from phase 4's frame; then K6 against its plain version
     (splat; flat on the BASELINE config-0 shapes: 50k splats, 800x600,
     point mode, SH 0), K2 row for row at the v1 key, and K3 against its
     plain version with the quadratic-basis exponent and in flat mode on the
     config-0 shapes, for both `transposed` values, and basis against
     Horner on the card; K6 also at tiles 64, 128 and 320;
  8. BASELINE config 4 through the app session (`GaussianSplattingSession`,
     1920x1088, tile 32, max_dup 4): the config-1 scene written as a PLY to
     a temporary directory and streamed in (`open_model`, the
     `StreamingLoader`), the three mask shapes and `(0 | 1) - 2` of
     bench.py sent as EvaluateMask through the command bus (bits held
     against a numpy evaluation on the host positions), 2 warm-up and 5
     timed `update()` frames with the gizmos (gated K1, K2, K3 and the
     overlay kernel K9 once a frame; overlay time apart, peak memory, idle
     share and the top device kernels under torch.profiler), the masked
     frame against a scene of the kept splats alone (<= 1e-5), two hit
     queries making a measurement pair (K4), a frame with its line; K9 bit
     for bit the plain overlays run on the card (the frame's 121 segments
     through `render_overlays` in one launch, with the rect gesture's tint
     and a brush ring, 600 random segments, one and none), timed three ways
     with its plain version, bound and ptxas report; an export with the
     mask filter (the kept count), Reset (the unmasked frame again), and a
     rect gesture with a committed edit;
  9. phase 8's session served over HTTP: the port's `ViewerServer` on a
     `ThreadingHTTPServer` at 127.0.0.1 (an ephemeral port, a daemon
     thread) driven with urllib: the page and `/state`; the mask evaluated
     again over `/command`; 2 warm-up and 5 timed dirty frames (an orbit
     `/event`, then `/frame.jpg?quality=85`), each split into `update()`,
     the JPEG encoder's device stages, its copy to the host, its host stage
     and the HTTP overhead; a dirty frame's launches (K1-K3 once, and K9
     once for the gizmos) and an idle poll's (none, the cached bytes); the
     served bytes against `utils.jpeg` of an in-process `update()` and
     against the CPU encoding
     of its uint8 copy; a `scale=0.5` frame's size; the first-person
     camera; a rect selection over `/event` (K4 once) and a committed
     edit; a masked export over `/export` (the kept count); and a change of
     compression over `/set`;
 10. the native codec and the sharded renderer on the config-1 scene: the
     6M-splat pack by the codec (the default `pack_gaussians`, and
     `pack_gaussians_native` alone) and by numpy (`use_native=False`),
     timed, the codec's pod held against numpy's within `tests/
     test_native.py`'s tolerances; then the config-1 frame through
     `parallel.render_sharded` over NCCL at world size 1 (an in-process
     group on a `HashStore`, destroyed at the end): 2 warm-up and 5 timed
     frames against as many `viewer.render_frame` frames, K8 and K5
     once, K2 twice (the local sort and the owner's), K3 once and K1
     never a frame, overflow 0 and `last_stats()`, the image bit for bit
     `render_frame`'s (itself bit for bit the same pipeline on the plain
     preprocess), and each stage's time (local front-end and sort,
     the count exchange and its host read, the entries' all_to_all, the
     owner's sort and composite, the gather) over 5 more frames.

The line before the last two is the kernels' JSON record (each kernel's
launches on its path, error against its plain version, times, least time
the card could take for the same work, and a library call's time where one
PyTorch call computes the same function; K3 and K6 with their tile-64,
tile-128 and tile-320 numbers, K9 with its all-stages and random-segment
numbers, and every kernel's launches in one config-4 frame, in its hit
queries, in one served frame and in one sharded frame); the next is
nvidia-smi's name and power limit; the last is {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Runs without a CUDA device, or outside the repo, fail
before printing it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# An image whose tiles stop at their 128-entry chunk exits may lack up to
# the remaining transmittance, 1/255 a channel, against one drawn on.
EXIT_TOL = 1.0 / 255.0 + 1e-5
# Profiler sessions a device-time measurement is made in before it is
# written down as not measured (`profiled`).
PROFILE_TRIES = 3

KERNELS = {
    "fused": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/fused.cu",
              "wgpu_3dgs_viewer_app_tpu/ops/fused.py:138"),
    "sort": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/sort.cu",
             "wgpu_3dgs_viewer_app_tpu/ops/compact.py:95; "
             "wgpu_3dgs_viewer_app_tpu/ops/sort.py:325; "
             "wgpu_3dgs_viewer_app_tpu/ops/sort.py:779"),
    "composite": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/composite_v2.cu",
                  "wgpu_3dgs_viewer_app_tpu/ops/composite.py:489; "
                  "wgpu_3dgs_viewer_app_tpu/ops/composite.py:639"),
    "geometry": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/geometry.cu",
                 "wgpu_3dgs_viewer_app_tpu/ops/fused.py:693"),
    "enum_pack": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/enum_pack.cu",
                  "wgpu_3dgs_viewer_app_tpu/ops/binning.py:611"),
    "composite_v1": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/composite_v1.cu",
                     "wgpu_3dgs_viewer_app_tpu/ops/composite.py:163"),
    # K8: the jitted preprocess (one XLA program on the TPU, no Pallas kernel).
    "preprocess": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/geometry.cu",
                   "wgpu_3dgs_viewer_app_tpu/ops/preprocess.py:107"),
    # K9: the app frame's overlays (jitted image programs, no Pallas kernel).
    "overlay": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/overlay.cu",
                "wgpu_3dgs_viewer_app_tpu/core/lines.py:29; "
                "wgpu_3dgs_viewer_app_tpu/query/overlay.py:16; :24"),
}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes and f32 (non-tensor-core)
# operations per millisecond.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3
# Operations per unit of work, counted from the kernels' sources: K1 ~230
# per splat (decode, transforms, EWA, extent, cull, pack, tight cull) plus
# 4 per SH coefficient and channel, 40 per entry slot and ~110 per edit
# applied; K4 ~150 per splat plus ~110 per edit; K2 ~34 integer operations
# per live entry (liveness, 4 radix passes) and 1 per slot; K3 22 per
# (pixel, entry) blend; K5 ~60 per splat (key, colour bytes, f16 words,
# tight cull) and K1's 40 per entry slot; K8 K4's per splat, K1's per SH
# coefficient and channel, and ~110 per edit applied.
K1_OPS_SPLAT, K1_OPS_SH, K1_OPS_SLOT, OPS_EDIT = 230, 4, 40, 110
K4_OPS_SPLAT, K2_OPS_LIVE, K3_OPS_BLEND = 150, 34, 22
K5_OPS_SPLAT = 60
# K6 26 per blend (K3's 22 with the natural-log exponent's extra scale, the
# per-pixel clamp and T folded into the weight); K3 24 in the quadratic-basis
# form (a 6-term dot instead of the Horner nest).
K6_OPS_BLEND, K3_MXU_OPS_BLEND = 26, 24
# K3 and K6 end where their plain versions end: they differ by rounding.
K67_TOL = 1e-4
# K9 per (pixel, segment) pair inside the segment's box (box test, the
# projection's f32 and f64 steps, root, cover, 3 blends) and per pixel for
# the tint and the ring.
K9_OPS_PAIR, K9_OPS_TINT, K9_OPS_RING = 30, 6, 16
# Random segments K9 is held at besides the frame's own: at most 256 px
# long, widths 0-8.
K9_RANDOM_SEGMENTS = 600

CONFIG2_SIZE = (1920, 1088)
CONFIG2_PLACEMENTS = ((-2.0, 0.0), (0.0, 40.0), (2.0, -40.0))  # x offset, y rotation (deg)

CONFIG3_RECT = ((400.0, 200.0), (1400.0, 800.0))

# BASELINE config 4 (bench.py:313-366): the config-1 scene at 1920x1088, three
# mask shapes (kind, position, uniform scale) and the op code over them.
CONFIG4_SIZE = (1920, 1088)
CONFIG4_SHAPES = (("box", (0.0, 0.0, 0.0), 1.5), ("ellipsoid", (0.5, 0.0, 0.0), 1.0),
                  ("box", (-0.5, 0.4, 0.0), 0.6))
CONFIG4_OP = "(0 | 1) - 2"
CONFIG4_HITS = ((960.0, 544.0), (1060.0, 580.0))
# Config 4's splats (config 1's scene) and those its mask keeps (the scene
# and the shapes are made from seeds).
CONFIG4_SPLATS, CONFIG4_KEPT = 6_000_000, 306_829
# Tiles over 32 px that K3 and K6 are held at besides the main path's 32: one
# block of 1024 threads a tile at 64, a cluster of 4 row bands at 128, and
# 32-px parts in two launches at 320 (csrc/composite.cuh).
LARGE_TILES = (64, 128, 320)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def k3_launches(frames: int = 1, tile: int = 32) -> int:
    """K3's launches over `frames` frames at `tile`: two a frame where its
    walk is split in two passes (`ops.composite.composite_launches`)."""
    from wgpu_3dgs_viewer_app_tpu_torch.ops.composite import composite_launches

    return frames * composite_launches(tile)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs after one warm-up, by CUDA
    events on the current stream. Host gaps inside fn count: every "ms" and
    "plain_ms" of this script includes the host's time between launches, and
    where a wrapper's host work outlasts its kernel (K1 and K5 at 1M splats)
    it is the host's time. The "device_ms" fields (`wrapper_times`) are the
    kernel alone."""
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


def timed_once(fn) -> tuple:
    """fn()'s result and the milliseconds of that one run, by CUDA events
    (for plain runs too slow to repeat: ~100 s at tile 320 on an H100)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (nested tuples and None allowed)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None and hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: float, ops: float) -> tuple:
    """Least time (ms) the card could take: bytes over HBM bandwidth or
    operations over the f32 rate, whichever is larger."""
    b, o = n_bytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


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
            log(f"  (profiler session {attempt} of {PROFILE_TRIES}: {fault or 'no device time'}; "
                f"once more)")
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
    require(fault is None, fault)
    log(f"  (the profiler saw no device time in {PROFILE_TRIES} sessions: not measured)")
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


def fmt_ms(ms) -> str:
    """A device time for the log: "not measured" where the profiler saw none."""
    return "not measured" if ms is None else f"{ms:.4f}"


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
            log(f"  (the profiler kept {len(seen)} of {reps} launches of {part})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    return {"ms": cuda_ms(fn, reps), "device_ms": sum(seen) / len(seen) if seen else None,
            "host_ms": host, "device_launches_seen": len(seen)}


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


def log_ptxas(what: str, rows: dict, phase: int = 2) -> None:
    for label, u in rows.items():
        log(f"phase {phase} {what} {label}: {u['registers']} registers, {u.get('stack', 0)} B "
            f"stack frame, {u.get('spill_stores', 0)} B spill stores, {u.get('spill_loads', 0)} B "
            f"spill loads (ptxas)")
    if not rows:
        log(f"phase {phase} {what}: no ptxas report (the library was built by another process)")


def k2_kernel_report(sort, e: int, n_live: int, n_tiles: int) -> dict:
    """Each K2 kernel's device time per sort, the bytes it must move (each
    input read once, each output written once) and its achieved rate."""
    parts = ("upfront_kernel", "digit_start_kernel", "onesweep_pass_kernel", "tile_edges_kernel")

    def whole(per_name, launches):
        for part in parts:
            names = [k for k in per_name if part in k]
            if len(names) != 1:
                return f"K2 kernel {part}: {names} among {sorted(per_name)}"
            if part == "onesweep_pass_kernel" and len(launches[names[0]]) != 4 * 5:
                return f"{len(launches[names[0]])} one-sweep passes in 5 sorts"
        return None

    found = device_kernel_ms(sort, 5, whole)
    if found is None:
        log("phase 2 K2 kernels: not measured (the profiler saw no device time)")
        return {"not_measured": "the profiler saw no device time"}
    per_name, launches = found

    def find(part):
        return next(k for k in per_name if part in k)

    passes = launches[find("onesweep_pass_kernel")]
    first = sum(passes[0::4]) / 5
    rows = [("upfront", "upfront_kernel (live count, 4 histograms)",
             per_name[find("upfront_kernel")], 16 * e, 4 * 1025),
            ("digit_start", "digit_start_kernel", per_name[find("digit_start_kernel")],
             4 * 1024, 4 * 1024),
            ("pass1", "onesweep_pass_kernel, pass 1 (compacts)", first, 16 * e, 16 * n_live),
            ("passes2_4", "onesweep_pass_kernel, passes 2-4",
             per_name[find("onesweep_pass_kernel")] - first, 3 * 16 * n_live, 3 * 16 * n_live),
            ("tile_edges", "tile_edges_kernel", per_name[find("tile_edges_kernel")],
             16 * n_live, 4 * (n_tiles + 1))]
    other = sum(ms for k, ms in per_name.items() if not any(p in k for p in parts))
    out = {}
    for key, name, ms, rd, wr in rows:
        rate = (rd + wr) / (ms * 1e-3) / 1e12
        out[key] = {"ms": ms, "bytes_read": rd, "bytes_written": wr, "tb_per_s": rate}
        log(f"phase 2 K2 {name}: {ms:.4f} ms, reads {rd / 1e6:.1f} MB, writes {wr / 1e6:.1f} MB, "
            f"{rate:.3f} TB/s ({rate / (HBM_BYTES_PER_MS * 1e3 / 1e12):.1%} of 3.35 TB/s)")
    out["other_device_ms"] = other
    log(f"phase 2 K2 the rest (memsets, the live count's copy): {other:.4f} ms; sum of kernels "
        f"{sum(per_name.values()):.4f} ms per sort under the profiler")
    return out


def pod_tensors(g, device):
    from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words,
                                                     pack_gaussians, pod_to_tensors)

    comp = Compressions()
    return comp, pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), device)


def config1_scene():
    """BASELINE config 1: 6M random splats, camera at (0, 0, -6)."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    g = make_random_scene(6_000_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    return g, CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


def config3_scene():
    """BASELINE config 3: 2M random splats, camera at (0, 0, -6)."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    g = make_random_scene(2_000_000, seed=1, extent=2.0, scale_range=(0.004, 0.02))
    return g, CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


def config2_models() -> list:
    """BASELINE config 2's three models: 1M random splats each, seeds 0-2."""
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    return [make_random_scene(1_000_000, seed=i, extent=1.5, scale_range=(0.004, 0.02))
            for i in range(len(CONFIG2_PLACEMENTS))]


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


def config2_viewer(models: list, device, fused: bool = True, comp=None):
    """Config 2 on a MultiModelViewer: the models at x = -2, 0, 2 turned 0,
    40, -40 degrees about y, each with its edit, camera at (0, 0, -7); packed
    under `comp` (the default compression when None)."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer

    w, h = CONFIG2_SIZE
    v = MultiModelViewer(w, h, comp=comp or Compressions(), tile=32, max_dup=4, device=device,
                         fused=fused)
    for i, (g, (dx, rot)) in enumerate(zip(models, CONFIG2_PLACEMENTS)):
        m = v.add_model(f"m{i}", g)
        v.update_model_transform(f"m{i}", ModelTransform(pos=np.float32([dx, 0.0, 0.0]),
                                                         rot=np.float32([0.0, rot, 0.0])))
        m.buffers.set_edits(*config2_edit(g.count, i))
    v.update_camera(config2_camera())
    return v


def config2_frame(v, fused: bool):
    """The config-2 frame on one front-end route: frame() -> the merged
    image. Phase 6 times it and scripts/profile_port_frame.py profiles it."""

    def frame():
        v.fused = fused
        return v.render()

    return frame


def gates(n: int, device, seed: int = 3) -> dict:
    """Every gate of the front-end, from one numpy seed: a mask keeping ~75%,
    per-splat edits (off, on, hidden, override), a selection of ~half with a
    selection edit, and a highlight."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.core.edit import EDIT_FLAG_ENABLED, GaussianEditPod

    rng = np.random.default_rng(seed)
    flags = rng.choice(np.uint32([0, 1, 1, 3, 5]), n).view(np.int32)
    rgb = rng.uniform([-1.0, 0.5, 0.5], [1.0, 1.5, 1.5], (n, 3)).astype(np.float32)
    params = rng.uniform([-0.3, -0.5, 0.5, 0.3], [0.3, 0.5, 2.0, 1.0], (n, 4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "mask_bits": t((rng.random(n) > 0.25).astype(np.uint8)),
        "edit": (t(flags), t(rgb), t(params)),
        "selection_bits": t((rng.random(n) > 0.5).astype(np.uint8)),
        "selection_edit": GaussianEditPod(EDIT_FLAG_ENABLED, (0.15, 1.2, 1.0), 0.1, 0.2, 1.0,
                                          0.8).as_arrays(),
        "highlight_rgba": np.float32([1.0, 0.0, 1.0, 0.4]),
    }


def k1_bound(pod, out, gate_kw, n: int, d: int, sh_coeffs: int) -> tuple:
    """K1's bound: every pod plane and gate read once, the entries written
    once; operations counted per splat, SH coefficient, edit and slot."""
    edits = (1 if "edit" in gate_kw else 0) + (1 if "selection_edit" in gate_kw else 0)
    gate_tensors = [gate_kw.get(k) for k in ("mask_bits", "edit", "selection_bits")]
    ops = n * (K1_OPS_SPLAT + K1_OPS_SH * 3 * sh_coeffs + OPS_EDIT * edits) + K1_OPS_SLOT * n * d
    return bound(nbytes(list(pod.values()), out, gate_tensors), ops)


def phase_kernels(g1, cam1, g3, cam3, device) -> dict:
    """Phase 2: each kernel against its plain version on the same inputs.
    K1-K3 at the config-1 shapes (1080p, tile 32, max_dup 4, default pod),
    K4 at the config-3 shapes."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (
        TileConfig, composite_tiles_plain_v2, composite_tiles_v2, enumerate_entries_fused,
        enumerate_entries_plain, preprocess_geometry_fused, preprocess_geometry_plain,
        sort_entries, sort_entries_plain)
    from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import ROW
    from wgpu_3dgs_viewer_app_tpu_torch.testing import (compare_entries, compare_preprocess,
                                                        compare_sorted)

    w, h, n = 1920, 1080, g1.count
    comp, pod = pod_tensors(g1, device)
    view, proj = cam1.view(), cam1.projection(w / h)
    eye = np.eye(4, dtype=np.float32)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    args = (pod, comp, cfg, view, proj, eye)
    rec = {}

    # K1 ungated: the config-1 path.
    ent_k = enumerate_entries_fused(*args)
    ent_p = enumerate_entries_plain(*args)
    st = compare_entries(ent_k, ent_p, cfg)
    del ent_p
    b_ms, b_by = k1_bound(pod, ent_k, {}, n, cfg.max_dup, 15)
    t = wrapper_times(lambda: enumerate_entries_fused(*args), "fused_frontend_kernel")
    rec["fused"] = {"max_abs_err": st["max_field_step"], **t,
                    "plain_ms": cuda_ms(lambda: enumerate_entries_plain(*args), 2),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"phase 2 K1 front-end: {n} splats, {st['live_a']} live entries, "
        f"{st['identical']:.6f} identical to plain, {st['differing']} within one step; "
        f"kernel {t['ms']:.4f} ms by events around the wrapper ({fmt_ms(t['device_ms'])} device "
        f"only, {t['host_ms']:.4f} host to issue), plain {rec['fused']['plain_ms']:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    rec["fused"]["ptxas"] = ptxas_rows("fused_frontend_kernel")
    log_ptxas("K1 (SH 0 f32 1 f16 2 norm8 3 none, cov 0 f32 1 f16, gated)", rec["fused"]["ptxas"])

    # K1 with every gate, same shapes.
    gkw = gates(n, device)
    ent_g = enumerate_entries_fused(*args, **gkw)
    stg = compare_entries(ent_g, enumerate_entries_plain(*args, **gkw), cfg)
    require(not torch.equal(ent_g, ent_k), "the gates changed no entry")
    del ent_g
    gb_ms, _ = k1_bound(pod, ent_k, gkw, n, cfg.max_dup, 15)
    t = wrapper_times(lambda: enumerate_entries_fused(*args, **gkw), "fused_frontend_kernel")
    gated = {**{f"gated_{k}": v for k, v in t.items()},
             "gated_plain_ms": cuda_ms(lambda: enumerate_entries_plain(*args, **gkw), 2),
             "gated_bound_ms": gb_ms, "gated_max_abs_err": stg["max_field_step"]}
    rec["fused"].update(gated)
    rec["fused"]["max_abs_err"] = max(rec["fused"]["max_abs_err"], stg["max_field_step"])
    del gkw
    log(f"phase 2 K1 gated (mask, edits, selection edit, highlight): {stg['live_a']} live "
        f"entries, {stg['identical']:.6f} identical to plain, {stg['differing']} within one step; "
        f"kernel {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} device only, {t['host_ms']:.4f} host), "
        f"plain {gated['gated_plain_ms']:.3f} ms, bound {gb_ms:.4f} ms")

    # K2, row for row against the stable plain sort.
    se_k = sort_entries(ent_k, cfg)
    compare_sorted(se_k, sort_entries_plain(ent_k, cfg), stable=True)
    keys = ent_k[:, 0].to(torch.int64) & 0xFFFFFFFF
    live = keys != 0xFFFFFFFF
    keys_live, ent_live = keys[live], ent_k[live]
    del keys, live
    n_live, e = se_k.n_valid, ent_k.shape[0]
    b_ms, b_by = bound(nbytes(ent_k) + nbytes(se_k.live(), se_k.tile_starts, se_k.tile_counts),
                       K2_OPS_LIVE * n_live + e)
    rec["sort"] = {"max_abs_err": 0,
                   "ms": cuda_ms(lambda: sort_entries(ent_k, cfg), 20),
                   "plain_ms": cuda_ms(lambda: sort_entries_plain(ent_k, cfg), 3),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": cuda_ms(
                       lambda: ent_live[torch.sort(keys_live, stable=True).indices], 5)}
    del keys_live, ent_live
    log(f"phase 2 K2 entry sort: {e} entries, {n_live} live; row for row equal to the stable "
        f"plain sort; kernel {rec['sort']['ms']:.3f} ms, plain "
        f"{rec['sort']['plain_ms']:.3f} ms, torch.sort + gather of the live entries "
        f"{rec['sort']['library_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    rec["sort"]["kernels"] = k2_kernel_report(lambda: sort_entries(ent_k, cfg), e, n_live,
                                              cfg.n_tiles)

    # K3, Horner form, within rounding of its plain version.
    img_k = composite_tiles_v2(se_k, cfg)
    work = {}
    img_p = composite_tiles_plain_v2(se_k, cfg, stats=work)
    err = float((img_k - img_p).abs().max())
    require(err <= K67_TOL, f"K3 max abs {err} > {K67_TOL}")
    # Bytes: the 128-entry chunks read before the tiles' exits, 16 B an entry.
    b_ms, b_by = bound(work["rows"] * ROW * 16
                       + nbytes(se_k.tile_starts, se_k.tile_counts, img_k),
                       K3_OPS_BLEND * work["pairs"])
    rec["composite"] = {"max_abs_err": err,
                        "ms": cuda_ms(lambda: composite_tiles_v2(se_k, cfg), 20),
                        "plain_ms": cuda_ms(lambda: composite_tiles_plain_v2(se_k, cfg), 1),
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"phase 2 K3 compositor (Horner): max abs {err:.3e} (<= {K67_TOL}) vs plain; kernel "
        f"{rec['composite']['ms']:.3f} ms, plain {rec['composite']['plain_ms']:.3f} ms, "
        f"{work['pairs']} blends needed, bound {b_ms:.3f} ms ({b_by})")
    del ent_k, se_k, img_k, img_p

    # K3 at tiles over 32 px on the same scene, against its plain version.
    for tile in LARGE_TILES:
        cfg_t = TileConfig(w, h, tile=tile, max_dup=4)
        se_t = sort_entries(enumerate_entries_fused(pod, comp, cfg_t, view, proj, eye), cfg_t)
        img_t = composite_tiles_v2(se_t, cfg_t)
        work = {}
        plain_t, plain_ms = timed_once(lambda: composite_tiles_plain_v2(se_t, cfg_t, stats=work))
        err_t = float((img_t - plain_t).abs().max())
        require(err_t <= K67_TOL, f"K3 at tile {tile}: max abs {err_t} > {K67_TOL}")
        b_t, by_t = bound(work["rows"] * ROW * 16
                          + nbytes(se_t.tile_starts, se_t.tile_counts, img_t),
                          K3_OPS_BLEND * work["pairs"])
        if tile <= 256:  # over 256 the stats run's own time (its counting included)
            plain_ms = cuda_ms(lambda: composite_tiles_plain_v2(se_t, cfg_t), 1)
        r = {"ms": cuda_ms(lambda: composite_tiles_v2(se_t, cfg_t), 20), "plain_ms": plain_ms,
             "bound_ms": b_t, "bound_by": by_t, "max_abs_err": err_t, "blends": work["pairs"]}
        rec["composite"][f"tile{tile}"] = r
        rec["composite"]["max_abs_err"] = max(rec["composite"]["max_abs_err"], err_t)
        log(f"phase 2 K3 at tile {tile} ({cfg_t.n_tiles} tiles, {se_t.n_valid} live entries): max "
            f"abs {err_t:.3e} (<= {K67_TOL}) vs plain; kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, {work['pairs']} blends needed, bound {b_t:.3f} ms ({by_t})")
        del se_t, img_t, plain_t
    del pod

    # K4 at the config-3 shapes, ungated (the timed step) and gated.
    n3 = g3.count
    comp3, pod3 = pod_tensors(g3, device)
    view3, proj3 = cam3.view(), cam3.projection(w / h)
    gargs = (pod3, comp3, view3, proj3, eye, w, h)
    geo_in = [pod3[k] for k in ("pos", "color0", "cov3d")]
    g4 = {k: v for k, v in gates(n3, device, seed=5).items() if k in ("mask_bits", "edit")}
    errs, times = [], {}
    for name, kw in (("", {}), ("gated_", g4)):
        pre_k = preprocess_geometry_fused(*gargs, **kw)
        st4 = compare_preprocess(pre_k, preprocess_geometry_plain(*gargs, **kw))
        errs.append(st4["max_abs_err"])
        out_bytes = nbytes(*(getattr(pre_k, f) for f in pre_k.__dataclass_fields__))
        times[f"{name}bound_ms"], by = bound(
            nbytes(geo_in, kw.get("mask_bits"), kw.get("edit")) + out_bytes,
            n3 * (K4_OPS_SPLAT + (OPS_EDIT if kw else 0)))
        times[f"{name}ms"] = cuda_ms(lambda: preprocess_geometry_fused(*gargs, **kw), 20)
        times[f"{name}plain_ms"] = cuda_ms(lambda: preprocess_geometry_plain(*gargs, **kw), 3)
        times[f"{name}bound_by"] = by
        log(f"phase 2 K4 query geometry{' gated (mask, edits)' if kw else ''}: {n3} splats, "
            f"{st4['valid']} valid, validity {st4['valid_equal']:.6f} equal to plain, fields "
            f"{st4['identical']:.6f} bit-identical, max abs {st4['max_abs_err']:.3e}; kernel "
            f"{times[f'{name}ms']:.3f} ms, plain {times[f'{name}plain_ms']:.3f} ms, bound "
            f"{times[f'{name}bound_ms']:.4f} ms ({by})")
    rec["geometry"] = {"max_abs_err": max(errs), "ms": times["ms"], "plain_ms": times["plain_ms"],
                       "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
                       "library_ms": None, "gated_ms": times["gated_ms"],
                       "gated_plain_ms": times["gated_plain_ms"],
                       "gated_bound_ms": times["gated_bound_ms"]}
    return rec


def slot_stats(a, b, cfg) -> dict:
    """`compare_entries` plus the count of slots that differ at all."""
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries

    st = compare_entries(a, b, cfg)
    st["slots_differing"] = int((a != b).any(dim=1).sum())
    return st


def phase_kernels_staged(g1, cam1, model2, device, rec: dict) -> None:
    """Phase 2, continued: K5 against its plain version and against K1, and
    K1 with a model rank, at the config-1 and config-2 shapes."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (
        TileConfig, enumerate_entries_from_pre, enumerate_entries_from_pre_plain,
        enumerate_entries_fused, enumerate_entries_plain, preprocess)

    eye = np.eye(4, dtype=np.float32)

    def k5_bound(pre, out, n, d):
        planes = [getattr(pre, f) for f in pre.__dataclass_fields__]
        return bound(nbytes(planes, out), n * (K5_OPS_SPLAT + K1_OPS_SLOT * d))

    # K5 on the config-1 scene (6M splats, ungated), against plain and K1.
    w, h, n = 1920, 1080, g1.count
    comp, pod = pod_tensors(g1, device)
    view, proj = cam1.view(), cam1.projection(w / h)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    pre = preprocess(pod, comp, view, proj, eye, w, h)
    ent5 = enumerate_entries_from_pre(pre, cfg)
    st = slot_stats(ent5, enumerate_entries_from_pre_plain(pre, cfg), cfg)
    require(st["slots_differing"] == 0 or st["max_field_step"] <= 1, f"K5 vs plain: {st}")
    st1 = slot_stats(ent5, enumerate_entries_fused(pod, comp, cfg, view, proj, eye), cfg)
    b6_ms, b6_by = k5_bound(pre, ent5, n, cfg.max_dup)
    t = wrapper_times(lambda: enumerate_entries_from_pre(pre, cfg), "enum_pack_kernel")
    k5 = {"max_abs_err": st["max_field_step"],
          **{f"config1_{k}": v for k, v in t.items()},
          "config1_plain_ms": cuda_ms(lambda: enumerate_entries_from_pre_plain(pre, cfg), 2),
          "config1_bound_ms": b6_ms,
          "config1_preprocess_plain_ms": cuda_ms(
              lambda: preprocess(pod, comp, view, proj, eye, w, h), 2)}
    log(f"phase 2 K5 enumerate-and-pack, config-1 scene: {n} splats, {st['live_a']} live "
        f"entries, {st['slots_differing']} of {ent5.shape[0]} slots differ from plain (max field "
        f"step {st['max_field_step']}); vs K1 on the same scene and camera: "
        f"{st1['slots_differing']} slots differ, {st1['identical']:.6f} of live slots identical, "
        f"max field step {st1['max_field_step']}; kernel {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} "
        f"device only, {t['host_ms']:.4f} host), plain {k5['config1_plain_ms']:.3f} ms, bound "
        f"{b6_ms:.4f} ms ({b6_by}); the plain preprocess "
        f"before it {k5['config1_preprocess_plain_ms']:.3f} ms")
    del pre, ent5, pod

    # K5 on one config-2 model (1M splats, its edits and transform), ranks 0
    # and 2 under model_bits 2: the shapes of the staged config-2 frame.
    w, h = CONFIG2_SIZE
    n = model2.count
    comp, pod = pod_tensors(model2, device)
    cam = config2_camera()
    view, proj = cam.view(), cam.projection(w / h)
    dx, rot = CONFIG2_PLACEMENTS[1]
    mmat = ModelTransform(pos=np.float32([dx, 0, 0]), rot=np.float32([0, rot, 0])).matrix()
    flags, rgb, params = config2_edit(n, 1)
    edit = tuple(torch.from_numpy(a).to(device) for a in (flags.view(np.int32), rgb, params))
    cfg_m = TileConfig(w, h, tile=32, max_dup=4, model_bits=2)
    pre = preprocess(pod, comp, view, proj, mmat, w, h, edit=edit)
    for rank in (0, 2):
        ent5 = enumerate_entries_from_pre(pre, cfg_m, model_rank=rank)
        st = slot_stats(ent5, enumerate_entries_from_pre_plain(pre, cfg_m, model_rank=rank), cfg_m)
        require(st["slots_differing"] == 0 or st["max_field_step"] <= 1, f"K5 vs plain: {st}")
        keys = ent5[:, 0].to(torch.int64) & 0xFFFFFFFF
        ranks = (keys[keys != 0xFFFFFFFF] >> cfg_m._rank_shift) & 3
        require(bool((ranks == rank).all()), f"K5: a live key without rank {rank}")
        k5["max_abs_err"] = max(k5["max_abs_err"], st["max_field_step"])
        log(f"phase 2 K5, one config-2 model, rank {rank} of model_bits 2: {n} splats, "
            f"{st['live_a']} live entries, {st['slots_differing']} slots differ from plain")
    b_ms, b_by = k5_bound(pre, ent5, n, cfg_m.max_dup)
    t = wrapper_times(lambda: enumerate_entries_from_pre(pre, cfg_m, model_rank=2),
                      "enum_pack_kernel")
    k5.update({**t,
               "plain_ms": cuda_ms(
                   lambda: enumerate_entries_from_pre_plain(pre, cfg_m, model_rank=2), 3),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    rec["enum_pack"] = k5
    log(f"phase 2 K5 at the config-2 shapes: kernel {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} "
        f"device only, {t['host_ms']:.4f} host), plain {k5['plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    k5["ptxas"] = ptxas_rows("enum_pack_kernel")
    log_ptxas("K5", k5["ptxas"])
    del pre, ent5

    # K1 with rank 1 of model_bits 2 and the model's edits, against plain.
    args = (pod, comp, cfg_m, view, proj, mmat)
    ent1 = enumerate_entries_fused(*args, model_rank=1, edit=edit)
    st = slot_stats(ent1, enumerate_entries_plain(*args, model_rank=1, edit=edit), cfg_m)
    keys = ent1[:, 0].to(torch.int64) & 0xFFFFFFFF
    require(bool(((keys[keys != 0xFFFFFFFF] >> cfg_m._rank_shift) & 3 == 1).all()),
            "ranked K1: a live key without rank 1")
    rec["fused"]["max_abs_err"] = max(rec["fused"]["max_abs_err"], st["max_field_step"])
    t = wrapper_times(lambda: enumerate_entries_fused(*args, model_rank=1, edit=edit),
                      "fused_frontend_kernel")
    rec["fused"].update({f"config2_ranked_{k}": v for k, v in t.items()})
    rec["fused"]["config2_ranked_plain_ms"] = cuda_ms(
        lambda: enumerate_entries_plain(*args, model_rank=1, edit=edit), 3)
    rb_ms, rb_by = k1_bound(pod, ent1, {"edit": edit}, n, cfg_m.max_dup, 15)
    rec["fused"]["config2_ranked_bound_ms"] = rb_ms
    log(f"phase 2 K1 with model rank 1 of model_bits 2 (one config-2 model, edits on): "
        f"{st['live_a']} live entries, {st['slots_differing']} slots differ from plain, "
        f"{st['identical']:.6f} identical; kernel {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} device "
        f"only, {t['host_ms']:.4f} host), "
        f"plain {rec['fused']['config2_ranked_plain_ms']:.3f} ms, bound {rb_ms:.4f} ms ({rb_by}: "
        f"pod words, edit SoA and {ent1.shape[0]} entry slots)")


def k8_bound(pod, pre, gate_kw, n: int, sh_coeffs: int) -> tuple:
    """K8's bound: the pod planes the degree reads (the SH words and norm8
    range only at degree > 0) and the gate tensors read once, the 11 planes
    and `valid` written once; operations counted per splat, SH coefficient
    and edit."""
    edits = (1 if "edit" in gate_kw else 0) + (1 if "selection_edit" in gate_kw else 0)
    pod_in = [pod[k] for k in ("pos", "color0", "cov3d")]
    if sh_coeffs:
        pod_in += [pod[k] for k in ("sh", "sh_mn", "sh_span") if k in pod]
    gate_tensors = [gate_kw.get(k) for k in ("mask_bits", "edit", "selection_bits")]
    out = [getattr(pre, f) for f in pre.__dataclass_fields__]
    ops = n * (K4_OPS_SPLAT + K1_OPS_SH * 3 * sh_coeffs + OPS_EDIT * edits)
    return bound(nbytes(pod_in, gate_tensors, out), ops)


def phase_kernels_preprocess(g1, cam1, g3, cam3, model2, device, rec: dict) -> None:
    """Phase 2, continued: K8 (`preprocess_fused`) against the plain
    `preprocess`, bit for bit on every field and `valid` of every splat, at
    the config-1 (ungated), config-3 (every gate) and config-2 (one model,
    its edits) shapes and in every compression, SH degree and display mode
    at 20k splats; K5 fed K8's planes against K5 fed the plain planes, slot
    for slot."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu_torch.data import (ALL_COMPRESSIONS, flat_pod_to_words,
                                                     make_random_scene, pack_gaussians,
                                                     pod_to_tensors)
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (TileConfig, enumerate_entries_from_pre,
                                                    preprocess, preprocess_fused,
                                                    preprocess_geometry_fused)
    from wgpu_3dgs_viewer_app_tpu_torch.query import select_rect
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_preprocess_bits

    eye = np.eye(4, dtype=np.float32)
    k8 = {"max_abs_err": 0.0, "library_ms": None}

    def held(what, args, kw, cfg=None, rank=0):
        """K8 against plain on `args`, `kw`: bit for bit, and (with `cfg`)
        K5's entries from each; returns (K8's output, stats)."""
        pre_k = preprocess_fused(*args, **kw)
        pre_p = preprocess(*args, **kw)
        st = compare_preprocess_bits(pre_k, pre_p)
        if cfg is not None:
            e_k = enumerate_entries_from_pre(pre_k, cfg, model_rank=rank)
            e_p = enumerate_entries_from_pre(pre_p, cfg, model_rank=rank)
            require(torch.equal(e_k, e_p), f"{what}: K5's entries from K8 differ from plain's")
            st["entries"] = e_k.shape[0]
            del e_k, e_p
        del pre_p
        return pre_k, st

    # Config 1: 6M splats, ungated (the staged route's and the sharded
    # frame's shapes), SH 3, norm8/half.
    w, h, n = 1920, 1080, g1.count
    comp, pod = pod_tensors(g1, device)
    args = (pod, comp, cam1.view(), cam1.projection(w / h), eye, w, h)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    pre, st = held("config 1", args, {}, cfg)
    b_ms, b_by = k8_bound(pod, pre, {}, n, 15)
    t = wrapper_times(lambda: preprocess_fused(*args), "geometry_kernel")
    k8.update(t)
    k8.update({"plain_ms": cuda_ms(lambda: preprocess(*args), 2), "bound_ms": b_ms,
               "bound_by": b_by})
    log(f"phase 2 K8 preprocess, config-1 scene: {n} splats, {st['valid']} valid, every field "
        f"and valid bit for bit the plain preprocess's, K5's {st['entries']} entry slots from "
        f"each equal; kernel {t['ms']:.4f} ms by events around the wrapper "
        f"({fmt_ms(t['device_ms'])} device only, {t['host_ms']:.4f} host to issue), plain "
        f"{k8['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    del pre, pod, args

    # Config 3: 2M splats, every gate: the step's rect selection (on K4's
    # geometry) with config 3's selection edit and highlight, a mask and
    # per-splat edits.
    n3 = g3.count
    comp, pod = pod_tensors(g3, device)
    args = (pod, comp, cam3.view(), cam3.projection(w / h), eye, w, h)
    sel_edit, highlight = config3_pods()
    gkw = {k: v for k, v in gates(n3, device, seed=5).items() if k in ("mask_bits", "edit")}
    gkw.update(selection_bits=select_rect(preprocess_geometry_fused(*args), *CONFIG3_RECT),
               selection_edit=sel_edit.as_arrays(),
               highlight_rgba=np.asarray(highlight.rgba, np.float32))
    pre, st = held("config 3 gated", args, gkw, cfg)
    require(not torch.equal(pre.col_r, preprocess_fused(*args).col_r), "the gates changed nothing")
    b_ms, by = k8_bound(pod, pre, gkw, n3, 15)
    t = wrapper_times(lambda: preprocess_fused(*args, **gkw), "geometry_kernel")
    k8.update({f"config3_gated_{k}": v for k, v in t.items()})
    k8.update({"config3_gated_plain_ms": cuda_ms(lambda: preprocess(*args, **gkw), 2),
               "config3_gated_bound_ms": b_ms})
    log(f"phase 2 K8 gated (mask, edits, the step's selection edit and highlight), config-3 "
        f"scene: {n3} splats, {st['valid']} valid, bit for bit the plain preprocess, K5 from each "
        f"equal; kernel {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} device only, "
        f"{t['host_ms']:.4f} host), plain {k8['config3_gated_plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({by})")
    del pre, pod, args, gkw

    # One config-2 model: 1M splats, its transform and edits, 1920x1088; K5
    # at rank 2 of model_bits 2.
    w2, h2 = CONFIG2_SIZE
    n2 = model2.count
    comp, pod = pod_tensors(model2, device)
    cam = config2_camera()
    dx, rot = CONFIG2_PLACEMENTS[1]
    mmat = ModelTransform(pos=np.float32([dx, 0, 0]), rot=np.float32([0, rot, 0])).matrix()
    flags, rgb, params = config2_edit(n2, 1)
    edit = tuple(torch.from_numpy(a).to(device) for a in (flags.view(np.int32), rgb, params))
    args = (pod, comp, cam.view(), cam.projection(w2 / h2), mmat, w2, h2)
    cfg_m = TileConfig(w2, h2, tile=32, max_dup=4, model_bits=2)
    pre, st = held("config 2", args, {"edit": edit}, cfg_m, rank=2)
    b_ms, by = k8_bound(pod, pre, {"edit": edit}, n2, 15)
    t = wrapper_times(lambda: preprocess_fused(*args, edit=edit), "geometry_kernel")
    k8.update({f"config2_{k}": v for k, v in t.items()})
    k8.update({"config2_plain_ms": cuda_ms(lambda: preprocess(*args, edit=edit), 3),
               "config2_bound_ms": b_ms})
    log(f"phase 2 K8, one config-2 model with its edits: {n2} splats, {st['valid']} valid, bit "
        f"for bit the plain preprocess, K5 (rank 2 of model_bits 2) from each equal; kernel "
        f"{t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} device only, {t['host_ms']:.4f} host), plain "
        f"{k8['config2_plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({by})")
    del pre, pod, args, edit

    # Every compression, SH degree and display mode (and no_sh0, and every
    # gate) at 20k splats, as K1 is held.
    g = make_random_scene(20_000, seed=4, extent=2.0, scale_range=(0.004, 0.05))
    view, proj = cam1.view(), cam1.projection(w / h)
    sweep = ((3, 0, False), (2, 1, False), (1, 2, False), (0, 0, False), (3, 1, True))
    held_cases = 0
    for comp in ALL_COMPRESSIONS:
        pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), device)
        args = (pod, comp, view, proj, eye, w, h)
        for deg, mode, no_sh0 in sweep:
            held(f"{comp} deg {deg} mode {mode}", args,
                 dict(sh_degree=deg, display_mode=mode, no_sh0=no_sh0))
            held_cases += 1
        held(f"{comp} gated", args, gates(g.count, device, seed=6))
        held_cases += 1
    k8["small_cases_bit_for_bit"] = held_cases
    log(f"phase 2 K8 at 20k splats: {held_cases} cases (8 compressions x SH 3/2/1/0 in modes "
        f"0/1/2/0, no_sh0 at SH 3, and every gate at SH 3) bit for bit the plain preprocess")
    k8["ptxas"] = ptxas_rows("geometry_kernel")
    log_ptxas("K4 (SH 4) and K8 (SH 0 f32 1 f16 2 norm8 3 none, cov 0 f32 1 f16, gated)",
              k8["ptxas"])
    rec["preprocess"] = k8


def phase_golden(work_dir: str) -> None:
    """Phase 3: the golden fixture through the port's CLI on cuda."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden import assert_golden_close

    from wgpu_3dgs_viewer_app_tpu_torch.app.cli import main as cli
    from wgpu_3dgs_viewer_app_tpu_torch.data import read_ply, write_ply
    from wgpu_3dgs_viewer_app_tpu_torch.utils.png import read_png

    g = read_ply(os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply"))
    g = g.select(np.arange(g.count) < 20_000)  # prefix crop, as scripts/gen_golden.py
    ply, png = os.path.join(work_dir, "golden_20k.ply"), os.path.join(work_dir, "golden.png")
    with open(ply, "wb") as f:
        write_ply(f, g)
    rc = cli(["render", ply, "-o", png, "--width", "256", "--height", "256",
              "--max-dup", "16", "--orbit", "30", "--device", "cuda"])
    require(rc == 0, f"CLI render exited {rc}")
    img = read_png(png).astype(np.int16)
    gold = read_png(os.path.join(REPO, "tests", "golden", "golden_256.png")).astype(np.int16)
    assert_golden_close(img, gold)
    d = np.abs(img - gold)
    require(d.mean() < 1.0 and d.max() <= 48, "golden drift")  # holds under -O too
    log(f"phase 3 golden: CLI render on cuda vs tests/golden/golden_256.png: mean "
        f"{d.mean():.4f} u8, max {d.max()} u8 -> assert_golden_close passed")

    # The orbit sequence: frame i is the single render at yaw 20 i, byte for byte.
    args = ["render", ply, "--width", "256", "--height", "256", "--max-dup", "16",
            "--device", "cuda"]
    seq = os.path.join(work_dir, "seq.png")
    rc = cli(args + ["-o", seq, "--frames", "3", "--orbit-step", "20"])
    require(rc == 0, f"CLI render --frames 3 exited {rc}")
    frames = []
    for i in range(3):
        single = os.path.join(work_dir, f"single_{i}.png")
        require(cli(args + ["-o", single, "--orbit", str(20 * i)]) == 0, "CLI render exited")
        with open(os.path.join(work_dir, f"seq_{i:03d}.png"), "rb") as f, open(single, "rb") as g1:
            got, want = f.read(), g1.read()
        require(got == want, f"orbit frame {i} differs from the single render at {20 * i} deg")
        frames.append(got)
    require(len(set(frames)) == 3, "the orbit sequence repeats a frame")
    log("phase 3 orbit sequence: CLI render --frames 3 --orbit-step 20 on cuda wrote "
        "seq_000..002.png, each byte for byte the single render at 0, 20, 40 deg "
        f"({', '.join(str(len(b)) for b in frames)} B)")


def check_frame(img, what: str, min_coverage: float = 0.2, size=(1920, 1080)) -> float:
    """Shape, finite values and the share of covered pixels of a frame."""
    import torch

    require(img.shape == (size[1], size[0], 3), f"{what}: image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{what}: non-finite pixels")
    coverage = float((img.amax(dim=-1) > 1.0 / 255.0).float().mean())
    require(coverage > min_coverage, f"{what}: only {coverage:.3f} of pixels covered")
    return coverage


def phase_config1(g, cam, device, smi: str, rec: dict) -> dict:
    """Phase 4: BASELINE config 1 through Viewer.render."""
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (build_sorted_entries_fused,
                                                    composite_tiles_plain_v2, kernels,
                                                    over_background)
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

    t0 = time.perf_counter()
    v = Viewer(g, 1920, 1080, tile=32, max_dup=4, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(2):
        v.render(cam)
    torch.cuda.synchronize()
    frames = 5
    t1 = time.perf_counter()
    for _ in range(frames):
        img = v.render(cam)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / frames
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {**dict.fromkeys(launches, 0), "fused": 7, "sort": 7, "composite": k3_launches(7)}
    require(launches == want, f"config-1 path, 7 frames: launched {launches}, expected {want}")
    coverage = check_frame(img, "config 1")
    # The frame against the plain compositor on the frame's own sorted entries.
    m = v.models["model"]
    se = build_sorted_entries_fused(m.buffers.pod, v.comp, v.cfg, v._view, v._proj,
                                    m.transform.matrix())
    err = float((img - over_background(composite_tiles_plain_v2(se, v.cfg), v.background))
                .abs().max())
    require(err <= K67_TOL, f"config-1 frame vs the plain compositor: max abs {err}")
    del se
    rest = ms - sum(rec[k]["ms"] for k in ("fused", "sort", "composite"))
    log(f"phase 4 config 1: {g.count} splats at 1920x1080, SH 3, norm8/half, tile 32, "
        f"max_dup 4: {ms:.3f} ms/frame over {frames} frames ({rest:.3f} ms outside the three "
        f"kernels' phase-2 times), peak {peak:.2f} GiB, coverage {coverage:.3f}, launches "
        f"{launches}, against the plain compositor on its sorted entries max abs {err:.3e} "
        f"(<= {K67_TOL}), viewer set-up {setup:.1f} s [{smi}]")
    return launches, img


def config0_scene():
    """BASELINE config 0's scene: 50k random splats, camera at (0, 0, -6),
    drawn at 800x600 in point mode at SH degree 0."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    g = make_random_scene(50_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    return g, CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


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
    `v1_planes` and `composite_tiles` (K6). Phase 7 times it and
    scripts/profile_port_frame.py profiles it."""
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


def phase_compositors(g1, cam1, v2_img, device, smi: str, rec: dict) -> dict:
    """Phase 7: the v1 chain and the row-major v2 frame at config 1, K6, K2
    at the v1 key and K3 in the quadratic-basis form against their plain
    versions, flat mode on the config-0 shapes. Returns the launch counts of
    the two timed frames."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (
        N_PLANES, TileConfig, build_entry_planes, build_sorted_entries_fused, build_tile_lists,
        composite_tiles, composite_tiles_plain, composite_tiles_plain_v2, composite_tiles_v2,
        preprocess_fused, sort_entries, sort_entries_plain)
    from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import ROW, tile_list_entries
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_sorted

    w, h = 1920, 1080
    comp, pod = pod_tensors(g1, device)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    out = {}

    # The v1 frame at config 1.
    ms, img, peak, launches = timed_frames(v1_frame(pod, comp, cfg, cam1))
    for name in ("sort", "composite_v1"):
        require(launches[name] >= 1, f"kernel {name} never launched on the v1 path: {launches}")
    require(launches["composite"] == 0 and launches["fused"] == 0 and launches["overlay"] == 0,
            f"v1 path: {launches}")
    require(launches["preprocess"] == 7, f"v1 path, 7 frames: K8 {launches['preprocess']} times")
    coverage = check_frame(img, "v1 config 1")
    d = (img - v2_img).abs()
    out["composite_v1"] = launches
    rec_v1 = {"config1_v1_frame_ms": ms, "config1_v1_frame_peak_gib": peak,
              "config1_v1_vs_v2_frame_max": float(d.max()),
              "config1_v1_vs_v2_frame_mean": float(d.mean())}
    log(f"phase 7 v1 frame, config 1: preprocess (K8) -> build_tile_lists (K2) -> "
        f"build_entry_planes -> composite_tiles (K6): {ms:.3f} ms/frame over 5 frames, peak "
        f"{peak:.2f} GiB, coverage {coverage:.3f}, launches {launches}; against phase 4's "
        f"(quantized v2) frame max {float(d.max()):.4e}, mean {float(d.mean()):.4e} (reported, "
        f"not gated) [{smi}]")
    del img, d

    # The peak of each stage of that frame, over what is resident before it.
    view, proj = cam1.view(), cam1.projection(w / h)
    eye = np.eye(4, dtype=np.float32)
    stage_gib = {}

    def stage(name, run):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = run()
        torch.cuda.synchronize()
        stage_gib[name] = ((torch.cuda.max_memory_allocated() - before) / 2**30, before / 2**30)
        return result

    pre = stage("preprocess", lambda: preprocess_fused(pod, comp, view, proj, eye, w, h))
    # K2 at the v1 key layout, row for row against the stable plain sort.
    slots = tile_list_entries(pre, cfg)
    se1 = sort_entries(slots, cfg, shift=cfg.depth_bits)
    compare_sorted(se1, sort_entries_plain(slots, cfg, shift=cfg.depth_bits), stable=True)
    log(f"phase 7 K2 at the v1 key ({slots.shape[0]} slots, {se1.n_valid} live): row for row "
        f"equal to the stable plain sort")
    del slots, se1
    lists = stage("build_tile_lists", lambda: build_tile_lists(pre, cfg))
    planes = stage("build_entry_planes", lambda: build_entry_planes(pre, lists, cfg))
    got = stage("composite_tiles", lambda: composite_tiles(planes, cfg))
    rec_v1["config1_v1_stage_peak_gib"] = {k: v[0] for k, v in stage_gib.items()}
    log("phase 7 v1 frame memory, each stage's peak above what was resident before it: "
        + ", ".join(f"{k} +{v[0]:.3f} GiB (over {v[1]:.3f})" for k, v in stage_gib.items()))
    # Each stage's time alone, by CUDA events (host gaps included).
    stage_ms = {"preprocess": cuda_ms(lambda: preprocess_fused(pod, comp, view, proj, eye, w, h),
                                      5),
                "build_tile_lists": cuda_ms(lambda: build_tile_lists(pre, cfg), 3),
                "build_entry_planes": cuda_ms(lambda: build_entry_planes(pre, lists, cfg), 3),
                "composite_tiles": cuda_ms(lambda: composite_tiles(planes, cfg), 5)}
    del pre, lists
    rec_v1["config1_v1_stage_ms"] = stage_ms
    log("phase 7 v1 frame stages, each run alone (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" [{smi}]")

    # K6 against its plain version on that frame's EntryPlanes.
    work = {}
    err = float((got - composite_tiles_plain(planes, cfg, stats=work)).abs().max())
    require(err <= K67_TOL, f"K6 max abs {err} > {K67_TOL}")
    # Bytes: only the rows the tiles read before their exit (as the plain
    # version counts them), 36 B an entry, not all of EntryPlanes.
    b_ms, b_by = bound(work["rows"] * ROW * 4 * N_PLANES
                       + nbytes(planes.row_starts, planes.tile_counts, got),
                       K6_OPS_BLEND * work["pairs"])
    rec_v1.update({"max_abs_err": err, "ms": cuda_ms(lambda: composite_tiles(planes, cfg), 20),
                   "plain_ms": cuda_ms(lambda: composite_tiles_plain(planes, cfg), 1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "entry_planes_rows": planes.ent.shape[1], "rows_read": work["rows"],
                   "blends": work["pairs"]})
    log(f"phase 7 K6 v1 compositor, config 1 ({planes.ent.shape[1]} rows of 128 on 9 planes, "
        f"{work['rows']} read before the tiles' exits): max abs {err:.3e} (<= {K67_TOL}) vs "
        f"plain; kernel {rec_v1['ms']:.3f} ms, plain {rec_v1['plain_ms']:.3f} ms, "
        f"{work['pairs']} blends needed, bound {b_ms:.3f} ms ({b_by})")
    del planes, got

    # K6 at tiles over 32 px on the same scene's EntryPlanes, against plain.
    for tile in LARGE_TILES:
        cfg_t = TileConfig(w, h, tile=tile, max_dup=4)
        planes_t = v1_planes(pod, comp, cfg_t, cam1)
        got_t = composite_tiles(planes_t, cfg_t)
        work = {}
        plain_t, plain_ms = timed_once(lambda: composite_tiles_plain(planes_t, cfg_t, stats=work))
        err_t = float((got_t - plain_t).abs().max())
        require(err_t <= K67_TOL, f"K6 at tile {tile}: max abs {err_t} > {K67_TOL}")
        b_t, by_t = bound(work["rows"] * ROW * 4 * N_PLANES
                          + nbytes(planes_t.row_starts, planes_t.tile_counts, got_t),
                          K6_OPS_BLEND * work["pairs"])
        if tile <= 256:  # over 256 the stats run's own time (its counting included)
            plain_ms = cuda_ms(lambda: composite_tiles_plain(planes_t, cfg_t), 1)
        r = {"ms": cuda_ms(lambda: composite_tiles(planes_t, cfg_t), 20), "plain_ms": plain_ms,
             "bound_ms": b_t, "bound_by": by_t, "max_abs_err": err_t, "blends": work["pairs"]}
        rec_v1[f"tile{tile}"] = r
        rec_v1["max_abs_err"] = max(rec_v1["max_abs_err"], err_t)
        log(f"phase 7 K6 at tile {tile} ({cfg_t.n_tiles} tiles, {work['rows']} rows read): max "
            f"abs {err_t:.3e} (<= {K67_TOL}) vs plain; kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, {work['pairs']} blends needed, bound {b_t:.3f} ms ({by_t})")
        del planes_t, got_t, plain_t

    # K3 on phase 4's sorted entries (K1 -> K2 at config 1) in the
    # quadratic-basis form against plain, for both `transposed` values, and
    # against the Horner form on the card.
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, eye)
    horner = composite_tiles_v2(se, cfg)
    work = {}
    ref = composite_tiles_plain_v2(se, cfg, stats=work, mxu=True)
    basis = composite_tiles_v2(se, cfg, transposed=False, mxu=True)
    err = float((basis - ref).abs().max())
    require(err <= K67_TOL, f"K3 (quadratic basis) max abs {err} > {K67_TOL}")
    require(torch.equal(basis, composite_tiles_v2(se, cfg, transposed=True, mxu=True)),
            "K3 (quadratic basis): transposed=True differs from transposed=False")
    form = float((basis - horner).abs().max())
    bm_ms, bm_by = bound(work["rows"] * ROW * 16 + nbytes(se.tile_starts, se.tile_counts, basis),
                         K3_MXU_OPS_BLEND * work["pairs"])
    rec3 = rec["composite"]
    rec3["max_abs_err"] = max(rec3["max_abs_err"], err)
    rec3.update({"mxu_ms": cuda_ms(lambda: composite_tiles_v2(se, cfg, mxu=True), 20),
                 "mxu_plain_ms": cuda_ms(lambda: composite_tiles_plain_v2(se, cfg, mxu=True), 1),
                 "mxu_bound_ms": bm_ms, "mxu_max_abs_err": err, "mxu_vs_horner_max": form})
    log(f"phase 7 K3 quadratic-basis form on phase 4's sorted entries ({se.n_valid} live): max "
        f"abs {err:.3e} (<= {K67_TOL}) vs plain, transposed False and True equal; basis vs "
        f"Horner on the card {form:.3e}; kernel {rec3['mxu_ms']:.3f} ms (Horner "
        f"{rec3['ms']:.3f} ms in phase 2), plain {rec3['mxu_plain_ms']:.3f} ms; {work['pairs']} "
        f"blends needed, bound {bm_ms:.3f} ms ({bm_by})")
    del se, horner, ref, basis

    # The row-major frame at config 1 (the mxu mode's path).
    ms, img, peak, launches = timed_frames(rows_frame(pod, comp, cfg, cam1))
    want = {**dict.fromkeys(launches, 0), "fused": 7, "sort": 7, "composite": k3_launches(7)}
    require(launches == want, f"row-major path, 7 frames: launched {launches}, expected {want}")
    coverage = check_frame(img, "row-major config 1")
    d = (img - v2_img).abs()
    out["rows"] = launches
    rec3.update({"config1_rows_frame_ms": ms, "config1_rows_frame_peak_gib": peak,
                 "config1_rows_vs_v2_frame_max": float(d.max()),
                 "config1_rows_vs_v2_frame_mean": float(d.mean())})
    log(f"phase 7 row-major frame, config 1: K1 -> K2 -> composite_tiles_v2(transposed=False, "
        f"mxu=True) (K3, basis): {ms:.3f} ms/frame over 5 frames, peak {peak:.2f} GiB, coverage "
        f"{coverage:.3f}, launches {launches}; against phase 4's frame (K3, Horner) max "
        f"{float(d.max()):.4e}, mean {float(d.mean()):.4e} (reported; the kernels are gated "
        f"above) [{smi}]")
    del img, d, pod

    # Flat mode on the config-0 shapes: K6 and K3 (both `transposed`) against plain.
    g0, cam0 = config0_scene()
    comp0, pod0 = pod_tensors(g0, device)
    cfg0 = TileConfig(800, 600, tile=32, max_dup=4)
    planes0 = v1_planes(pod0, comp0, cfg0, cam0, sh_degree=0, display_mode=2)
    got = composite_tiles(planes0, cfg0, flat_mode=True)
    err6 = float((got - composite_tiles_plain(planes0, cfg0, flat_mode=True)).abs().max())
    cov6 = float((got[..., 3] > 1.0 / 255.0).float().mean())
    se0 = build_sorted_entries_fused(pod0, comp0, cfg0, cam0.view(), cam0.projection(800 / 600),
                                     eye, sh_degree=0, display_mode=2)
    ref = composite_tiles_plain_v2(se0, cfg0, flat_mode=True)
    err3 = max(float((composite_tiles_v2(se0, cfg0, flat_mode=True, transposed=tr, mxu=tr)
                      - ref).abs().max()) for tr in (False, True))
    require(err6 <= K67_TOL and err3 <= K67_TOL, f"flat config 0: K6 {err6}, K3 {err3}")
    require(cov6 > 0.01, f"config 0 point frame covers {cov6}")
    rec_v1["max_abs_err"] = max(rec_v1["max_abs_err"], err6)
    rec_v1["config0_flat_max_abs_err"] = err6
    rec_v1["config0_flat_ms"] = cuda_ms(lambda: composite_tiles(planes0, cfg0, flat_mode=True), 20)
    rec3["max_abs_err"] = max(rec3["max_abs_err"], err3)
    rec3["config0_flat_max_abs_err"] = err3
    rec3["config0_flat_ms"] = cuda_ms(lambda: composite_tiles_v2(se0, cfg0, flat_mode=True), 20)
    log(f"phase 7 flat mode, config-0 shapes ({g0.count} splats, 800x600, point, SH 0; "
        f"{se0.n_valid} live entries, coverage {cov6:.3f}): K6 max abs {err6:.3e}, "
        f"{rec_v1['config0_flat_ms']:.4f} ms; K3 max abs {err3:.3e} (transposed False and True, "
        f"mxu ignored in flat mode), {rec3['config0_flat_ms']:.4f} ms (<= {K67_TOL} vs plain)")
    rec["composite_v1"] = rec_v1
    return out


def config3_pods():
    """Config 3's selection edit and highlight, as bench.py's config 3 sets them."""
    from wgpu_3dgs_viewer_app_tpu_torch.core.edit import (EDIT_FLAG_ENABLED, GaussianEditPod,
                                                          SelectionHighlightPod)

    return (GaussianEditPod(EDIT_FLAG_ENABLED, (0.15, 1.2, 1.0), 0.1, 0.2, 1.0, 1.0),
            SelectionHighlightPod((1.0, 0.0, 1.0, 0.4)))


def config3_step(v):
    """The config-3 step on a single-model viewer whose camera is set: query
    geometry (K4) -> select_rect -> set_selection -> selection edit and
    highlight -> Viewer.render. Returns step() -> (frame, geometry, bits);
    phase 5 times it and scripts/profile_port_frame.py profiles it."""
    from wgpu_3dgs_viewer_app_tpu_torch.ops import preprocess_geometry_fused
    from wgpu_3dgs_viewer_app_tpu_torch.query import select_rect

    m = v.models["model"]
    sel_edit, highlight = config3_pods()

    def step():
        pre = preprocess_geometry_fused(m.buffers.pod, v.comp, v._view, v._proj,
                                        m.transform.matrix(), v.cfg.width, v.cfg.height,
                                        display_mode=0)
        bits = select_rect(pre, *CONFIG3_RECT)
        m.buffers.set_selection(bits)
        v.update_selection_edit(sel_edit)
        v.update_selection_highlight(highlight, True)
        return v.render(), pre, bits

    return step


def phase_config3(g, cam, device, smi: str, rec: dict) -> dict:
    """Phase 5: BASELINE config 3, selection and editing, through the
    entry points a user calls."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import (build_sorted_entries_fused, composite_tiles_v2,
                                                    enumerate_entries_fused,
                                                    enumerate_entries_plain, kernels,
                                                    over_background, preprocess_geometry_fused)
    from wgpu_3dgs_viewer_app_tpu_torch.query import (
        MeasurementHitMethod, QuerySelectionOp, QueryToolset, apply_query_pod, combine_selection,
        query_hit, sample_texture_at_centers, select_rect)
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

    w, h = 1920, 1080
    t0 = time.perf_counter()
    v = Viewer(g, w, h, tile=32, max_dup=4, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    m = v.models["model"]
    b = m.buffers
    v.update_camera(cam)
    sel_edit, highlight = config3_pods()
    step = config3_step(v)

    def geometry(**kw):
        return preprocess_geometry_fused(b.pod, v.comp, v._view, v._proj, m.transform.matrix(),
                                         w, h, display_mode=0, **kw)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    frames = 5
    t1 = time.perf_counter()
    for _ in range(frames):
        img, pre, bits = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / frames
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("geometry", "fused", "sort", "composite"):
        require(launches[name] >= 1, f"kernel {name} never launched on the config-3 path: "
                                     f"{launches}")
    require(launches["overlay"] == 0, f"the config-3 step drew overlays: {launches}")
    coverage = check_frame(img, "config 3")
    selected = int(bits.sum())
    require(0 < selected < g.count, f"{selected} splats selected")

    # Gated K1 against its plain version on the timed step's own inputs and
    # gates (selection bits, selection edit, highlight), and the K1 and K4
    # times at these shapes.
    gt = v.gaussian_transform
    fe_args = (b.pod, v.comp, v.cfg, v._view, v._proj, m.transform.matrix())
    fe_kw = dict(sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0, size=gt.size,
                 display_mode=int(gt.display_mode), **v._gating_kwargs(m, False))
    require(fe_kw.keys() >= {"selection_bits", "selection_edit", "highlight_rgba"},
            f"the step's gates: {sorted(fe_kw)}")
    st1 = compare_entries(enumerate_entries_fused(*fe_args, **fe_kw),
                          enumerate_entries_plain(*fe_args, **fe_kw), v.cfg)
    k1_ms = cuda_ms(lambda: enumerate_entries_fused(*fe_args, **fe_kw), 20)
    k4_ms = cuda_ms(geometry, 20)
    rec["fused"]["max_abs_err"] = max(rec["fused"]["max_abs_err"], st1["max_field_step"])
    rec["fused"]["config3_gated_ms"] = k1_ms
    rec["geometry"]["config3_ms"] = k4_ms
    log(f"phase 5 gated K1 on the step's gates: {st1['live_a']} live entries, "
        f"{st1['identical']:.6f} identical to plain, {st1['differing']} within one step; "
        f"K1 {k1_ms:.3f} ms, K4 {k4_ms:.3f} ms at 2M splats [{smi}]")

    # The ungated frame: the same front-end, sort and compositor, no gates.
    def ungated():
        se = build_sorted_entries_fused(b.pod, v.comp, v.cfg, v._view, v._proj,
                                        m.transform.matrix())
        return over_background(composite_tiles_v2(se, v.cfg), v.background)

    plain = ungated()
    (x0, y0), (x1, y1) = CONFIG3_RECT
    far = torch.ones((h, w), dtype=torch.bool, device=img.device)
    far[int(y0) - 100:int(y1) + 100, int(x0) - 100:int(x1) + 100] = False
    require(torch.equal(img[far], plain[far]), "the selection edit changed pixels far outside "
                                               "the selected rect")
    inside = (img - plain)[int(y0) + 50:int(y1) - 50, int(x0) + 50:int(x1) - 50].abs().mean()
    require(float(inside) > 0.02, f"the selection edit barely changed the rect: {float(inside)}")
    log(f"phase 5 config 3: {g.count} splats at 1920x1080, SH 3, norm8/half, tile 32, "
        f"max_dup 4; step = K4 geometry -> select_rect{CONFIG3_RECT} -> set_selection -> "
        f"selection edit + highlight -> Viewer.render: {ms:.3f} ms/frame over {frames} frames "
        f"(K4 {k4_ms:.3f} ms and gated K1 {k1_ms:.3f} ms of it), {selected} splats selected, "
        f"peak {peak:.2f} GiB, coverage {coverage:.3f}, launches {launches}, viewer set-up "
        f"{setup:.1f} s; pixels 100 px outside the rect equal to the ungated frame, mean change "
        f"inside {float(inside):.4f} [{smi}]")

    # Brush stroke, ADD: immediate mode, pods applied to the selection.
    ts = QueryToolset(w, h, device=device)
    ts.update_brush_radius(30.0)
    ts.start(QueryToolset.BRUSH, QuerySelectionOp.ADD, (200.0, 900.0))
    ts.update_pos((1700.0, 950.0))
    ts.end()
    sel = b.selection
    for pod in ts.query():
        sel = apply_query_pod(pre, sel, pod)
    added = int(sel.sum()) - selected
    require(added > 0 and bool((sel >= b.selection).all()), f"brush ADD added {added}")
    b.set_selection(sel)

    # Texture mode: a rect painted into the query texture, resolved at end().
    ts.set_use_texture(True)
    ts.start(QueryToolset.RECT, QuerySelectionOp.ADD, (1400.0, 300.0))
    ts.update_pos((1650.0, 800.0))
    op, tex = ts.end()
    tex_bits = sample_texture_at_centers(pre, tex)
    rect_bits = select_rect(pre, (1400.0, 300.0), (1650.0, 800.0))
    mismatch = int((tex_bits != rect_bits).sum())
    require(int(tex_bits.sum()) > 0 and mismatch <= 0.01 * int(rect_bits.sum()),
            f"texture resolve: {int(tex_bits.sum())} vs {int(rect_bits.sum())} by rect")
    b.set_selection(combine_selection(b.selection, tex_bits, op))
    n_sel = int(b.selection.sum())

    # Commit: per-splat edits equal the live selection edit, bit for bit.
    live = v.render()
    b.commit_selection_edit(*sel_edit.as_arrays())
    v.update_selection_edit(None)
    committed = v.render()
    require(torch.equal(live, committed), "committed edits render unlike the live selection edit")

    # show_unedited without highlight or mask: the ungated frame.
    v.update_selection_highlight(highlight, False)
    unedited = v.render(show_unedited=True)
    require(torch.equal(unedited, ungated()), "show_unedited differs from the ungated frame")
    edited = v.render()
    require(not torch.equal(unedited, edited), "the committed edits change nothing")

    # Half the splats masked.
    b.set_mask((np.arange(g.count) % 2).astype(np.uint8))
    masked = v.render()
    cov_masked = check_frame(masked, "masked", min_coverage=0.1)
    require(not torch.equal(masked, edited), "the mask changed nothing")
    kernels.reset_launch_counts()
    masked_pre = geometry(mask_bits=b.mask, edit=(b.edit_flags, b.edit_rgb, b.edit_params))
    require(kernels.LAUNCHES["geometry"] == 1, "gated K4 did not launch")
    n_valid, n_all = int(masked_pre.valid.sum()), int(pre.valid.sum())
    require(abs(n_valid - n_all / 2) <= 0.01 * n_all, f"{n_valid} of {n_all} valid, half masked")

    # Hit queries at the centre, both methods, against the same query on the CPU.
    hits = []
    for method in MeasurementHitMethod:
        found, pos = query_hit(masked_pre, (w / 2, h / 2), v._view, v._proj, w, h, method)
        cpu_pre = type(masked_pre)(**{f: getattr(masked_pre, f).cpu()
                                      for f in masked_pre.__dataclass_fields__})
        found_c, pos_c = query_hit(cpu_pre, (w / 2, h / 2), v._view, v._proj, w, h, method)
        require(bool(found) == bool(found_c), f"{method}: found differs from the CPU")
        require(bool(found), f"{method}: no hit at the centre of a dense scene")
        d = float((pos.cpu() - pos_c).abs().max())
        require(d <= 1e-4, f"{method}: position differs from the CPU by {d}")
        hits.append(f"{method.value} {pos.cpu().numpy().round(4).tolist()}")
    log(f"phase 5 checks: brush ADD +{added} splats; texture resolve {int(tex_bits.sum())} "
        f"(select_rect {int(rect_bits.sum())}, {mismatch} differ); selection now {n_sel}; "
        f"committed edits == live selection edit; show_unedited == ungated; half masked: "
        f"coverage {cov_masked:.3f}, {n_valid} valid in gated K4; hits at the centre: "
        f"{'; '.join(hits)}")
    return launches


def timed_frames(frame, warmups: int = 2, frames: int = 5) -> tuple:
    """(ms per frame by the host clock closed by a synchronise, the last
    image, peak GiB, the launch counts of all warm-up and timed frames)."""
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(warmups):
        frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        img = frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / frames
    return ms, img, torch.cuda.max_memory_allocated() / 2**30, dict(kernels.LAUNCHES)


def to_u8(img):
    import numpy as np

    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8).astype(np.int16)


def phase_config2(models: list, device, smi: str, rec: dict) -> dict:
    """Phase 6: BASELINE config 2, three models merged into one frame, on
    the fused and on the staged front-end route. Returns the launch counts
    of the two timed runs."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden import assert_golden_close

    from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions, Cov3dCompression, ShCompression
    from wgpu_3dgs_viewer_app_tpu_torch.data.compression import cov3d_components
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (composite_tiles_plain_v2, composite_tiles_v2,
                                                    kernels, over_background, preprocess,
                                                    preprocess_fused, sort_entries,
                                                    sort_entries_plain)
    from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import ROW
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_sorted

    w, h = CONFIG2_SIZE
    n_models = len(models)
    t0 = time.perf_counter()
    v = config2_viewer(models, device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    order = v.model_order()
    require(len(order) == n_models, f"visible models: {order}")
    cfg_m = v.merged_config(n_models)
    require(cfg_m.model_bits == 2, f"model_bits {cfg_m.model_bits} for {n_models} models")

    # Both routes: timed frames, the launch counts of one frame, coverage.
    images, out = {}, {}
    for route, fused in (("fused", True), ("staged", False)):
        frame = config2_frame(v, fused)
        ms, img, peak, launches = timed_frames(frame)
        kernels.reset_launch_counts()
        frame()
        one = dict(kernels.LAUNCHES)
        front = {"fused": n_models} if fused else {"preprocess": n_models, "enum_pack": n_models}
        want = {**dict.fromkeys(kernels.LAUNCHES, 0), "sort": 1, "composite": k3_launches(),
                **front}
        require(one == want, f"config 2 {route}: one frame launched {one}, expected {want}")
        coverage = check_frame(img, f"config 2 {route}", size=CONFIG2_SIZE)
        images[route], out[route] = img, launches
        extra = ""
        if not fused:
            def pre_all(fn):
                gt = v.gaussian_transform
                for key in order:
                    m = v.models[key]
                    fn(m.buffers.pod, v.comp, v._view, v._proj, m.transform.matrix(), w, h,
                       sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0, size=gt.size,
                       display_mode=int(gt.display_mode), **v._gating_kwargs(m, False))
            pre_ms = cuda_ms(lambda: pre_all(preprocess_fused), 5)
            plain_ms = cuda_ms(lambda: pre_all(preprocess), 3)
            rec["preprocess"]["config2_three_models_ms"] = pre_ms
            rec["enum_pack"]["config2_preprocess_plain_ms"] = plain_ms
            rec["preprocess"]["config2_staged_frame_ms"] = ms
            extra = (f"; K8 on the three models, run alone, takes {pre_ms:.3f} ms "
                     f"({pre_ms / ms:.2f} of the frame), the plain preprocess {plain_ms:.3f} ms")
        rec["fused" if fused else "enum_pack"][f"config2_{route}_frame_ms"] = ms
        log(f"phase 6 config 2, {route} route: {n_models} x {models[0].count} splats at {w}x{h}, "
            f"SH 3, norm8/half, tile 32, max_dup 4, per-splat edits: {ms:.3f} ms/frame over 5 "
            f"frames{extra}, peak {peak:.2f} GiB, coverage {coverage:.3f}, launches of one frame "
            f"{one}, of the 7 frames {launches} [{smi}]")

    # The sorted merged entries (K2 under the merged config): per tile the
    # ranks ascend and, within a rank, the depth keys ascend; the tile
    # ranges cover exactly their tile's entries.
    v.fused = True
    entries, cfg_chk = v.merged_entries(order)
    require(cfg_chk == cfg_m and entries.shape[0] == 3 * models[0].count * cfg_m.max_dup,
            f"merged entries {tuple(entries.shape)} under {cfg_chk}")
    se = sort_entries(entries, cfg_m)
    # K2 against its plain version at this shape, row for row: whole keys
    # (rank and alpha byte included) and payloads, ties in slot order, equal
    # tile ranges.
    compare_sorted(se, sort_entries_plain(entries, cfg_m), stable=True)
    rec["sort"]["config2_merged_max_abs_err"] = 0
    keys = se.live()[:, 0].to(torch.int64) & 0xFFFFFFFF
    tile = keys >> cfg_m._tile_shift
    rank = (keys >> cfg_m._rank_shift) & ((1 << cfg_m.model_bits) - 1)
    depth = (keys >> 8) & ((1 << cfg_m.v2_depth_bits) - 1)
    same_tile = tile[1:] == tile[:-1]
    same_rank = same_tile & (rank[1:] == rank[:-1])
    require(bool((tile[1:] >= tile[:-1]).all()), "sorted merged entries: tiles not ascending")
    require(bool((rank[1:] >= rank[:-1])[same_tile].all()), "ranks not ascending inside a tile")
    require(bool((depth[1:] >= depth[:-1])[same_rank].all()), "depth keys not ascending in a rank")
    owner = torch.repeat_interleave(torch.arange(cfg_m.n_tiles, device=keys.device),
                                    se.tile_counts.to(torch.int64))
    require(owner.shape[0] == se.n_valid and bool((owner == tile).all()),
            "tile ranges do not match the keys' tile field")
    per_rank = torch.bincount(rank, minlength=n_models).tolist()
    require(all(c > 0 for c in per_rank[:n_models]), f"entries per rank {per_rank}")
    # K3 under the merged config against its plain version, and its bound
    # on these entries.
    img_k = composite_tiles_v2(se, cfg_m)
    work = {}
    err = float((img_k - composite_tiles_plain_v2(se, cfg_m, stats=work)).abs().max())
    require(err <= K67_TOL, f"K3 on the merged entries: max abs {err} > {K67_TOL}")
    b2_ms, b2_by = bound(work["rows"] * ROW * 16 + nbytes(se.tile_starts, se.tile_counts, img_k),
                         K3_OPS_BLEND * work["pairs"])
    rec["composite"]["max_abs_err"] = max(rec["composite"]["max_abs_err"], err)
    rec["composite"].update({"config2_ms": cuda_ms(lambda: composite_tiles_v2(se, cfg_m), 20),
                             "config2_bound_ms": b2_ms, "config2_blends": work["pairs"]})
    log(f"phase 6 merged entries: {entries.shape[0]} slots, {se.n_valid} live, per rank "
        f"{per_rank[:n_models]}; K2 vs plain on them: row for row equal; in K2's output tiles "
        f"ascend, ranks ascend per tile, depth keys ascend per rank, tile ranges match; K3 vs "
        f"plain on them max abs {err:.3e} (<= {K67_TOL}), {rec['composite']['config2_ms']:.3f} "
        f"ms, {work['pairs']} blends needed, bound {b2_ms:.3f} ms ({b2_by})")
    del entries, se, keys, tile, rank, depth, owner, same_tile, same_rank, img_k

    # Merged = the per-model frames blended back to front with "over".
    def sequential(render):
        acc = None
        for key in order:
            img = render(key)
            acc = img if acc is None else img + (1.0 - img[..., 3:4]) * acc
        return over_background(acc, v.background)

    merged = images["fused"]
    d_layout = (merged - sequential(
        lambda k: v._composite(v._model_entries(k, cfg_m, 0, False), cfg_m))).abs()
    d_model = (merged - sequential(v.render_model)).abs()
    over = int((d_model.amax(dim=-1) >= 3e-2).sum())
    log(f"phase 6 merged vs sequential blend: against render_model ({v.cfg.v2_depth_bits} depth "
        f"bits against the merged key's {cfg_m.v2_depth_bits}) max {float(d_model.max()):.4e}, "
        f"mean {float(d_model.mean()):.4e}, {over} pixels at or over 3e-2; against the models "
        f"drawn alone under the merged key layout max {float(d_layout.max()):.4e}, mean "
        f"{float(d_layout.mean()):.4e}")
    # Alone, a model's batches end where its own transmittance falls under
    # 1/255; merged, where the product of all nearer models' does: each of
    # the four images may lack up to 1/255.
    require(float(d_layout.max()) <= (n_models + 1) * EXIT_TOL,
            "merged frame differs from the blend of its models under the same key layout")
    # Against `render_model` the difference is the two depth bits the rank
    # takes (splats that tie in depth blend in alpha order), not the merge.
    # Report only: the gate on the merge is the same-layout check above. The
    # small test scenes meet max 3e-2 / mean 1e-4; a scene dense in depth
    # misses them by the same amount in the JAX package and in the port
    # (tests/test_torch_multimodel.py, the dense-scene test).
    meets = float(d_model.max()) < 3e-2 and float(d_model.mean()) < 1e-4
    log(f"phase 6 merged vs render_model blend {'meets' if meets else 'does not meet'} max 3e-2 "
        f"/ mean 1e-4 (reported, not gated)")
    rec["composite"]["config2_merged_vs_same_layout_max"] = float(d_layout.max())
    rec["composite"]["config2_merged_vs_render_model_max"] = float(d_model.max())
    rec["composite"]["config2_merged_vs_render_model_mean"] = float(d_model.mean())

    # Route against route, under the golden gate.
    assert_golden_close(to_u8(images["staged"]), to_u8(merged))
    d_route = (images["staged"] - merged).abs()
    log(f"phase 6 fused vs staged route: max {float(d_route.max()):.4e}, mean "
        f"{float(d_route.mean()):.4e} -> assert_golden_close passed")

    # Hidden model, order flip, resize, compression change.
    v.models["m1"].visible = False
    two = v.render()
    require(v.merged_config(len(v.model_order())).model_bits == 1, "two models need one rank bit")
    require(float((two - merged).abs().max()) > 0.05, "hiding the middle model changed nothing")
    v.models["m1"].visible = True
    far = order[0]
    moved_to = dataclasses.replace(v.models[far].transform, pos=np.float32([0.0, 0.0, -3.0]))
    old_transform = v.models[far].transform
    v.update_model_transform(far, moved_to)
    flipped = v.model_order()
    require(flipped[-1] == far and flipped != order, f"order {order} -> {flipped}")
    ent, _ = v.merged_entries(flipped)
    rows = models[0].count * cfg_m.max_dup
    k_far = ent[flipped.index(far) * rows:(flipped.index(far) + 1) * rows, 0].to(torch.int64)
    k_far = k_far[k_far != -1] & 0xFFFFFFFF
    require(k_far.numel() > 0 and bool(((k_far >> cfg_m._rank_shift) & 3 == 0).all()),
            "the model moved to the front does not carry rank 0")
    del ent, k_far
    require(float((v.render() - merged).abs().max()) > 0.05, "the order flip changed nothing")
    v.update_model_transform(far, old_transform)
    require(v.model_order() == order, "the order did not flip back")

    v.resize(1280, 720)
    v.update_camera(config2_camera())
    small = v.render()
    cov_small = check_frame(small, "config 2 at 1280x720", size=(1280, 720))
    v.resize(w, h)
    v.update_camera(config2_camera())

    # Compression changes: the pods are packed again, the edits stay, and
    # pods and frame equal, bit for bit, those of a viewer built at that
    # compression. Half SH with the covariance still in f16 also stays within
    # the golden gate of the first frame. An f32 covariance does not have to:
    # the f16 decoder reads subnormals as 0, so a covariance term under
    # 6.1e-5 (a splat thinner than 0.0078 along an axis; this scene's scales
    # start at 0.004) is 0 in the default pod and real in that one. Those
    # terms are counted, and the frame's difference is reported.
    flags_before = [v.models[k].buffers.edit_flags for k in order]
    cov_half = [cov3d_components(v.models[k].buffers.pod) for k in order]
    diffs = []
    for comp in (Compressions(ShCompression.HALF, Cov3dCompression.HALF),
                 Compressions(ShCompression.HALF, Cov3dCompression.SINGLE)):
        v.set_compressions(comp)
        require(v.comp == comp and all(v.models[k].buffers.comp == comp for k in order),
                f"set_compressions left {v.comp}")
        require(all(v.models[k].buffers.edit_flags is f for k, f in zip(order, flags_before)),
                "set_compressions dropped the edits")
        repacked = v.render()
        check_frame(repacked, f"config 2 as {comp}", size=CONFIG2_SIZE)
        require(not torch.equal(repacked, v.render(show_unedited=True)),
                "after set_compressions the edits change nothing")
        fresh = config2_viewer(models, device, comp=comp)
        require(all(torch.equal(t, fresh.models[k].buffers.pod[name]) for k in order
                    for name, t in v.models[k].buffers.pod.items()),
                f"set_compressions to {comp}: a pod differs from a fresh viewer's")
        require(torch.equal(repacked, fresh.render()),
                f"set_compressions to {comp}: the frame differs from a fresh viewer's")
        del fresh
        d_comp = (repacked - merged).abs()
        diffs.append(f"({comp.sh.value}, {comp.cov3d.value}) max {float(d_comp.max()):.4e}, mean "
                     f"{float(d_comp.mean()):.4e}")
        log(f"phase 6 set_compressions {diffs[-1]} against the first frame; pods and frame "
            f"bit-equal to a viewer built at that compression")
        if comp.cov3d == Cov3dCompression.HALF:
            assert_golden_close(to_u8(repacked), to_u8(merged))
            require(float(d_comp.mean()) < 1.0 / 255.0, "half SH drifted from the norm8 frame")
        else:
            terms = splats = 0
            for k, half in zip(order, cov_half):
                gone = torch.stack([(h == 0) & (f != 0) for h, f in
                                    zip(half, cov3d_components(v.models[k].buffers.pod))])
                terms += int(gone.sum())
                splats += int(gone[[0, 3, 5]].any(dim=0).sum())  # xx, yy or zz
            require(terms > 0, "no covariance term is flushed in the f16 pod")
            flushed = (f"{terms} of {6 * sum(g.count for g in models)} covariance terms are 0 in "
                       f"the f16 pod and not in the f32 pod, {splats} splats lose a diagonal term")
            log(f"phase 6 f16 against f32 covariance: {flushed}")
    del cov_half
    log(f"phase 6 checks: middle model hidden -> 1 rank bit, frame changed; {far} moved to the "
        f"front -> order {flipped}, rank 0, frame changed; resize to 1280x720 renders (coverage "
        f"{cov_small:.3f}); set_compressions keeps the edits and renders what a fresh viewer "
        f"renders: {'; '.join(diffs)} (the first within the golden gate; {flushed}); viewer "
        f"set-up {setup:.1f} s")
    return out


class _HeadWriter:
    """A writer that keeps the first bytes written and counts the rest."""

    def __init__(self, keep: int = 1 << 16):
        self.head, self.keep, self.size = bytearray(), keep, 0

    def write(self, b) -> int:
        n = len(b)
        if len(self.head) < self.keep:
            self.head += bytes(memoryview(b)[: self.keep - len(self.head)])
        self.size += n
        return n


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
    require(busy > 0, "the profiler saw device events but no device time")
    return walls[-1], busy, sorted(rows, key=lambda r: -r[1])


def bits_equal(a, b) -> bool:
    """Two f32 tensors equal bit for bit."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def random_segments(m: int, w: int, h: int, seed: int) -> tuple:
    """m segments at most 256 px long over a w x h frame, widths 0-8, among
    them a dead, a transparent, an off-screen, a NaN-ended, an inf-ended and
    a zero-length one, as `rasterize_lines` takes them (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = (rng.random((m, 2)) * [w * 1.2, h * 1.2] - [w * 0.1, h * 0.1]).astype(np.float32)
    ang, length = rng.random(m) * 2 * np.pi, rng.random(m) * 256.0
    b = (a + np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]).astype(np.float32)
    col = rng.random((m, 4)).astype(np.float32)
    col[::5, 3] = 1.0
    lw = (rng.random(m) * 8.0).astype(np.float32)
    live = np.ones(m, bool)
    live[0], col[1, 3] = False, 0.0
    a[2], b[2] = (-300.0, -300.0), (-280.0, -290.0)
    a[3, 0], b[4, 1] = np.nan, np.inf
    b[5], lw[6] = a[5], 0.0
    return a, b, col, lw, live


def k9_bound(img, table, texture=None, ring: bool = False) -> tuple:
    """K9's bound: the image read and written once, the segment table and
    the texture read once; operations per (pixel, segment) pair inside the
    segments' boxes and per pixel for the tint and the ring."""
    from wgpu_3dgs_viewer_app_tpu_torch.core.lines import box_sizes

    px = img.shape[0] * img.shape[1]
    ops = int(box_sizes(table).sum()) * K9_OPS_PAIR + px * (
        (K9_OPS_TINT if texture is not None else 0) + (K9_OPS_RING if ring else 0))
    return bound(2 * nbytes(img) + table.nbytes + nbytes(texture), ops)


def overlay_checks(s, img, smi: str) -> dict:
    """Phase 8, continued: K9 against the plain overlays run on the card,
    bit for bit, on the session's frame `img` at config 4: the frame's own
    segments (the gizmos of the three shapes and the measurement line)
    through `render_overlays`; the same with the rect gesture's texture tint
    (texture mode) and a brush ring; K9_RANDOM_SEGMENTS random segments; one
    segment and none. K9 timed three ways (`wrapper_times`) with its plain
    version, bound and ptxas report. Returns K9's record."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.app import Action, SelectionMethod
    from wgpu_3dgs_viewer_app_tpu_torch.app.measurement import measurement_lines
    from wgpu_3dgs_viewer_app_tpu_torch.core.lines import rasterize_lines_plain, segment_table
    from wgpu_3dgs_viewer_app_tpu_torch.mask.gizmo import gizmo_lines
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels, overlay_cuda
    from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset
    from wgpu_3dgs_viewer_app_tpu_torch.query.overlay import (overlay_cursor_ring_plain,
                                                              overlay_texture_plain)

    h, w = img.shape[:2]
    view, proj = s.viewer._view, s.viewer._proj

    def host_segments():
        """What `render_overlays` does on the host before K9: the gizmos'
        and the measurement's segments, projected, and their table."""
        parts = (gizmo_lines(s.mask.shapes, view, proj, w, h),
                 measurement_lines(s.measurement, view, proj, w, h))
        lines = tuple(np.concatenate(f) for f in zip(*parts))
        return lines, segment_table(*lines, w, h)

    lines, table = host_segments()
    t0 = time.perf_counter()
    for _ in range(20):
        host_segments()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    require(len(table) == len(lines[0]) == 121, f"config 4 keeps {len(table)} of "
                                                 f"{len(lines[0])} overlay segments, not 121")

    def one_launch(draw):
        kernels.reset_launch_counts()
        out = draw()
        got = dict(kernels.LAUNCHES)
        require(got == {**dict.fromkeys(got, 0), "overlay": 1}, f"overlays launched {got}")
        return out

    # 1. The frame's own overlays, as update() draws them.
    got = one_launch(lambda: s.render_overlays(img))
    want = rasterize_lines_plain(img, *lines)
    require(bits_equal(got, want), "K9 != the plain lines on the config-4 frame")
    drawn = int(((got - img).abs().amax(dim=-1) > 0).sum())
    t = wrapper_times(lambda: overlay_cuda(img, table), "overlay_kernel")
    b_ms, b_by = k9_bound(img, table)
    rec = {"max_abs_err": float((got - want).abs().max()), **t,
           "plain_ms": cuda_ms(lambda: rasterize_lines_plain(img, *lines), 5), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "segments": len(table), "pixels_drawn": drawn,
           "host_segments_ms": host_ms}
    log(f"phase 8 K9 overlays, config-4 frame ({w}x{h}, {len(table)} segments: gizmos + the "
        f"measurement line, {drawn} pixels drawn): one launch through render_overlays, bit for "
        f"bit the plain lines; kernel {t['ms']:.4f} ms by events around the wrapper "
        f"({fmt_ms(t['device_ms'])} device only, {t['host_ms']:.4f} host to issue), plain "
        f"{rec['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); the host's segment build "
        f"before it (gizmo_lines, measurement_lines, segment_table) {host_ms:.3f} ms [{smi}]")

    # 2. With the rect gesture's tint (texture mode) and the brush ring at
    # its end, through the session; the gesture is then dropped.
    method = s.selection.method
    s.action, s.selection.method = Action.SELECTION, SelectionMethod.BRUSH
    s.toolset.set_use_texture(True)
    s.toolset.start(QueryToolset.RECT, QuerySelectionOp.SET, CONFIG3_RECT[0])
    s.toolset.update_pos(CONFIG3_RECT[1])
    tex, center = s.toolset.texture, np.asarray(s.toolset._last_pos, np.float32)
    radius = float(s.selection.brush_radius)
    got = one_launch(lambda: s.render_overlays(img))

    def plain_all():
        out = overlay_texture_plain(rasterize_lines_plain(img, *lines), tex)
        return overlay_cursor_ring_plain(out, center, radius)

    require(bits_equal(got, plain_all()), "K9 != the plain lines, tint and ring at config 4")
    t_all = wrapper_times(lambda: overlay_cuda(img, table, tex, cursor=(center, radius)),
                          "overlay_kernel")
    b_all, _ = k9_bound(img, table, tex, True)
    rec.update({f"all_stages_{k}": v for k, v in t_all.items()})
    rec.update(all_stages_plain_ms=cuda_ms(plain_all, 5), all_stages_bound_ms=b_all)
    s.toolset.end()
    s.toolset.set_use_texture(False)
    s.action, s.selection.method = Action.NONE, method
    log(f"phase 8 K9 + the rect gesture's tint ({int(tex.sum())} px) and a brush ring (r "
        f"{radius:.0f} at {center.tolist()}): one launch, bit for bit the plain passes in turn; "
        f"kernel {t_all['ms']:.4f} ms ({fmt_ms(t_all['device_ms'])} device only), plain "
        f"{rec['all_stages_plain_ms']:.3f} ms, bound {b_all:.4f} ms")

    # 3. Random segments over the frame; 4. one segment, and none.
    segs = random_segments(K9_RANDOM_SEGMENTS, w, h, seed=12)
    tab = segment_table(*segs, w, h)
    require(bits_equal(overlay_cuda(img, tab), rasterize_lines_plain(img, *segs)),
            f"K9 != the plain lines on {K9_RANDOM_SEGMENTS} random segments")
    t_rand = wrapper_times(lambda: overlay_cuda(img, tab), "overlay_kernel")
    rec.update({f"random_{k}": v for k, v in t_rand.items()})
    rec.update(random_segments=len(tab), random_bound_ms=k9_bound(img, tab)[0],
               random_plain_ms=cuda_ms(lambda: rasterize_lines_plain(img, *segs), 3))
    one = tuple(f[7:8] for f in lines)
    require(len(segment_table(*one, w, h)) == 1, "segment 7 of the frame's is not kept")
    require(bits_equal(overlay_cuda(img, segment_table(*one, w, h)),
                       rasterize_lines_plain(img, *one)), "K9 != the plain line on one segment")
    none = overlay_cuda(img, table[:0])
    require(bits_equal(none, img) and none.data_ptr() != img.data_ptr(),
            "K9 with no segment is not a copy of the frame")
    log(f"phase 8 K9 on {K9_RANDOM_SEGMENTS} random segments ({len(tab)} kept; dead, "
        f"transparent, off-screen, NaN, inf and zero-length among them, widths 0-8, <= 256 px "
        f"long): bit for bit the plain lines, kernel {t_rand['ms']:.4f} ms "
        f"({fmt_ms(t_rand['device_ms'])} device only), plain {rec['random_plain_ms']:.3f} ms; "
        f"one segment and none bit for bit")
    rec["ptxas"] = ptxas_rows("overlay_kernel")
    log_ptxas("K9", rec["ptxas"], phase=8)
    return rec


def phase_config4(g, device, smi: str, rec: dict) -> tuple:
    """Phase 8: BASELINE config 4 through the app session: the scene
    streamed in from a PLY, three mask shapes and `(0 | 1) - 2` sent as
    EvaluateMask, timed `update()` frames with the gizmos, then the
    session's other steps once each, and K9 against the plain overlays
    (`overlay_checks`). Returns the launch counts of the 7 frames, of one
    frame and of the hit queries."""
    import io

    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.app import (Action, ExportChoice, GaussianSplattingSession,
                                                    SceneCommand, SceneCommandKind,
                                                    SelectionEdit, export_models)
    from wgpu_3dgs_viewer_app_tpu_torch.data import read_ply_header, write_ply
    from wgpu_3dgs_viewer_app_tpu_torch.mask import MaskShape, MaskShapeKind
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
    from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

    w, h = CONFIG4_SIZE
    s = GaussianSplattingSession(width=w, height=h, device=device, tile=32, max_dup=4)
    # The bench camera; a camera moved off its default is never auto-framed.
    s.camera.control.target = np.zeros(3, np.float32)
    s.camera.control.pos = np.array([0.0, 0.0, -6.0], np.float32)
    cam = s.camera.control
    with tempfile.TemporaryDirectory(prefix="smoke_config4_") as tmp:
        path = os.path.join(tmp, "config4.ply")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            write_ply(f, g)
        write_s = time.perf_counter() - t0
        ply_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            s.open_model("config4.ply", f)
            drains = 0
            while s.loader is not None:
                s._drain_loader()
                drains += 1
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    m = s.viewer.models["config4.ply"]
    require(len(m.buffers) == g.count and np.array_equal(m.gaussians.pos, g.pos),
            f"streamed {len(m.buffers)} of {g.count} splats")
    log(f"phase 8 config 4 load: {g.count} splats written as a {ply_bytes / 1e9:.2f} GB PLY "
        f"in {write_s:.2f} s, streamed in through GaussianSplattingSession.open_model and the "
        f"StreamingLoader in {load_s:.2f} s over {drains} drains")
    unmasked = s.viewer.render(cam)

    # The shapes and the op code of bench.py's config 4.
    for kind, pos, scale in CONFIG4_SHAPES:
        s.mask.add_shape(MaskShape(kind=MaskShapeKind(kind), pos=np.array(pos, np.float32),
                                   scale=np.full(3, scale, np.float32)))
    s.mask.op_code = CONFIG4_OP
    op = s.mask.parse_op()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=op))
    s._drain_commands()
    torch.cuda.synchronize()
    mask_ms = (time.perf_counter() - t0) * 1e3
    bits = m.buffers.download_mask().astype(bool)
    # The same tree on the host positions in numpy f32, each step in the
    # evaluator's order: each containment value, and whether it lies within
    # 1e-6 relative of the shape's boundary.
    x, y, z = (np.ascontiguousarray(g.pos[:, i]) for i in range(3))
    inside, margin = [], []
    for shape in s.mask.shapes:
        pod = shape.to_pod()
        il, p = pod.inv_lin, pod.pos
        dx, dy, dz = x - p[0], y - p[1], z - p[2]
        loc = [il[r, 0] * dx + il[r, 1] * dy + il[r, 2] * dz for r in range(3)]
        if shape.kind == MaskShapeKind.BOX:
            v, lim = np.maximum(np.maximum(np.abs(loc[0]), np.abs(loc[1])), np.abs(loc[2])), 0.5
        else:
            v, lim = loc[0] * loc[0] + loc[1] * loc[1] + loc[2] * loc[2], 0.25
        inside.append(v <= lim)
        margin.append(np.abs(v - lim) <= 1e-6 * lim)
    host = (inside[0] | inside[1]) & ~inside[2]
    near = margin[0] | margin[1] | margin[2]
    differ = bits != host
    require(not (differ & ~near).any(), f"{int((differ & ~near).sum())} mask bits differ from "
                                        f"the host evaluation away from a boundary")
    kept = int(bits.sum())
    require(0 < kept < g.count, f"{kept} splats kept")
    log(f"phase 8 config 4 mask: {len(s.mask.shapes)} shapes, '{CONFIG4_OP}', EvaluateMask "
        f"through the command bus {mask_ms:.3f} ms (the 72 MB position upload included); "
        f"{kept} of {g.count} splats kept; against the host evaluation (numpy f32): "
        f"{int(differ.sum())} bits differ, all within 1e-6 relative of a boundary "
        f"({int(near.sum())} points lie there)")

    # Timed frames with the gizmos.
    ms, img, peak, launches = timed_frames(s.update)
    want = {**dict.fromkeys(launches, 0), "fused": 7, "sort": 7, "composite": k3_launches(7),
            "overlay": 7}
    require(launches == want, f"config-4 session, 7 frames: launched {launches}, expected {want}")
    frames_launches = launches
    # The kept splats fill a box of 1.5 and a ball around the origin, seen
    # from 6 units: a few percent of the frame.
    coverage = check_frame(img, "config 4", min_coverage=0.01, size=(w, h))
    kernels.reset_launch_counts()
    s.update()
    frame_launches = dict(kernels.LAUNCHES)
    render_ms = cuda_ms(lambda: s.viewer.render(cam), 5)
    profile = profile_frames(s.update)
    if profile is None:
        seen = "under the profiler: not measured (it saw no device time)"
    else:
        wall, busy, rows = profile
        top = ", ".join(f"{k[:40]} {v:.3f}" for k, v, _ in rows[:6])
        seen = (f"under the profiler, 3 frames: {wall / 3:.3f} ms/frame wall, device busy "
                f"{busy / 3:.3f} ms/frame, idle share {1 - busy / wall:.3f}; top device "
                f"ms/frame: {top}")
    log(f"phase 8 config 4 frames: {g.count} splats at {w}x{h}, SH 3, norm8/half, tile 32, "
        f"max_dup 4, mask-gated: update() {ms:.3f} ms/frame over 5 frames (Viewer.render alone "
        f"{render_ms:.3f} ms), peak {peak:.2f} GiB, coverage {coverage:.3f}, launches {launches}; "
        f"{seen} [{smi}]")

    # The masked frame against a scene of the kept splats alone, in order.
    masked = s.viewer.render(cam)
    only = Viewer(g.select(bits), w, h, tile=32, max_dup=4, device=device).render(cam)
    d_kept = float((masked - only).abs().max())
    require(d_kept <= 1e-5, f"masked frame vs kept-splats frame: max abs {d_kept}")
    require(not torch.equal(masked, unmasked), "the mask changed nothing")
    del only

    # Two hit clicks make one measurement pair (K4), then a frame with its line.
    kernels.reset_launch_counts()
    found = [s.locate_hit(px, 0, i) for i, px in enumerate(CONFIG4_HITS)]
    hit_launches = dict(kernels.LAUNCHES)
    require(found == [True, True], f"hit queries found {found}")
    require(hit_launches == {**dict.fromkeys(hit_launches, 0), "geometry": 2},
            f"hit queries launched {hit_launches}")
    pair = s.measurement.hit_pairs[0]
    dist = pair.distance()
    require(math.isfinite(dist) and dist > 0, f"measured distance {dist}")
    with_line = s.update()
    drawn = int(((with_line - img).abs().amax(dim=-1) > 0).sum())
    require(drawn > 0, "the measurement line drew nothing")
    overlay_ms = cuda_ms(lambda: s.render_overlays(masked), 10)
    log(f"phase 8 checks: masked frame vs a scene of the {kept} kept splats alone max abs "
        f"{d_kept:.3e} (<= 1e-5); hits at {CONFIG4_HITS}: "
        f"{[h.pos.round(4).tolist() for h in pair.hits]}, distance {dist:.4f}, launches "
        f"{hit_launches}; the measurement line changed {drawn} pixels; overlay (gizmos of 3 "
        f"shapes, 120 segments, + 1 measurement line) {overlay_ms:.3f} ms")
    rec["overlay"] = overlay_checks(s, masked, smi)
    rec["overlay"]["config4_render_overlays_ms"] = overlay_ms

    # Export with the mask filter: the PLY holds the kept splats.
    out = _HeadWriter()
    t0 = time.perf_counter()
    export_models(s.viewer, out, {"config4.ply": ExportChoice(with_edit=False, with_mask=True)})
    export_s = time.perf_counter() - t0
    header = read_ply_header(io.BytesIO(bytes(out.head)))
    require(header.count == kept and out.size == header.header_len + kept * 248,
            f"export: {header.count} splats, {out.size} bytes; {kept} kept")

    # Reset: every bit set, the frame equals the unmasked one.
    s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=None))
    s._drain_commands()
    reset = s.viewer.render(cam)
    require(bool(m.buffers.mask.all()), "Reset left bits unset")
    d_reset = float((reset - unmasked).abs().max())
    require(d_reset == 0.0, f"Reset frame vs unmasked: max abs {d_reset}")

    # A rect selection gesture, its end and a committed edit.
    s.action = Action.SELECTION
    s.toolset.set_use_texture(False)
    s.toolset.start(QueryToolset.RECT, QuerySelectionOp.SET, CONFIG3_RECT[0])
    s.toolset.update_pos(CONFIG3_RECT[1])
    kernels.reset_launch_counts()
    s.end_selection_gesture()
    require(kernels.LAUNCHES["geometry"] == 1, f"the gesture launched {kernels.LAUNCHES}")
    selected = int(m.buffers.selection.sum())
    require(0 < selected < g.count, f"{selected} splats selected")
    s.selection.edit = SelectionEdit(hsv=(0.3, 1.0, 1.0), alpha=0.5)
    s.commit_selection_edit()
    flags = m.buffers.download_edits()[0]
    sel = m.buffers.download_selection().astype(bool)
    require(bool((flags[sel] != 0).all()) and not (flags[~sel] != 0).any(),
            "committed edit records do not follow the selection")
    s.selection.edit = None
    edited = s.update()
    require(not torch.equal(edited, reset), "the committed edit changed nothing")
    log(f"phase 8 checks: export with the mask filter {header.count} splats, {out.size} bytes in "
        f"{export_s:.2f} s; Reset frame == unmasked frame (max abs {d_reset}); rect gesture "
        f"{CONFIG3_RECT} selected {selected} splats (K4 once), edit committed to them")
    return frames_launches, frame_launches, hit_launches, s, kept


def _sof_size(blob: bytes) -> tuple:
    """(width, height) from a baseline JPEG's SOF0 header."""
    i = blob.index(b"\xff\xc0")
    return int.from_bytes(blob[i + 7:i + 9], "big"), int.from_bytes(blob[i + 5:i + 7], "big")


def phase_serve(s, kept: int, smi: str) -> dict:
    """Phase 9: phase 8's session behind the port's `ViewerServer` on a
    `ThreadingHTTPServer` at 127.0.0.1 (an ephemeral port, a daemon thread),
    driven with urllib. Returns the launch counts of one dirty frame."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.app import ViewerServer, make_handler
    from wgpu_3dgs_viewer_app_tpu_torch.app.server import ASSETS
    from wgpu_3dgs_viewer_app_tpu_torch.data import read_ply
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
    from wgpu_3dgs_viewer_app_tpu_torch.utils import human_readable_size, jpeg, trace

    t_phase = time.perf_counter()
    w, h = CONFIG4_SIZE
    vs = ViewerServer(s)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(vs))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path: str, body=None) -> bytes:
        """One request; a status other than 200 raises."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    def ok(path: str, body) -> None:
        require(json.loads(call(path, body)) == {"ok": True}, f"{path} {body} failed")

    orbit = {"type": "orbit", "dx": 10.0, "dy": 0.0}
    m = s.viewer.models["config4.ply"]
    try:
        # 1. The page and the state.
        require(call("/") == (ASSETS / "index.html").read_bytes(), "GET / is not the page")
        st = json.loads(call("/state"))
        model = st["models"]["config4.ply"]
        require(model["count"] == CONFIG4_SPLATS and model["loaded"] == CONFIG4_SPLATS,
                f"/state reports {model['count']} splats")
        size = human_readable_size(s.compressions.compressed_size(CONFIG4_SPLATS))
        require(model["compressed_size"] == size, f"compressed_size {model}, not {size}")
        # Config 4's served scene: the mask again, no measurement line, no
        # selection (phase 8's committed edit stays on its rect's splats).
        ok("/command", {"cmd": "remove_measurement_pair", "index": 0})
        ok("/set", {"action": "none"})
        ok("/command", {"cmd": "clear_selection"})
        ok("/command", {"cmd": "evaluate_mask"})
        require(int(m.buffers.mask.sum()) == kept, "evaluate_mask over HTTP kept another set")

        # 2. Dirty frames: an orbit event, then the frame.
        for _ in range(2):
            call("/event", orbit)
            call("/frame.jpg?quality=85")
        rows = []
        for _ in range(5):
            t0 = time.perf_counter()
            call("/event", orbit)
            t1 = time.perf_counter()
            trace.reset()   # each frame's records from an empty list, far from the cap
            with trace.collect():   # fills vs.frame_ms
                blob = call("/frame.jpg?quality=85")
            t2 = time.perf_counter()
            part = dict(vs.frame_ms)
            require(set(part) == {"update", "device", "copy", "host"},
                    f"a served frame's stages read {part}")
            rows.append({**part, "http": (t2 - t0) * 1e3 - sum(part.values()),
                         "event": (t1 - t0) * 1e3, "total": (t2 - t0) * 1e3, "bytes": len(blob)})
        mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}

        # 3. Launch counts: a dirty frame runs K1-K3 and K9 (the gizmos) once,
        # an idle poll nothing.
        call("/event", orbit)
        kernels.reset_launch_counts()
        blob = call("/frame.jpg?quality=85")
        frame_launches = dict(kernels.LAUNCHES)
        want = {**dict.fromkeys(frame_launches, 0), "fused": 1, "sort": 1,
                "composite": k3_launches(), "overlay": 1}
        require(frame_launches == want, f"a dirty frame launched {frame_launches}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        idle = call("/frame.jpg?quality=85")
        cached_ms = (time.perf_counter() - t0) * 1e3
        require(idle == blob and not any(kernels.LAUNCHES.values()),
                f"an idle poll launched {dict(kernels.LAUNCHES)} or re-encoded")

        # 4. The served bytes: the encoding of an in-process update() at this
        # state, on the card and of its uint8 copy on the CPU.
        with vs.lock:
            u8 = jpeg.frame_to_u8(s.update())
        require(jpeg.encode_jpeg(u8, 85) == blob, "served bytes != utils.jpeg of update()")
        u8_host = u8.cpu()
        require(jpeg.encode_jpeg(u8_host, 85) == blob, "served bytes != the CPU encoding")
        covered = float((u8_host.amax(dim=-1) > 0).float().mean())
        require(covered > 0.01, f"the served frame covers {covered:.4f} of its pixels")

        # 5. A scaled frame.
        half = call("/frame.jpg?quality=85&scale=0.5")
        require(_sof_size(half) == (w // 2, h // 2), f"scaled frame is {_sof_size(half)}")

        # 6. The first-person camera: look and move change the frame; orbit returns.
        ok("/event", {"type": "set_control", "control": "first_person"})
        ok("/event", {"type": "look", "dx": 40.0, "dy": -10.0})
        ok("/event", {"type": "move", "z": 1.0, "x": 0.3, "dt": 0.2})
        require(json.loads(call("/state"))["camera"]["control"] == "first_person",
                "set_control first_person did not take")
        fp_frame = call("/frame.jpg?quality=85")
        require(fp_frame != blob, "look and move left the frame as it was")
        ok("/event", {"type": "set_control", "control": "orbit", "arm": 6.0})
        require(json.loads(call("/state"))["camera"]["control"] == "orbit",
                "set_control orbit did not take")

        # 7. A rect selection over HTTP (texture mode, the page's default),
        # then a committed edit.
        ok("/set", {"action": "selection",
                    "selection": {"edit": {"hsv": [0.6, 1.0, 1.0], "alpha": 0.8}}})
        call("/frame.jpg?quality=85")
        (x0, y0), (x1, y1) = CONFIG3_RECT
        kernels.reset_launch_counts()
        ok("/event", {"type": "action_start", "x": x0, "y": y0})
        ok("/event", {"type": "action_move", "x": x1, "y": y1})
        ok("/event", {"type": "action_end", "x": x1, "y": y1})
        gesture = dict(kernels.LAUNCHES)
        require(gesture == {**dict.fromkeys(gesture, 0), "geometry": 1},
                f"the rect gesture launched {gesture}")
        selected = int(m.buffers.selection.sum())
        require(0 < selected < CONFIG4_SPLATS, f"{selected} splats selected")
        ok("/command", {"cmd": "commit_edit"})
        edited = call("/frame.jpg?quality=85")

        # 8. Export with the mask filter.
        t0 = time.perf_counter()
        ply = call("/export", {"choices": {"config4.ply": {"with_mask": True}}})
        export_s = time.perf_counter() - t0
        n_export = read_ply(io.BytesIO(ply)).count
        require(n_export == kept == CONFIG4_KEPT,
                f"export holds {n_export} splats; the mask keeps {kept}")

        # 9. A change of compression repacks the model; the next frame renders.
        t0 = time.perf_counter()
        ok("/set", {"compressions": {"sh": "half"}})
        repack_s = time.perf_counter() - t0
        require(s.compressions.sh.value == "half", "compressions not changed")
        kernels.reset_launch_counts()
        repacked = call("/frame.jpg?quality=85")
        require(dict(kernels.LAUNCHES) == want, f"after the repack: {dict(kernels.LAUNCHES)}")
        require(repacked[:2] == b"\xff\xd8" and _sof_size(repacked) == (w, h),
                "the repacked frame is no JPEG of the frame's size")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "the server thread did not stop")
    fmt = ", ".join(f"{k} {v:.3f}" for k, v in mean.items() if k != "bytes")
    log(f"phase 9 serve, config 4 ({w}x{h}, {CONFIG4_SPLATS} splats, '{CONFIG4_OP}', {kept} "
        f"kept) over HTTP: GET / = the page, /state {model['count']} splats, compressed_size "
        f"{model['compressed_size']}")
    for i, r in enumerate(rows):
        log(f"phase 9 dirty frame {i}: " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()
                                                     if k != "bytes") + f" ms, {r['bytes']} B")
    log(f"phase 9 dirty frames, mean of 5 (POST /event orbit dx=10, GET /frame.jpg?quality=85): "
        f"{fmt} ms (host clock, from the frame's spans: 'update': update() under the state "
        f"lock, which waits for K3 at the background's upload; 'device': the encoder's device "
        f"stages issued and waited for at the nonzero count; 'copy', 'host': the coefficients' "
        f"copy and the entropy coder; 'http': the rest of both requests); "
        f"mean {mean['bytes']:.0f} B; cached frame {cached_ms:.3f} ms [{smi}]")
    log(f"phase 9 checks: a dirty frame launched {frame_launches}; an idle poll none, the same "
        f"bytes; served bytes == utils.jpeg of an in-process update() on the card == the CPU "
        f"encoding of its uint8 copy; scale=0.5 -> SOF0 {_sof_size(half)}; first person look + "
        f"move changed the frame, orbit back; rect gesture {CONFIG3_RECT} (texture mode) "
        f"selected {selected} splats (K4 once), edit committed ({len(edited)} B frame); POST "
        f"/export with the mask: {n_export} splats, {len(ply)} B in {export_s:.2f} s; "
        f"compressions sh half repacked in {repack_s:.2f} s, next frame {len(repacked)} B; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return frame_launches


def check_codec_pod(got: dict, ref: dict) -> int:
    """The native pod against numpy's within `tests/test_native.py`'s
    tolerances: pos equal, u8 fields +-1, cov3d rtol 1e-3 atol 1e-6.
    Returns the count of cov3d words that differ."""
    import numpy as np

    require(set(got) == set(ref), f"codec fields {sorted(got)} vs numpy {sorted(ref)}")
    require(np.array_equal(got["pos"], ref["pos"]), "codec pos differs from numpy's")
    for shift in (0, 8, 16, 24):
        d = np.abs(((got["color0"] >> shift) & 0xFF).astype(np.int16)
                   - ((ref["color0"] >> shift) & 0xFF).astype(np.int16))
        require(int(d.max()) <= 1, f"codec color0 byte {shift // 8}: off by {int(d.max())}")
    if ref.get("sh") is not None and ref["sh"].dtype == np.uint8:
        d = np.abs(got["sh"].astype(np.int16) - ref["sh"].astype(np.int16))
        require(int(d.max()) <= 1, f"codec sh: off by {int(d.max())}")
        for k in ("sh_mn", "sh_span"):
            require(np.allclose(got[k], ref[k], rtol=1e-6, atol=0), f"codec {k} differs")
    a, b = got["cov3d"].astype(np.float32), ref["cov3d"].astype(np.float32)
    require(np.allclose(a, b, rtol=1e-3, atol=1e-6),
            f"codec cov3d: max abs {float(np.abs(a - b).max())}")
    return int((got["cov3d"] != ref["cov3d"]).sum())


def phase_sharded(g, cam, device, smi: str, rec: dict) -> dict:
    """Phase 10: the native codec on the config-1 scene (native pack against
    numpy's), then the config-1 frame through the sharded renderer over NCCL
    at world size 1, against `viewer.render_frame`. Returns the launches of
    one sharded frame."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words, native,
                                                     pack_gaussians)
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (TileConfig, build_sorted_entries,
                                                    composite_tiles_v2, kernels, over_background,
                                                    preprocess)
    from wgpu_3dgs_viewer_app_tpu_torch.parallel import (make_mesh, render_frame_sharded,
                                                         render_sharded, shard_pod)
    from wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded import last_stats
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import render_frame

    t_phase = time.perf_counter()
    comp = Compressions()
    require(native.available(), "the native codec is not available on the card's host")
    t0 = time.perf_counter()
    direct = native.pack_gaussians_native(g, comp)
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = pack_gaussians(g, comp)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_np = pack_gaussians(g, comp, use_native=False)
    numpy_s = time.perf_counter() - t0
    require(set(raw) == set(direct) and all(np.array_equal(raw[k], direct[k]) for k in raw),
            "the default pack_gaussians did not run the native codec")
    cov_diff = check_codec_pod(raw, raw_np)
    del direct, raw_np
    log(f"phase 10 native codec: built and loaded in {native.build_seconds:.2f} s (phase 1); "
        f"{g.count} splats packed (norm8/half) in {native_s:.3f} s by the default "
        f"pack_gaussians, {direct_s:.3f} s by pack_gaussians_native, {numpy_s:.3f} s by numpy "
        f"(use_native=False), {numpy_s / native_s:.1f}x; against numpy: pos equal, u8 fields "
        f"+-1, cov3d within rtol 1e-3 ({cov_diff} of {raw['cov3d'].size} f16 words differ) "
        f"[{smi}]")

    cfg = TileConfig(1920, 1080, tile=32, max_dup=4)
    view, proj = cam.view(), cam.projection(cfg.width / cfg.height)
    eye = np.eye(4, dtype=np.float32)
    words = flat_pod_to_words(raw, comp)
    del raw
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    init_s = time.perf_counter() - t0
    try:
        mesh = make_mesh()
        require((mesh.world, mesh.device) == (1, device), f"mesh {mesh}")
        pod = shard_pod(words, mesh)
        del words

        def sharded():
            return render_sharded(pod, mesh, comp, cfg, view, proj, sh_degree=3)

        def single():
            return over_background(render_frame(pod, comp, cfg, view, proj, eye, sh_degree=3),
                                   np.zeros(3, np.float32))

        ms, img, peak, launches7 = timed_frames(sharded)
        ms_single, ref, peak_single, single7 = timed_frames(single)
        want1 = {**dict.fromkeys(single7, 0), "preprocess": 7, "enum_pack": 7, "sort": 7,
                 "composite": k3_launches(7)}
        require(single7 == want1, f"7 render_frame frames launched {single7}, expected {want1}")
        # render_frame on K8 against the same pipeline on the plain preprocess.
        plain = over_background(composite_tiles_v2(build_sorted_entries(
            preprocess(pod, comp, view, proj, eye, cfg.width, cfg.height, sh_degree=3), cfg), cfg),
            np.zeros(3, np.float32))
        require(torch.equal(ref, plain), "render_frame on K8 differs from the plain preprocess's: "
                f"max abs {float((ref - plain).abs().max())}")
        del plain
        kernels.reset_launch_counts()
        img = sharded()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = {**dict.fromkeys(launches, 0), "preprocess": 1, "enum_pack": 1, "sort": 2,
                "composite": k3_launches()}
        require(launches == want, f"one sharded frame launched {launches}, expected {want}")
        want7 = {k: 7 * v for k, v in want.items()}
        require(launches7 == want7, f"7 sharded frames launched {launches7}, expected {want7}")
        require(last_stats() == {"overflow": 0, "n_devices": 1},
                f"last_stats() {last_stats()} after the sharded frames")
        coverage = check_frame(img, "sharded config 1")
        require(torch.equal(img, ref), "sharded frame differs from render_frame: max abs "
                f"{float((img - ref).abs().max())}")
        stages = []
        for _ in range(5):
            tm = {}
            render_frame_sharded(pod, mesh, "splats", comp, cfg, view, proj, eye,
                                 np.zeros(3, np.float32), sh_degree=3, timings=tm)
            stages.append(tm)
        mean = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
        rec["preprocess"].update(sharded_frame_ms=ms, sharded_render_frame_ms=ms_single,
                                 sharded_stage_ms=mean)
    finally:
        dist.destroy_process_group()
    log(f"phase 10 sharded frame, config 1 over NCCL at world size 1 (group set up in "
        f"{init_s:.2f} s): {ms:.3f} ms/frame over 5 frames (render_frame {ms_single:.3f}), "
        f"peak {peak:.2f} GiB (render_frame {peak_single:.2f}), coverage {coverage:.3f}, "
        f"launches of one frame {launches}, overflow 0, last_stats {last_stats()}, bit for bit "
        f"render_frame (which is bit for bit the same pipeline on the plain preprocess); stages, "
        f"each closed by a sync, mean of 5 (ms): "
        + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in mean.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from wgpu_3dgs_viewer_app_tpu_torch.data import native
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kernels.library()
    build = time.perf_counter() - t0
    # The native codec builds here, before the first pack, so phase 10 can
    # report its build on the card's host.
    require(native.available(), "the native codec did not build")
    log(f"phase 1 device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"kernel build {build:.1f} s (nvcc {kernels.build_seconds or 0.0:.1f} s); native "
        f"codec build {native.build_seconds:.2f} s")

    g1, cam1 = config1_scene()
    g3, cam3 = config3_scene()
    models2 = config2_models()
    rec = phase_kernels(g1, cam1, g3, cam3, device)
    torch.cuda.empty_cache()
    phase_kernels_staged(g1, cam1, models2[1], device, rec)
    torch.cuda.empty_cache()
    phase_kernels_preprocess(g1, cam1, g3, cam3, models2[1], device, rec)
    torch.cuda.empty_cache()
    # Scratch files of phase 3 go to the git-ignored build directory.
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_", dir=kernels.BUILD_DIR) as work_dir:
        phase_golden(work_dir)
    launches, v2_img = phase_config1(g1, cam1, device, smi, rec)
    torch.cuda.empty_cache()
    launches["geometry"] = phase_config3(g3, cam3, device, smi, rec)["geometry"]
    del g3
    torch.cuda.empty_cache()
    launches2 = phase_config2(models2, device, smi, rec)
    launches["enum_pack"] = launches2["staged"]["enum_pack"]
    launches["preprocess"] = launches2["staged"]["preprocess"]
    del models2
    torch.cuda.empty_cache()
    launches7 = phase_compositors(g1, cam1, v2_img, device, smi, rec)
    launches["composite_v1"] = launches7["composite_v1"]["composite_v1"]
    del v2_img
    torch.cuda.empty_cache()
    frames8, launches8, hits8, session4, kept4 = phase_config4(g1, device, smi, rec)
    launches["overlay"] = frames8["overlay"]
    launches9 = phase_serve(session4, kept4, smi)
    del session4
    torch.cuda.empty_cache()
    launches10 = phase_sharded(g1, cam1, device, smi, rec)
    del g1

    out = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        require(launches[name] >= 1, f"kernel {name} never launched on its path: {launches}")
        # `launches`: on the path that is the kernel's main one (config 1 for
        # K1-K3, config 3 for K4, the staged config 2 for K5 and K8, phase
        # 7's v1 frame for K6, config 4's 7 session frames for K9); config 4:
        # one session frame, and the two hit queries.
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name],
                    "launches_config2_fused": launches2["fused"][name],
                    "launches_config2_staged": launches2["staged"][name],
                    "launches_v1_frame": launches7["composite_v1"][name],
                    "launches_rows_frame": launches7["rows"][name],
                    "launches_config4_frame": launches8[name],
                    "launches_config4_hits": hits8[name],
                    "launches_serve_frame": launches9[name],
                    "launches_sharded_frame": launches10[name], **r})
    require(all(math.isfinite(k["ms"]) and math.isfinite(k["bound_ms"]) for k in out),
            f"non-finite time in {out}")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
