#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, exit 0 only if all pass

Phases, each printing what it found:
  1. device: the card's name and power limit (nvidia-smi) and the seconds the
     CUDA kernels took to build from `wgpu_3dgs_viewer_app_tpu_torch/csrc`;
  2. each kernel (K1 front-end, K2 entry sort, K3 compositor) against its
     plain torch version on the card, at the shapes of the main path below,
     with both times;
  3. the golden fixture rendered through the port's CLI on cuda, held to the
     repo's golden gate (`tests/test_golden.py::assert_golden_close`);
  4. the main path: a 6M-splat scene at 1920x1080, SH degree 3, norm8 SH +
     half cov3d, tile 32, max_dup 4, through `Viewer.render`: 2 warm-up and
     5 timed frames; the launch counters must show all three kernels ran.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Runs without a CUDA device, or outside the repo, fail before printing it.
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
K3_TOL = 1.0 / 255.0 + 1e-5

KERNELS = {
    "fused": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/fused.cu",
              "wgpu_3dgs_viewer_app_tpu/ops/fused.py:138"),
    "sort": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/sort.cu",
             "wgpu_3dgs_viewer_app_tpu/ops/compact.py:95; "
             "wgpu_3dgs_viewer_app_tpu/ops/sort.py:325; "
             "wgpu_3dgs_viewer_app_tpu/ops/sort.py:779"),
    "composite": ("wgpu_3dgs_viewer_app_tpu_torch/csrc/composite.cu",
                  "wgpu_3dgs_viewer_app_tpu/ops/composite.py:639"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs after one warm-up, by CUDA
    events on the current stream (host gaps inside fn count)."""
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


def main_path_scene():
    """BASELINE config 1: 6M random splats, camera at (0, 0, -6)."""
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene

    g = make_random_scene(6_000_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    return g, CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


def phase_kernels(g, cam, device) -> dict:
    """Phase 2: each kernel against its plain version on the same inputs,
    at the main path's shapes (1080p, tile 32, max_dup 4, default pod)."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.data import (
        Compressions, flat_pod_to_words, pack_gaussians, pod_to_tensors)
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (
        TileConfig, composite_tiles_plain_v2, composite_tiles_v2, enumerate_entries_fused,
        enumerate_entries_plain, sort_entries, sort_entries_plain)
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries, compare_sorted

    w, h, n = 1920, 1080, g.count
    comp = Compressions()
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), device)
    view, proj = cam.view(), cam.projection(w / h)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    args = (pod, comp, cfg, view, proj, np.eye(4, dtype=np.float32))
    rec = {}

    ent_k = enumerate_entries_fused(*args)
    ent_p = enumerate_entries_plain(*args)
    st = compare_entries(ent_k, ent_p, cfg)
    del ent_p
    rec["fused"] = {"max_abs_err": st["max_field_step"],
                    "ms": cuda_ms(lambda: enumerate_entries_fused(*args), 20),
                    "plain_ms": cuda_ms(lambda: enumerate_entries_plain(*args), 2)}
    log(f"phase 2 K1 front-end: {n} splats, {st['live_a']} live entries, "
        f"{st['identical']:.6f} identical to plain, {st['differing']} within one step; "
        f"kernel {rec['fused']['ms']:.3f} ms, plain {rec['fused']['plain_ms']:.3f} ms")

    se_k = sort_entries(ent_k, cfg)
    compare_sorted(se_k, sort_entries_plain(ent_k, cfg))
    rec["sort"] = {"max_abs_err": 0,
                   "ms": cuda_ms(lambda: sort_entries(ent_k, cfg), 20),
                   "plain_ms": cuda_ms(lambda: sort_entries_plain(ent_k, cfg), 3)}
    log(f"phase 2 K2 entry sort: {ent_k.shape[0]} entries, {se_k.n_valid} live; keys "
        f"bit-equal to torch.sort, payload multisets equal; kernel {rec['sort']['ms']:.3f} ms, "
        f"plain {rec['sort']['plain_ms']:.3f} ms")

    img_k = composite_tiles_v2(se_k, cfg)
    img_p = composite_tiles_plain_v2(se_k, cfg)
    err = float((img_k - img_p).abs().max())
    require(err <= K3_TOL, f"K3 max abs {err} > {K3_TOL}")
    rec["composite"] = {"max_abs_err": err,
                        "ms": cuda_ms(lambda: composite_tiles_v2(se_k, cfg), 20),
                        "plain_ms": cuda_ms(lambda: composite_tiles_plain_v2(se_k, cfg), 1)}
    log(f"phase 2 K3 compositor: max abs {err:.3e} (<= {K3_TOL:.3e}) vs plain; kernel "
        f"{rec['composite']['ms']:.3f} ms, plain {rec['composite']['plain_ms']:.3f} ms")
    return rec


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


def phase_main_path(g, cam, device, smi: str, rec: dict) -> dict:
    """Phase 4: BASELINE config 1 through Viewer.render."""
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
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
    for name, count in launches.items():
        require(count >= 1, f"kernel {name} never launched on the main path: {launches}")
    require(img.shape == (1080, 1920, 3), f"image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite pixels")
    coverage = float((img.amax(dim=-1) > 1.0 / 255.0).float().mean())
    require(coverage > 0.2, f"only {coverage:.3f} of pixels covered")
    rest = ms - sum(r["ms"] for r in rec.values())
    log(f"phase 4 main path: {g.count} splats at 1920x1080, SH 3, norm8/half, tile 32, "
        f"max_dup 4: {ms:.3f} ms/frame over {frames} frames ({rest:.3f} ms outside the three "
        f"kernels' phase-2 times), peak {peak:.2f} GiB, coverage {coverage:.3f}, launches "
        f"{launches}, viewer set-up {setup:.1f} s [{smi}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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
    log(f"phase 1 device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"kernel build {build:.1f} s (nvcc {kernels.build_seconds or 0.0:.1f} s)")

    g, cam = main_path_scene()
    rec = phase_kernels(g, cam, device)
    torch.cuda.empty_cache()
    # Scratch files of phase 3 go to the git-ignored build directory.
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_", dir=kernels.BUILD_DIR) as work_dir:
        phase_golden(work_dir)
    launches = phase_main_path(g, cam, device, smi, rec)

    out = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"]})
    require(all(math.isfinite(k["ms"]) for k in out), f"non-finite time in {out}")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
