#!/usr/bin/env python3
"""The sharded renderer (`parallel/`) over several ranks, one process each:
the BASELINE config-1 frame split over `--world` ranks and timed, held on
rank 0 against the single-device `viewer.render_frame`.

    python3 scripts/sharded_ranks.py --world 4            # NCCL, one GPU a rank
    python3 scripts/sharded_ranks.py --world 2 --device cpu --splats 20000 \\
        --width 256 --height 192                          # gloo, a CPU rehearsal

Each rank makes the same scene from its seed (config 1: `make_random_scene(
6_000_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))`, camera at (0,
0, -6), SH 3, norm8 SH + half cov3d, tile 32, max_dup 4), packs it (the
native codec where it builds), takes its contiguous run (`shard_pod`) and
renders 2 warm-up and `--frames` timed frames through `render_sharded`,
each closed by a device sync and a barrier; then as many frames with every
stage timed (local front-end and sort, the count exchange and its host
read, the entries' all_to_all, the owner's sort and composite, the
gather). Rank 0 then renders the whole scene alone (`render_frame`, 2
warm-up and `--frames` timed) and compares: the sharded image must be the
same on every rank and within 1/255 + 1e-5 of the single-device one (the
compositor's early exit goes by 128-entry chunks of each slab's own entry
array), with overflow 0. On CUDA each rank must launch K8 and K5 once, K2
twice and K3 once a frame. The group is set up on `tcp://127.0.0.1` at a free
port. Prints one JSON line per rank and a summary line (with `--out
PATH`, also the summary and every rank's record as one JSON file); exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EXIT_TOL = 1.0 / 255.0 + 1e-5


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(frame, device, frames: int, barrier) -> tuple:
    """(ms per frame after 2 warm-ups, the last image)."""
    for _ in range(2):
        frame()
    _sync(device)
    barrier()
    t0 = time.perf_counter()
    for _ in range(frames):
        img = frame()
    _sync(device)
    barrier()
    return (time.perf_counter() - t0) * 1e3 / frames, img


def run_rank(rank: int, args, init_method: str, out_path: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words,
                                                     make_random_scene, pack_gaussians,
                                                     pod_to_tensors)
    from wgpu_3dgs_viewer_app_tpu_torch.ops import TileConfig, kernels, over_background
    from wgpu_3dgs_viewer_app_tpu_torch.parallel import (make_mesh, render_frame_sharded,
                                                         render_sharded, shard_pod)
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import render_frame

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method, rank=rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh()
        comp = Compressions()
        g = make_random_scene(args.splats, seed=0, extent=2.0, scale_range=(0.004, 0.02))
        cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))
        cfg = TileConfig(args.width, args.height, tile=32, max_dup=4)
        view, proj = cam.view(), cam.projection(args.width / args.height)
        words = flat_pod_to_words(pack_gaussians(g, comp), comp)
        pod = shard_pod(words, mesh)

        def sharded():
            return render_sharded(pod, mesh, comp, cfg, view, proj, sh_degree=3,
                                  return_stats=True)

        ms, (img, stats) = _timed(sharded, mesh.device, args.frames, dist.barrier)
        kernels.reset_launch_counts()
        sharded()
        _sync(mesh.device)
        launches = dict(kernels.LAUNCHES)
        stages = []
        for _ in range(args.frames):
            tm = {}
            render_frame_sharded(pod, mesh, "splats", comp, cfg, view, proj,
                                 np.eye(4, dtype=np.float32), np.zeros(3, np.float32),
                                 sh_degree=3, timings=tm)
            stages.append(tm)
        rec = {"rank": rank, "world": mesh.world, "device": str(mesh.device),
               "splats_local": int(pod["color0"].shape[-1]), "ms": ms,
               "overflow": stats["overflow"], "launches": launches,
               "stages_ms": {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}}
        gathered = [torch.empty_like(img) for _ in range(mesh.world)]
        dist.all_gather(gathered, img.contiguous())
        rec["same_on_every_rank"] = all(torch.equal(x, img) for x in gathered)
        if rank == 0:
            full = pod_to_tensors(words, mesh.device)
            eye = np.eye(4, dtype=np.float32)

            def single():
                return over_background(render_frame(full, comp, cfg, view, proj, eye,
                                                    sh_degree=3), np.zeros(3, np.float32))

            rec["render_frame_ms"], ref = _timed(single, mesh.device, args.frames, lambda: None)
            diff = (img - ref).abs()
            rec["max_abs_vs_render_frame"] = float(diff.max())
            rec["mean_abs_vs_render_frame"] = float(diff.mean())
            rec["coverage"] = float((img.amax(dim=-1) > 1.0 / 255.0).float().mean())
        with open(f"{out_path}.rank{rank}", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--splats", type=int, default=6_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", help="write the summary and the ranks' records here (JSON)")
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    from wgpu_3dgs_viewer_app_tpu_torch.data import native
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
    from wgpu_3dgs_viewer_app_tpu_torch.ops.composite import composite_launches

    smi = ""
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
            print(f"sharded_ranks: needs {args.world} CUDA devices", file=sys.stderr)
            return 1
        kernels.library()  # built once here, not by every rank at once
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    native.available()  # the codec too
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    recs = []
    # The ranks' records go through the git-ignored build directory.
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=kernels.BUILD_DIR) as tmp:
        rec_path = os.path.join(tmp, "rank")
        mp.start_processes(run_rank, args=(args, f"tcp://127.0.0.1:{_free_port()}", rec_path),
                           nprocs=args.world, start_method="spawn")
        for r in range(args.world):
            with open(f"{rec_path}.rank{r}") as f:
                recs.append(json.load(f))
            print(json.dumps(recs[-1]))
    want = {**dict.fromkeys(recs[0]["launches"], 0), "preprocess": 1, "enum_pack": 1,
            "sort": 2, "composite": composite_launches(32)} if args.device == "cuda" else None
    checks = {
        "same_on_every_rank": all(r["same_on_every_rank"] for r in recs),
        "overflow_0": all(r["overflow"] == 0 for r in recs),
        "within_exit_tol": recs[0]["max_abs_vs_render_frame"] <= EXIT_TOL,
        "launches": want is None or all(r["launches"] == want for r in recs),
    }
    summary = {"world": args.world, "device": args.device, "gpus": smi.splitlines(),
               "splats": args.splats, "size": [args.width, args.height],
               "ms_per_rank": [r["ms"] for r in recs],
               "render_frame_ms": recs[0]["render_frame_ms"],
               "max_abs_vs_render_frame": recs[0]["max_abs_vs_render_frame"],
               "mean_abs_vs_render_frame": recs[0]["mean_abs_vs_render_frame"],
               "checks": checks, "seconds": time.perf_counter() - t0, "ranks": recs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "ranks"}))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
