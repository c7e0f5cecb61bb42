#!/usr/bin/env python3
"""Where the time of one port frame goes on the GPU: torch.profiler over a
few frames of a BASELINE cell, device time per kernel and the idle share.

    python3 scripts/profile_port_frame.py --config 1   # 6M splats, Viewer.render
    python3 scripts/profile_port_frame.py --config 3   # 2M splats, select + edit step
    python3 scripts/profile_port_frame.py --config 2 --route fused    # 3 x 1M, merged frame
    python3 scripts/profile_port_frame.py --config 2 --route staged
    python3 scripts/profile_port_frame.py --config 1 --route v1     # the v1 chain, K6
    python3 scripts/profile_port_frame.py --config 1 --route rows   # row-major v2, K3 basis
    python3 scripts/profile_port_frame.py --config 1 --tiles  # + K3 tile by tile
    python3 scripts/profile_port_frame.py --tiles --scene inria6m --yaws 5  # the benchmark's

Config 1 is the plain orbit frame; config 3 is the selection-and-editing
step (`card.config3_step`: query geometry -> select_rect -> set_selection
-> selection edit + highlight -> Viewer.render); both at 1920x1080.
Config 2 is the merged three-model frame (`card.config2_viewer`) at
1920x1088, on the fused front-end route (K1 per model) or the staged one
(K8 + K5 per model). Config 1 also runs on two other routes: the v1 chain
(K8 -> build_tile_lists -> build_entry_planes -> composite_tiles,
`card.v1_frame`) and the row-major v2 frame (K1 -> K2 ->
composite_tiles_v2(transposed=False, mxu=True), the one v2 compositor K3
in its quadratic-basis form, `card.rows_frame`). The scenes and timers are
`scripts/card.py`'s.
All at SH 3, norm8 SH + half cov3d, tile 32, max_dup 4. Prints one line
per kernel (ms per frame, share of device time), the device's busy and
wall time over the profiled frames, and the card's name and power limit.
With --tiles (config 1 and config 2 fused), also what bounds the v2
compositor's span: the frame's sorted entries composited whole and with
each tile alone (the other tiles' counts set to 0), the chunks each tile
walks before its exit (from the plain version), K3's device time by kernel
and the tiles its first pass hands to its second (`tile_walk`). With
--scene, the same on the benchmark's scene of that name (`portbench/`'s
scene maker and orbit camera, `cell_walks`) at several yaws, and no frame
profile. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def sorted_frame(entries, cfg) -> tuple:
    from wgpu_3dgs_viewer_app_tpu_torch.ops import sort_entries

    return sort_entries(entries, cfg), cfg


def config1_sorted(g, cam) -> tuple:
    """The config-1 frame's sorted entries, as `Viewer.render` makes them."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu_torch.ops import TileConfig, enumerate_entries_fused

    comp, pod = card.pod_tensors(g, "cuda")
    cfg = TileConfig(1920, 1080, tile=32, max_dup=4)
    proj = cam.projection(1920 / 1080)
    return sorted_frame(enumerate_entries_fused(pod, comp, cfg, cam.view(), proj,
                                                np.eye(4, dtype=np.float32)), cfg)


def tile_walk(se, cfg, top: int = 6) -> dict:
    """The v2 compositor (Horner, the viewer's call) on the whole frame and on
    each tile alone; a tile alone takes its time less that of a launch with
    every count 0 (mean of 3 calls by CUDA events, so below the host's
    launch time it reads ~0). With the chunks each tile walks (the plain
    version's stats), the tiles that walk more than 2, 4, 8 and 16 of them,
    the waves of the first launch (tiles over 4 blocks an SM at tiles up to
    32 px, one above), K3's device time by kernel under torch.profiler (its
    first pass and, where there is one, its second), and the tiles and
    chunks the first pass hands on (`trace.k3_resumed`; None at tiles that
    K3 does not split by a budget). Prints one line; returns the numbers."""
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import composite_tiles_plain_v2, composite_tiles_v2
    from wgpu_3dgs_viewer_app_tpu_torch.utils import trace

    def ms(s, reps):
        return card.cuda_ms(lambda: composite_tiles_v2(s, cfg), reps)

    zero = se.ranged(se.tile_starts, se.tile_counts.new_zeros(se.tile_counts.shape))
    whole, empty = ms(se, 20), ms(zero, 20)
    alone = []
    for t in range(cfg.n_tiles):
        counts = zero.tile_counts.clone()
        counts[t] = se.tile_counts[t]
        alone.append(ms(se.ranged(se.tile_starts, counts), 3) - empty)
    work = {}
    composite_tiles_plain_v2(se, cfg, stats=work)
    walked = work["walked"].tolist()
    order = sorted(range(cfg.n_tiles), key=lambda t: -alone[t])
    slow = [{"tile": t, "alone_us": alone[t] * 1e3, "chunks": walked[t],
             "entries": int(se.tile_counts[t])} for t in order[:top]]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    found = card.device_kernel_ms(lambda: composite_tiles_v2(se, cfg), 20)
    kernels_ms = ({} if found is None else
                  {k: v for k, v in found[0].items() if "composite_v2_kernel" in k})
    trace.reset()
    with trace.collect():
        composite_tiles_v2(se, cfg)
    resumed = trace.k3_resumed()
    trace.reset()
    r = {"whole_us": whole * 1e3, "empty_us": empty * 1e3,
         "median_alone_us": sorted(alone)[cfg.n_tiles // 2] * 1e3, "slowest": slow,
         "slowest_share": alone[order[0]] / whole, "tiles": cfg.n_tiles,
         "chunks_mean": work["rows"] / cfg.n_tiles, "chunks_max": max(walked),
         "walk_over": {k: sum(1 for w in walked if w > k) for k in (2, 4, 8, 16)},
         "waves": cfg.n_tiles / (sms * (4 if cfg.tile <= 32 else 1)),
         "k3_device_us": {k: v * 1e3 for k, v in kernels_ms.items()},
         "resumed": resumed}
    print(f"K3 tile walk: whole {r['whole_us']:.1f} us, empty launch {r['empty_us']:.1f} us; "
          f"a tile alone: median {r['median_alone_us']:.1f} us, slowest: "
          + "; ".join(f"tile {d['tile']}: {d['alone_us']:.1f} us, {d['chunks']} chunks walked, "
                      f"{d['entries']} entries" for d in slow)
          + f"; slowest alone / whole {r['slowest_share']:.3f}; chunks walked per tile: mean "
          f"{r['chunks_mean']:.2f}, max {r['chunks_max']}, tiles over 2/4/8/16 chunks "
          f"{'/'.join(str(v) for v in r['walk_over'].values())} of {cfg.n_tiles}; "
          f"{r['waves']:.2f} waves on {sms} SMs; K3 device "
          + ", ".join(f"{k[:60]} {v:.1f} us" for k, v in r["k3_device_us"].items())
          + f"; resumed (tiles, chunks) {resumed}", flush=True)
    return r


def cell_driver(name: str, seed: int) -> tuple:
    """A benchmark cell on the card (`portbench/harness`): its scene from the
    seed and its program set up and warmed as a run of the cell does them
    (the edit cell's mask evaluated and each gesture made once). Returns the
    cell, its driver and its viewer."""
    sys.path.insert(0, os.path.join(REPO, "portbench"))
    from harness import drive, spec
    from harness import scene as cell_scene

    cell = spec.resolve(name)
    d = drive.make(cell, cell_scene.make_models(cell.config, seed, "cuda"), seed, "cuda", False)
    d.warm(int(cell.traffic.get("warm_steps", 3)))
    return cell, d, d.session.viewer if hasattr(d, "session") else d.viewer


def cell_sorted(cell, v, yaw: float) -> tuple:
    """The sorted entries and config of the cell's frame at orbit `yaw`
    (radians), as its viewer makes them: the merged entries where several
    models show, gated by what the viewer's buffers hold."""
    from harness import drive
    from harness import reference as ref
    from wgpu_3dgs_viewer_app_tpu_torch.ops import sort_entries

    v.update_camera(drive.port_camera(ref.camera_at(cell.config, yaw)))
    order = v.model_order()
    if len(order) > 1:
        ent, cfg = v.merged_entries(order)
    else:
        ent, cfg = v._model_entries(order[0], v.cfg, 0, False), v.cfg
    return sort_entries(ent, cfg), cfg


def cell_walks(scene: str, yaws: int, seed: int) -> list:
    """`tile_walk` on a benchmark scene (the `<scene>.orbit` cell's
    configuration, viewer and seed) at `yaws` orbit yaws spread evenly over
    the circle."""
    import math

    cell, _, v = cell_driver(f"{scene}.orbit", seed)
    out = []
    for k in range(yaws):
        yaw = 2.0 * math.pi * k / yaws
        se, cfg = cell_sorted(cell, v, yaw)
        print(f"{scene} seed {seed}, yaw {math.degrees(yaw):.1f} deg:", end=" ", flush=True)
        out.append({"yaw_deg": math.degrees(yaw), **tile_walk(se, cfg)})
        del se
    return out


def main() -> int:
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch.ops import TileConfig, kernels
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, choices=(1, 2, 3), default=3)
    ap.add_argument("--route", choices=("fused", "staged", "v1", "rows"), default="fused",
                    help="config 2: front-end route (fused, staged); config 1: v1 or rows for "
                         "phase 7's frames")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--tiles", action="store_true",
                    help="config 1 or config 2 fused: also time the compositor tile by tile")
    ap.add_argument("--scene", choices=("inria6m", "multi3x1m"),
                    help="with --tiles: the benchmark's scene of that name (the orbit cell's) "
                         "instead of a BASELINE config, at --yaws orbit yaws")
    ap.add_argument("--yaws", type=int, default=5)
    ap.add_argument("--seed", type=int, default=3200000003, help="--scene: the cell's seed")
    ap.add_argument("--out", help="--scene: write the numbers as JSON here")
    args = ap.parse_args()
    if args.scene and not args.tiles:
        ap.error("--scene applies with --tiles")
    if args.route not in {1: ("fused", "v1", "rows"), 2: ("fused", "staged"), 3: ("fused",)}[
            args.config]:
        ap.error(f"--route {args.route} does not apply to --config {args.config}")
    if args.tiles and not args.scene and (args.config == 3 or args.route != "fused"):
        ap.error("--tiles applies to --config 1 or 2 on the fused route")
    if not torch.cuda.is_available():
        print("profile_port_frame: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    kernels.library()
    if args.scene:
        walks = cell_walks(args.scene, args.yaws, args.seed)
        print(smi)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"scene": args.scene, "seed": args.seed, "smi": smi, "yaws": walks}, f)
        return 0
    if args.config == 2:
        models = card.config2_models()
        n_splats, what = sum(g.count for g in models), f"config 2 ({args.route} route)"
        v = card.config2_viewer(models, "cuda", fused=args.route == "fused")
        step = v.render
        sorted_entries = lambda: sorted_frame(*v.merged_entries(v.model_order()))
    elif args.config == 1 and args.route in ("v1", "rows"):
        g, cam = card.config1_scene()
        n_splats, what = g.count, f"config 1 ({args.route} route)"
        comp, pod = card.pod_tensors(g, "cuda")
        cfg = TileConfig(1920, 1080, tile=32, max_dup=4)
        step = (card.v1_frame(pod, comp, cfg, cam) if args.route == "v1"
                else card.rows_frame(pod, comp, cfg, cam))
    else:
        g, cam = card.config1_scene() if args.config == 1 else card.config3_scene()
        n_splats, what = g.count, f"config {args.config}"
        v = Viewer(g, 1920, 1080, tile=32, max_dup=4, device="cuda")
        v.update_camera(cam)
        step = v.render if args.config == 1 else card.config3_step(v)
        sorted_entries = lambda: config1_sorted(g, cam)

    step()
    wall, busy, rows = card.profile_frames(step, args.frames)
    print(f"{what}: {n_splats} splats, {args.frames} frames, {wall:.3f} ms wall "
          f"({wall / args.frames:.3f} ms/frame under the profiler), device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for name, ms, count in rows:
        print(f"  {ms:8.3f} ms/frame  {ms * args.frames / busy:6.1%}  x{count:<3d} {name[:90]}")
    if args.tiles:
        tile_walk(*sorted_entries())
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
