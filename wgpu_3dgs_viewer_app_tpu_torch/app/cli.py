"""Command-line entry points: offline rendering and the interactive server.

Usage:
  python -m wgpu_3dgs_viewer_app_tpu_torch.app.cli render model.ply -o out.png \
      [--width 1920 --height 1080 --sh-deg 3 --mode splat --orbit 30 --device cuda] \
      [--frames N --orbit-step D]
  python -m wgpu_3dgs_viewer_app_tpu_torch.app.cli serve [model.ply ...] \
      [--port 8080 --width 1280 --height 720 --device cuda]

Both run on the card unless `--device cpu` is given; without a CUDA device
`--device cuda` exits with status 2.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def _device(name: str):
    """The torch device asked for, or None (with a message) when it is CUDA
    and there is no CUDA device."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device available (use --device cpu)", file=sys.stderr)
        return None
    return device


def _save_png(path: str, img) -> None:
    from ..utils.jpeg import frame_to_u8
    from ..utils.png import write_png

    write_png(path, frame_to_u8(img).cpu().numpy())


def cmd_render(args) -> int:
    from ..core.camera import CameraOrbitControl
    from ..core.transform import GaussianDisplayMode, GaussianShDegree
    from ..data.compression import Compressions, Cov3dCompression, ShCompression
    from ..data.ply import read_ply
    from ..viewer.viewer import Viewer

    device = _device(args.device)
    if device is None:
        return 2
    g = read_ply(args.model)
    print(f"loaded {g.count:,} splats from {args.model}", file=sys.stderr)
    comp = Compressions(ShCompression(args.sh_comp), Cov3dCompression(args.cov3d_comp))
    v = Viewer(g, args.width, args.height, comp=comp, background=tuple(args.background),
               tile=args.tile, max_dup=args.max_dup, device=device)
    gt = v.gaussian_transform
    gt.sh_deg = GaussianShDegree(args.sh_deg)
    gt.display_mode = GaussianDisplayMode[args.mode.upper()]
    gt.size = args.size

    center = g.center()
    extent = float(np.abs(g.pos - center).max()) or 1.0
    dist = args.distance or extent * 2.0

    def cam_at(deg):
        yaw = math.radians(deg)
        return CameraOrbitControl(
            target=center,
            pos=center + dist * np.array([math.sin(yaw), 0.3, math.cos(yaw)], np.float32),
        )

    if args.frames <= 1:
        _save_png(args.output, v.render(cam_at(args.orbit)))
        print(f"wrote {args.output}", file=sys.stderr)
        return 0

    # Orbit sequence: every frame is queued before the first is read back,
    # then each is written as out_000.png, out_001.png, ...
    stem, dot, ext = args.output.rpartition(".")
    if not dot:
        stem, ext = args.output, "png"
    t0 = time.perf_counter()
    imgs = [v.render(cam_at(args.orbit + i * args.orbit_step)) for i in range(args.frames)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(f"{stem}_{i:03d}.{ext}")
        _save_png(paths[-1], img)
    dt = time.perf_counter() - t0
    print(f"wrote {len(paths)} frames ({paths[0]} .. {paths[-1]}) in "
          f"{dt:.2f}s = {len(paths) / dt:.1f} fps incl. PNG encode", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from ..data.compression import Compressions, Cov3dCompression, ShCompression
    from .server import serve
    from .state import GaussianSplattingSession

    device = _device(args.device)
    if device is None:
        return 2
    comp = Compressions(ShCompression(args.sh_comp), Cov3dCompression(args.cov3d_comp))
    session = GaussianSplattingSession(args.width, args.height, compressions=comp,
                                       device=device, tile=args.tile, max_dup=args.max_dup)
    for path in args.models:
        with open(path, "rb") as f:
            session.open_model(path.split("/")[-1], f)
            while session.loader is not None:
                session._drain_loader()
    serve(session, host=args.host, port=args.port)
    return 0


def _common(p) -> None:
    """Options that `render` and `serve` share."""
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--sh-comp", default="norm8", choices=["single", "half", "norm8", "remove"])
    p.add_argument("--cov3d-comp", default="half", choices=["single", "half"])
    p.add_argument("--tile", type=int, default=32, help="screen tile size (px)")
    p.add_argument("--max-dup", type=int, default=4,
                   help="tile entries per splat (4 = product default; 8/16 = quality presets)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")


def main(argv=None) -> int:
    from ..utils.log import configure

    configure()  # $GS_LOG=debug|info|...
    ap = argparse.ArgumentParser(prog="3dgs-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="offline render a PLY to PNG")
    r.add_argument("model")
    r.add_argument("-o", "--output", default="out.png")
    r.add_argument("--sh-deg", type=int, default=3)
    r.add_argument("--mode", choices=["splat", "ellipse", "point"], default="splat")
    r.add_argument("--size", type=float, default=1.0)
    r.add_argument("--orbit", type=float, default=0.0, help="orbit yaw degrees")
    r.add_argument("--frames", type=int, default=1,
                   help="render an orbit sequence of N frames (out_%%03d.png)")
    r.add_argument("--orbit-step", type=float, default=2.0,
                   help="yaw degrees between sequence frames")
    r.add_argument("--distance", type=float, default=None)
    r.add_argument("--background", type=float, nargs=3, default=[0, 0, 0])
    _common(r)
    r.set_defaults(fn=cmd_render)

    s = sub.add_parser("serve", help="interactive web viewer")
    s.add_argument("models", nargs="*")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    _common(s)
    s.set_defaults(fn=cmd_serve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
