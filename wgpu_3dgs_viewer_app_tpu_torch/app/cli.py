"""Command-line entry point: offline rendering of a PLY to PNG.

Usage:
  python -m wgpu_3dgs_viewer_app_tpu_torch.app.cli render model.ply -o out.png \
      [--width 1920 --height 1080 --sh-deg 3 --mode splat --orbit 30 --device cuda]

The interactive `serve` command waits for the app port (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def cmd_render(args) -> int:
    import torch

    from ..core.camera import CameraOrbitControl
    from ..core.transform import GaussianDisplayMode, GaussianShDegree
    from ..data.compression import Compressions, Cov3dCompression, ShCompression
    from ..data.ply import read_ply
    from ..utils.png import write_png
    from ..viewer.viewer import Viewer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device available (use --device cpu)", file=sys.stderr)
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
    yaw = math.radians(args.orbit)
    cam = CameraOrbitControl(
        target=center,
        pos=center + dist * np.array([math.sin(yaw), 0.3, math.cos(yaw)], np.float32),
    )
    img = v.render(cam).cpu().numpy()
    write_png(args.output, np.clip(img * 255.0, 0, 255).astype(np.uint8))
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="3dgs-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="offline render a PLY to PNG")
    r.add_argument("model")
    r.add_argument("-o", "--output", default="out.png")
    r.add_argument("--width", type=int, default=1280)
    r.add_argument("--height", type=int, default=720)
    r.add_argument("--sh-deg", type=int, default=3)
    r.add_argument("--mode", choices=["splat", "ellipse", "point"], default="splat")
    r.add_argument("--size", type=float, default=1.0)
    r.add_argument("--orbit", type=float, default=0.0, help="orbit yaw degrees")
    r.add_argument("--distance", type=float, default=None)
    r.add_argument("--background", type=float, nargs=3, default=[0, 0, 0])
    r.add_argument("--sh-comp", default="norm8", choices=["single", "half", "norm8", "remove"])
    r.add_argument("--cov3d-comp", default="half", choices=["single", "half"])
    r.add_argument("--tile", type=int, default=32, help="screen tile size (px, at most 32)")
    r.add_argument("--max-dup", type=int, default=4,
                   help="tile entries per splat (4 = product default; 8/16 = quality presets)")
    r.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    r.set_defaults(fn=cmd_render)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
