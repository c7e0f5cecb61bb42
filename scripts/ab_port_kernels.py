#!/usr/bin/env python3
"""Old against new on one card: the entry sort K2 and the v2 compositor of
this tree against those of another checkout of the port (the parent commit,
unpacked with `git archive` under a git-ignored directory), on the same
config-1 and config-2 entries, timed in turns (other, this, this, other).

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/ab_port_kernels.py --parent _archive/parent

The other checkout's package is imported under another name, so both kernel
libraries are built and loaded in one process. Each time is the mean of 20
calls by CUDA events (`chip_smoke.cuda_ms`). The compositor runs in every
mode of `composite_tiles_v2` that differs on the card: transposed Horner
(the viewer's call), row-major Horner and the quadratic basis (`mxu`); in
the parent each of those named one of two kernels. Outputs are checked: the
two sorts row for row (both are stable), the compositors within 1e-4 where
both walk the reference's chunks. Last, the config-1 frame through each
tree's `Viewer.render`, 5 frames after 2 warm-ups by the host clock, in
turns. Prints one line per comparison, the card's
name and power limit, and a JSON record as the last line. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = "wgpu_3dgs_viewer_app_tpu_torch"


def load_other(root: str, alias: str = "other_port"):
    """The port package of another checkout, imported as `alias`."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops")


def turns(other, this, reps: int = 20) -> dict:
    """ms of other() and this() in the order other, this, this, other."""
    import chip_smoke

    a1, b1, b2, a2 = (chip_smoke.cuda_ms(f, reps) for f in (other, this, this, other))
    return {"other_ms": [a1, a2], "this_ms": [b1, b2]}


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from wgpu_3dgs_viewer_app_tpu_torch import ops
    from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_sorted

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_port_kernels: no CUDA device", file=sys.stderr)
        return 1
    old = load_other(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    ops.kernels.library()
    old.kernels.library()

    g1, cam1 = chip_smoke.config1_scene()
    comp, pod = chip_smoke.pod_tensors(g1, "cuda")
    cfg1 = ops.TileConfig(1920, 1080, tile=32, max_dup=4)
    ent1 = ops.enumerate_entries_fused(pod, comp, cfg1, cam1.view(), cam1.projection(1920 / 1080),
                                       np.eye(4, dtype=np.float32))
    del pod, g1
    v2 = chip_smoke.config2_viewer(chip_smoke.config2_models(), "cuda")
    ent2, cfg2 = v2.merged_entries(v2.model_order())
    del v2
    torch.cuda.empty_cache()

    rec = {}
    for cell, ent, cfg in (("config1", ent1, cfg1), ("config2", ent2, cfg2)):
        se = ops.sort_entries(ent, cfg)
        se_old = old.sort_entries(ent, cfg)
        compare_sorted(se, se_old, stable=True)
        r = {"sort": turns(lambda: old.sort_entries(ent, cfg), lambda: ops.sort_entries(ent, cfg)),
             "slots": ent.shape[0], "live": se.n_valid}
        print(f"{cell} K2: {ent.shape[0]} slots, {se.n_valid} live, outputs equal row for row; "
              f"other {r['sort']['other_ms']}, this {r['sort']['this_ms']} ms [{smi}]",
              flush=True)
        ref = ops.composite_tiles_plain_v2(se, cfg) if cell == "config1" else None
        for mode, kw in (("transposed_horner", {}), ("rows_horner", {"transposed": False}),
                         ("rows_basis", {"transposed": False, "mxu": True})):
            got = ops.composite_tiles_v2(se, cfg, **kw)
            got_old = old.composite_tiles_v2(se, cfg, **kw)
            d = float((got - got_old).abs().max())
            # The parent's transposed kernel exits per 256-entry batch (<= 1/255).
            lim = 1.0 / 255.0 + 1e-5 if mode == "transposed_horner" else 1e-4
            if d > lim:
                raise AssertionError(f"{cell} {mode}: this vs other max abs {d} > {lim}")
            r[mode] = turns(lambda: old.composite_tiles_v2(se, cfg, **kw),
                            lambda: ops.composite_tiles_v2(se, cfg, **kw))
            r[mode]["vs_other_max"] = d
            if ref is not None and mode != "rows_basis":
                r[mode]["vs_plain_max"] = float((got - ref).abs().max())
            print(f"{cell} compositor {mode}: this vs other max abs {d:.3e}; other "
                  f"{r[mode]['other_ms']}, this {r[mode]['this_ms']} ms", flush=True)
        rec[cell] = r
        del se, se_old
    # The config-1 frame through each tree's Viewer.render, in turns.
    del ent1, ent2
    torch.cuda.empty_cache()
    g1, cam1 = chip_smoke.config1_scene()
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer
    old_viewer = importlib.import_module("other_port.viewer")
    views = {"other": old_viewer.Viewer(g1, 1920, 1080, tile=32, max_dup=4, device="cuda"),
             "this": Viewer(g1, 1920, 1080, tile=32, max_dup=4, device="cuda")}
    frames = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        ms = chip_smoke.timed_frames(lambda: views[side].render(cam1))[0]
        frames[side].append(ms)
    d = float((views["this"].render(cam1) - views["other"].render(cam1)).abs().max())
    rec["config1_frame"] = {"other_ms": frames["other"], "this_ms": frames["this"],
                            "vs_other_max": d}
    print(f"config1 frame (Viewer.render, 5 frames after 2 warm-ups): other {frames['other']}, "
          f"this {frames['this']} ms; images max abs {d:.3e}", flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
