"""The readings that the comparison limits are set from (not run by the
benchmark's own runs).

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]

For each of `--seeds`, one short run of the cell at its own size (the
program, judged as every run is judged): its numbers are the lower
readings. For each of `--control-seeds`, the control: the plain reference
computed in bfloat16, the nearest precision below the float32 the
configuration states, put in the program's place at the same inputs (the
cell's own camera path, mask, selection and quality) and judged against
the float32 reference by the same comparisons: its numbers are the upper
readings. Prints one JSON line per reading and a summary line."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def control_samples(cell, models, seed: int, device, dtype, n: int = 3) -> list:
    """The control's outputs at `n` steps of the cell's own traffic: the
    reference's frames in `dtype` at orbit views drawn from this seed, with
    the mix's mask, a rect selection and gizmos where the mix has them."""
    import numpy as np

    from harness import check
    from harness import reference as ref

    R = ref.Reference(cell.config, models, device, dtype=dtype)
    rng = np.random.Generator(np.random.SFC64(seed))
    t = cell.traffic
    out = []
    for k in range(n):
        yaw = float(rng.uniform(0.0, 6.283185307179586))
        snap = {"i": k, "yaw": yaw}
        if t["entry"] == "viewer":
            snap["img"] = R.frame(ref.camera_at(cell.config, yaw))
        else:
            shapes = ref.placed_shapes(cell.config, t)
            sel = None
            if "rect" in t:
                w, h = cell.config["width"], cell.config["height"]
                sel = {"gesture": "rect_select", "yaw": yaw,
                       "rect": ((0.25 * w, 0.25 * h), (0.6 * w, 0.7 * h)), "shapes": shapes}
            snap.update(shapes=shapes, selection=sel)
            gates = check.session_gates(R, t, snap)
            img = R.frame(ref.camera_at(cell.config, yaw), gates=[gates],
                          shapes=ref.mask_shapes(shapes))
            snap["img"] = img
        out.append(snap)
    del R
    return out


def control_numbers(cell, models, seed: int, device) -> dict:
    import numpy as np
    import torch

    from harness import check
    from harness import reference as ref

    low = control_samples(cell, models, seed, device, torch.bfloat16)
    numbers: dict = {}
    R = ref.Reference(cell.config, models, device)
    if cell.traffic["entry"] == "server":
        from gsref.utils import jpeg

        q = int(cell.traffic.get("quality", 85))
        real = check.real_blocks(cell.config["width"], cell.config["height"])
        for snap in low:
            gates = check.session_gates(R, cell.traffic, snap)
            want = R.frame(ref.camera_at(cell.config, snap["yaw"]), gates=[gates],
                           shapes=ref.mask_shapes(snap["shapes"]))
            a = jpeg.coefficients(jpeg.frame_to_u8(want), q).cpu().numpy()[real]
            b = jpeg.coefficients(jpeg.frame_to_u8(snap["img"]), q).cpu().numpy()[real]
            gap = np.abs(a.astype(np.int64) - b)
            numbers["jpeg_coef_max_abs"] = max(numbers.get("jpeg_coef_max_abs", 0.0),
                                               float(gap.max()))
            numbers["jpeg_coef_mean_abs"] = max(numbers.get("jpeg_coef_mean_abs", 0.0),
                                                float(gap.mean()))
    else:
        check.judge_frames(R, cell, low, numbers)
    return numbers


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    import torch

    import run
    from harness import scene, spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    summary = {"program": {}, "control": {}}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        res = run.execute(cell, seed, args.seconds, False, "cuda", time.perf_counter())
        nums = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed,
                          "correct": res["correct"], "numbers": nums}), flush=True)
        for k, v in nums.items():
            if v is not None:
                summary["program"][k] = max(summary["program"].get(k, v), v)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        models = scene.make_models(cell.config, seed, "cuda")
        nums = control_numbers(cell, models, seed, "cuda")
        print(json.dumps({"workload": cell.name, "side": "control", "seed": seed,
                          "numbers": nums}), flush=True)
        for k, v in nums.items():
            summary["control"][k] = min(summary["control"].get(k, v), v)
        del models
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
