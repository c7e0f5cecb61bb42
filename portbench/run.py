"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`: a configuration under a traffic mix) is set up
from the seed (scene, program, warm-up; that is `setup_s`), driven for
`--seconds` in a closed loop, and its kept outputs are then held against
the plain reference. With `--trace 0` the result carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics and the device
trace's `busy_s`, `window_s` and `breakdown`. Every number compared is
printed beside its limit on standard error and under `checks`, the last key
of the result line, which is the last line of standard output. The run
needs a CUDA device and never falls back to the CPU."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

FORBIDDEN = {"jax", "jaxlib", "flax", "wgpu_3dgs_viewer_app_tpu"}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stage_work_of(cell, R, yaw0: float, step_rad: float) -> dict:
    """(bytes, operations) of K1, K2 and K3 summed over the traced frames,
    from the reference's counts of each frame's splats, live entries and
    blends before the pixels' exits."""
    from harness import counts
    from harness import reference as ref

    cfg = cell.config
    deg = int(cfg.get("sh_degree", 3))
    pod_b = counts.pod_bytes_per_splat(cfg["compressions"]["sh"], cfg["compressions"]["cov3d"],
                                       deg)
    work: dict = {}
    for k in range(int(cell.traffic.get("trace_steps", 20))):
        st: dict = {}
        R.frame(ref.camera_at(cfg, yaw0 + k * step_rad), stats=st)
        for name, (b, o) in (("k1_frontend", counts.k1(st["splats"], st["live_entries"], pod_b,
                                                       deg)),
                             ("k2_sort", counts.k2(st["live_entries"], st["n_tiles"])),
                             ("k3_composite", counts.k3(st["blends"], st["entries_read"],
                                                        st["pixels"]))):
            b0, o0 = work.get(name, (0, 0))
            work[name] = (b0 + b, o0 + o)
    return work


def execute(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Set up, drive and judge one run of `cell` on `device`. Returns the
    result (without `metrics` for the metrics the run could not read)."""
    import torch

    from harness import check, counts, drive, scene, spec
    from harness import reference as ref
    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    models = scene.make_models(cell.config, seed, device)
    d = drive.make(cell, models, seed, device, trace)
    d.warm(int(cell.traffic.get("warm_steps", 3)))
    setup_s = time.perf_counter() - t0
    log(f"[portbench] {cell.name} seed {seed}: set-up {setup_s:.3f} s; {d.info}")

    traced, first = None, 0
    if trace:
        n_trace = int(cell.traffic.get("trace_steps", 20))

        def steps():
            for i in range(n_trace):
                d.step(i, record=False)
        if cuda:
            from harness import trace as tr

            traced = tr.profile(steps, kernels.LAUNCHES)
        else:
            steps()
        first = n_trace

    d.samples.seen = 0
    for name in d.spans:
        if name != "loader.load_s":
            d.spans[name].clear()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = first
    while time.perf_counter() < t_end:
        d.step_ms.append(d.step(i))
        i += 1
    window = {"window_s": time.perf_counter() - t_start, "steps": i - first,
              "step_ms": d.step_ms, "gesture_ms": getattr(d, "gesture_ms", []),
              "setup_s": setup_s}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"[portbench] JAX or the JAX package is loaded: {bad}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # The program's state goes before the reference runs.
    samples = d.kept()
    final = d.final_bits()
    spans, info = d.spans, d.info
    yaw0, step_rad, d_counts_stages = d.yaw0, d.step_rad, d.counts_stages
    d.close()
    del d
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    R = ref.Reference(cell.config, models, device)
    numbers: dict = {}
    if samples and "img" in samples[0]:
        check.judge_frames(R, cell, samples, numbers)
    elif samples and "jpeg" in samples[0]:
        check.judge_served(R, cell, samples, yaw0, numbers)
    if final is not None:
        check.judge_bits(R, cell, final, numbers)
    stage_work = None
    if trace and d_counts_stages:
        stage_work = stage_work_of(cell, R, yaw0, step_rad)
    ref_s = time.perf_counter() - t_ref
    ok, rows = check.verdict(numbers, cell.limits)

    result = {"correct": bool(ok), "attempted": window["steps"], "failed": 0}
    if trace:
        ctx = {"trace": traced, "stage_work": stage_work, "spans": spans, "info": info,
               "peaks": counts.peaks()}
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = spec.end_to_end_reader(m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["device"] = dev
    log(f"[portbench] window {window['window_s']:.3f} s, {window['steps']} steps; reference "
        f"{ref_s:.3f} s; info {info}")
    if traced is not None:
        log(f"[portbench] trace: attempt {traced['attempt']}, launched {traced['launched']}, "
            f"kept {traced['kept']}, stages {traced['stage_s']}, short {traced.get('short')}")
    log(f"[portbench] numbers compared and not: {numbers}")
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[portbench] {cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    # The port builds its kernels and codec into a fixed directory inside
    # the checkout; any other cache of the run goes under HOME or TMPDIR.
    os.environ.setdefault("GS_TORCH_BUILD_DIR",
                          str(HERE.parent / "wgpu_3dgs_viewer_app_tpu_torch" / "_build"))
    log(f"[portbench] {power_limit()}")
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    checks = result.pop("checks")
    for name, c in checks.items():
        log(f"{name} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
