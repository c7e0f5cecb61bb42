"""The device trace of a few steps: torch.profiler over CUDA and the host.

From it come the seconds each stage's kernels ran (kernel names mapped to
stages by `stages.json`), the device's busy time (the union of every
device operation's interval) against the traced window's wall time, and
the breakdown: the device operations that took most time and the longest
gaps in which the device was idle, each named by the host operation that
ran through it. CUPTI now and then keeps fewer kernels than were
launched, so a session whose kernel counts fall short of the port's own
launch counters is made again, up to TRIES times."""

from __future__ import annotations

import json
import time

from .spec import HERE

TRIES = 3
# Kernel names in the breakdown are cut to this many characters (C++
# template names run to several hundred).
NAME_CHARS = 120
# The port's launch counters and the kernel each one launches once.
COUNTED = {"fused": "fused_frontend_kernel", "composite": "composite_v2_kernel"}


def stage_map() -> dict:
    with open(HERE / "stages.json") as f:
        return {k: v for k, v in json.load(f).items() if k != "about"}


def stage_of(name: str, stages: dict):
    for stage, pats in stages.items():
        if any(p in name for p in pats):
            return stage
    return None


def _union(intervals: list) -> tuple:
    """(busy seconds, [(gap start, gap end)]) of sorted (start, end) us."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, gaps


def _host_op(cpu: list, a: float, b: float) -> str:
    """What the host did through the gap (a, b): the innermost traced host
    operation that spans its middle, or else the host's untraced Python
    between the last operation that ended before the middle and the first
    that starts after it."""
    mid = 0.5 * (a + b)
    best = prev = nxt = None
    for name, s, e in cpu:
        if s <= mid <= e:
            if best is None or e - s < best[2] - best[1]:
                best = (name, s, e)
        elif e < mid and (prev is None or e > prev[1]):
            prev = (name, e)
        elif s > mid and (nxt is None or s < nxt[1]):
            nxt = (name, s)
    if best is not None:
        return best[0]
    return f"host between {prev[0] if prev else 'start'} and {nxt[0] if nxt else 'end'}"


def profile(run_steps, launches: dict) -> dict | None:
    """Profile `run_steps()` (which syncs at its end); `launches` is the
    port's LAUNCHES dict. Returns the reading, or None where no session saw
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    stages = stage_map()
    result = None
    for attempt in range(TRIES):
        before = dict(launches)
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_steps()
            window_s = time.perf_counter() - t0
        launched = {k: launches[k] - before.get(k, 0) for k in launches}
        dev, cpu = [], []
        for e in prof.events():
            tr = e.time_range
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                dev.append((e.name, tr.start, tr.end))
            else:
                cpu.append((e.name, tr.start, tr.end))
        if not dev:
            continue
        kept = {k: sum(1 for n, _, _ in dev if COUNTED[k] in n) for k in COUNTED}
        short = {k: (kept[k], launched.get(k, 0)) for k in COUNTED
                 if kept[k] < launched.get(k, 0)}
        busy_s, gaps = _union([(s, e) for _, s, e in dev])
        per_op, per_stage = {}, {}
        for n, s, e in dev:
            per_op[n] = per_op.get(n, 0.0) + (e - s) * 1e-6
            st = stage_of(n, stages)
            if st is not None:
                per_stage[st] = per_stage.get(st, 0.0) + (e - s) * 1e-6
        gaps.sort(key=lambda g: g[0] - g[1])
        result = {
            "busy_s": busy_s, "window_s": window_s, "stage_s": per_stage,
            "launched": launched, "kept": kept, "attempt": attempt + 1,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], s] for n, s in sorted(per_op.items(),
                                                                      key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[_host_op(cpu, a, b)[:NAME_CHARS], (b - a) * 1e-6]
                              for a, b in gaps[:10]],
            },
        }
        if not short:
            return result
        result["short"] = short
    return result
