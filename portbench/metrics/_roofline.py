"""Shared by the roofline readers: a stage's share of its roofline, in %,
over the traced frames: the least time the card could take for the
frames' work (`harness/counts.py`) over the time the stage's kernels ran
(`stages.json`). None where the trace or the counts are missing, or the
profiler kept fewer kernels than the port launched."""


def share(ctx: dict, stage: str):
    from harness import counts

    tr, work = ctx.get("trace"), ctx.get("stage_work")
    if not tr or not work or tr.get("short") or stage not in work:
        return None
    t = tr["stage_s"].get(stage)
    if not t:
        return None
    return 100.0 * counts.bound_s(work[stage], ctx["peaks"])[0] / t
