"""`k4_geometry.roofline_pct`: the query geometry kernel K4's share of its
roofline over the traced frames, in %: the least time the card could take
for the work of the K4 launches the port counted in the traced window
(`_k4_work.py`, from the splats and compression the entry reports) over
the time the `k4_geometry` stage's kernels ran (`stages.json`). None where
the trace, the launches or the entry's counts are missing, or the profiler
kept fewer K1 or K3 kernels than the port launched."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_k4_work",
                                               Path(__file__).with_name("_k4_work.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    from harness import counts

    tr, info = ctx.get("trace"), ctx.get("info") or {}
    if not tr or tr.get("short") or "k4_cov3d" not in info:
        return None
    t = tr["stage_s"].get("k4_geometry")
    n = tr.get("launched", {}).get("geometry", 0)
    if not t or not n:
        return None
    work = _mod.k4(n * int(info["splats"]), info["k4_cov3d"], bool(info["k4_masked"]))
    return 100.0 * counts.bound_s(work, ctx["peaks"])[0] / t
