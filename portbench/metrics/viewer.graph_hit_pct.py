"""`viewer.graph_hit_pct`: the share of the traced frames that the viewer
issued as one CUDA graph launch, in %: frames that replayed a kept graph,
and the frame on which a graph was captured (and then launched), over every
frame the viewer issued on its fused route on the card (the rest were
issued eager, launch by launch, on a key the viewer had not seen twice in a
row). The port counts its frames while its spans record
(`trace.graph_frames`: replayed, captured, eager), i.e. over the `--trace 1`
run's profiled steps. None where the port has no such counter or counted no
frame."""


def read(ctx: dict):
    try:
        from wgpu_3dgs_viewer_app_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = getattr(trace, "graph_frames", None)
    if not counts:
        return None
    total = sum(counts.values())
    if not total:
        return None
    return 100.0 * (counts["replayed"] + counts["captured"]) / total
