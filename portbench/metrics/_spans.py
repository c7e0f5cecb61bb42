"""Shared by the span readers: the port's span records of the traced steps
(`wgpu_3dgs_viewer_app_tpu_torch.utils.trace`), which record only while a
profiler records, i.e. over the `--trace 1` run's profiled steps (every
attempt of `harness/trace.py::profile`). A frame is a root span named in
the module's `FRAME_ROOTS` (`viewer.render`, `session.update`,
`server.frame`); each reading is per frame, so the attempts' repeats of the
same steps leave it as it is. None where the port has no such records (a
program without the module, or no frame traced) or some were dropped."""


def frames():
    """(the trace module, its records, the number of frames), or None."""
    try:
        from wgpu_3dgs_viewer_app_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = list(trace.records)
    n = len(trace.frame_roots(recs))
    if not n or trace.dropped:
        return None
    return trace, recs, n


def total_ms(names: tuple, self_time: bool = False):
    """(the total time in ms of the spans named in `names`, or their self
    time: without their child spans; the number of frames), or None where
    none was recorded."""
    got = frames()
    if got is None:
        return None
    trace, recs, n = got
    idx = [i for i, r in enumerate(recs) if r.name in names]
    if not idx:
        return None
    ns = trace.self_ns(recs) if self_time else [r.end - r.start for r in recs]
    return 1e-6 * sum(ns[i] for i in idx), n


def per_frame_ms(names: tuple, self_time: bool = False):
    """`total_ms` over the number of frames."""
    got = total_ms(names, self_time)
    return None if got is None else got[0] / got[1]


def count(name: str) -> int:
    got = frames()
    return 0 if got is None else sum(1 for r in got[1] if r.name == name)
