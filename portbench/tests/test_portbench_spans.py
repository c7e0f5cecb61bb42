"""The six span readers (`metrics/viewer.*`, `host.*`, `session.segments_ms`,
`session.mask_upload_ms`) on hand-built records of the port's tracing
module: their values, None where their spans are missing or the port has
no such module, and the division by the frames over one to three profiler
attempts, which repeat the same steps."""

import sys

import pytest

import _portbench_toy as toy  # noqa: F401  (puts the benchmark on sys.path)
from harness import spec
from wgpu_3dgs_viewer_app_tpu_torch.utils import trace

READERS = ("viewer.prologue_ms", "viewer.wrappers_ms", "host.sync_wait_ms",
           "host.syncs_per_frame", "session.segments_ms", "session.mask_upload_ms")
MS = 1_000_000   # ns


def _orbit_frame(t0: int, base: int, reads: bool = True) -> list:
    """One traced viewer frame from t0 (ms), its records' parents and frame
    offset by `base`: prologue 1 ms, K1's wrapper 0.5, K2's 1 with a 0.25 ms
    read, K3's 2 with a 0.5 ms read (`reads` False: no read)."""
    R, f = trace.Record, base
    recs = [R("viewer.render", t0 * MS, (t0 + 5) * MS, None, f),
            R("viewer.prologue", t0 * MS, (t0 + 1) * MS, f, f),
            R("k1.frontend", (t0 + 1) * MS, int((t0 + 1.5) * MS), f, f),
            R("k2.sort", int((t0 + 1.5) * MS), int((t0 + 2.5) * MS), f, f),
            R("host.read", int((t0 + 2) * MS), int((t0 + 2.25) * MS), f + 3, f),
            R("k3.composite", int((t0 + 2.5) * MS), int((t0 + 4.5) * MS), f, f),
            R("host.read", 4 * MS + t0 * MS, int((t0 + 4.5) * MS), f + 5, f)]
    if not reads:   # no record refers to them or to what follows them
        del recs[6], recs[4]
    return recs


def _edit_frame(t0: int, base: int, drag: bool) -> list:
    """One traced session frame: the viewer frame above under
    `session.update`, the segment build (0.75 ms), and with `drag` an
    EvaluateMask whose upload takes 10 ms."""
    R, f = trace.Record, base
    recs = [R("session.update", t0 * MS, (t0 + 20) * MS, None, f)]
    if drag:
        recs += [R("session.drain", t0 * MS, (t0 + 12) * MS, f, f),
                 R("session.evaluate_mask", t0 * MS, (t0 + 12) * MS, f + 1, f),
                 R("mask.upload", t0 * MS, (t0 + 10) * MS, f + 2, f),
                 R("host.read", t0 * MS, (t0 + 10) * MS, f + 3, f)]
    v = _orbit_frame(t0 + 12, 0)
    first = len(recs) + base
    for r in v:
        r.parent = f if r.parent is None else r.parent + first
        r.frame = f
    recs += v
    so = len(recs) + base
    recs += [R("session.overlays", (t0 + 18) * MS, (t0 + 19) * MS, f, f),
             R("overlays.segments", (t0 + 18) * MS, int((t0 + 18.75) * MS), so, f)]
    return recs


def _orbit(frames: int, attempts: int) -> list:
    recs = []
    for _ in range(attempts):
        for k in range(frames):
            recs += _orbit_frame(10 * (len(recs) + k), len(recs))
    return recs


def _edit(attempts: int) -> list:
    recs = []
    for _ in range(attempts):
        for k in range(4):
            recs += _edit_frame(30 * (len(recs) + k), len(recs), drag=k == 1)
    return recs


def _read(monkeypatch, recs, dropped=0) -> dict:
    monkeypatch.setattr(trace, "records", recs)
    monkeypatch.setattr(trace, "dropped", dropped)
    return {n: spec.metric_reader(n)({"trace": None}) for n in READERS}


@pytest.mark.parametrize("attempts", [1, 2, 3])
def test_orbit_readings_per_frame(monkeypatch, attempts):
    got = _read(monkeypatch, _orbit(3, attempts))
    assert got["viewer.prologue_ms"] == pytest.approx(1.0)
    # Wrappers' self time: 0.5 + (1 - 0.25) + (2 - 0.5).
    assert got["viewer.wrappers_ms"] == pytest.approx(2.75)
    assert got["host.sync_wait_ms"] == pytest.approx(0.75)
    assert got["host.syncs_per_frame"] == 2
    assert got["session.segments_ms"] is None and got["session.mask_upload_ms"] is None


@pytest.mark.parametrize("attempts", [1, 2, 3])
def test_edit_readings_per_frame_and_per_evaluation(monkeypatch, attempts):
    got = _read(monkeypatch, _edit(attempts))
    assert trace.frame_roots(trace.records) == [i for i, r in enumerate(trace.records)
                                                if r.name == "session.update"]
    assert got["viewer.prologue_ms"] == pytest.approx(1.0)
    assert got["session.segments_ms"] == pytest.approx(0.75)
    assert got["session.mask_upload_ms"] == pytest.approx(10.0)
    # Four frames, one with the upload's wait: (4 * 0.75 + 10) / 4 ms, 9 / 4 reads.
    assert got["host.sync_wait_ms"] == pytest.approx(3.25)
    assert got["host.syncs_per_frame"] == pytest.approx(2.25)


def test_none_where_spans_are_missing(monkeypatch):
    assert set(_read(monkeypatch, []).values()) == {None}
    # Spans but no frame root (a gesture's read outside update()).
    assert set(_read(monkeypatch, [trace.Record("host.read", 0, 5)]).values()) == {None}
    # Some records dropped at the cap.
    assert set(_read(monkeypatch, _orbit(2, 1), dropped=1).values()) == {None}
    # Frames with no read: the host readers read 0, the others what is there.
    got = _read(monkeypatch, _orbit_frame(0, 0, reads=False) + _orbit_frame(10, 5, reads=False))
    assert got["host.syncs_per_frame"] == 0 and got["host.sync_wait_ms"] == 0
    assert got["viewer.wrappers_ms"] == pytest.approx(3.5)


def test_none_on_a_program_without_the_module(monkeypatch):
    import wgpu_3dgs_viewer_app_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "wgpu_3dgs_viewer_app_tpu_torch.utils.trace", None)
    assert {n: spec.metric_reader(n)({"trace": None}) for n in READERS} == dict.fromkeys(
        READERS)
