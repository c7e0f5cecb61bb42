"""Spans and counters of the port, on the profiler's timeline.

A span names a stretch of host work at a layer boundary:

    with trace.span("viewer.prologue"):
        ...

Spans record only while a `torch.profiler` session records or inside
`collect()`. Each record holds its name, its host start and end
(`time.perf_counter_ns`), the index of its parent record and the index of
its frame, the outermost span open on its thread (a root: no parent, and
its own index as its frame).
While a profiler records, each span also opens a profiler range of the same
name, so that it sits on the profiler's timeline beside the device's
operations and names the host work the device waits through. The range is a
host event like an aten op's (`_RecordFunctionFast`), not a user annotation
(`record_function`), which the profiler would mirror onto the device's
timeline as if it were device work. Off, a span is one flag check and a
shared null context: nothing is allocated and no clock is read.

Records stay in memory, at most `CAP` of them; spans past the cap are
counted in `dropped`. There is no exporter: a reader takes `records`
in-process (`frame_roots`, `self_ns`) and `reset()` clears them.

Three counters. `launches`, always on: each kernel wrapper's launches
(`ops.kernels.LAUNCHES` is this dict), a plain integer increment; a frame
replayed as a CUDA graph adds the launches its capture made. `k3_handed`,
on the device and only while spans record: the tiles the compositor K3's
first pass hands to its second, and their chunks left, a buffer of two
int64 the kernel adds into (the wrapper passes none while spans are off, so
nothing is counted). Nothing reads it inside a frame: `k3_resumed()` copies
it to the host when a reader asks, after the window, and `reset()` zeroes
it where it lies (a graph captured with it keeps its address). And
`graph_frames`, only while spans record: the viewer's frames on a card by
how the host issued them (`replayed`: a kept CUDA graph launched;
`captured`: captured, then launched; `eager`: launch by launch).
Every point of a frame path where the host waits for the device (a
device-to-host read, or a copy from pageable host memory, which torch ends
with a stream sync) goes through `host_read`, which spans the wait as
`host.read` while spans record: the frame's syncs are its `host.read`
records.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

CAP = 1 << 16
# The spans that open a frame, when outermost.
FRAME_ROOTS = ("viewer.render", "session.update", "server.frame")

records: list = []
dropped = 0
launches = {"fused": 0, "sort": 0, "composite": 0, "geometry": 0, "enum_pack": 0,
            "composite_v1": 0, "preprocess": 0, "overlay": 0}

# The viewer's frames by how they were issued, while spans record.
graph_frames = {"replayed": 0, "captured": 0, "eager": 0}

# K3's handed-on tiles and chunks while spans record, by device
# (`k3_handed`), and whether a K3 ran with one since the last `reset()`.
_k3: dict = {}
_k3_used = False

_collecting = 0
_local = threading.local()   # .stack: [(record index, frame index)] of the open spans
_lock = threading.Lock()


class Record:
    """One span: name, host start and end (ns), parent and frame indices."""

    __slots__ = ("name", "start", "end", "parent", "frame")

    def __init__(self, name: str, start: int, end: int, parent=None, frame=None):
        self.name, self.start, self.end = name, start, end
        self.parent, self.frame = parent, frame

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.start}, {self.end}, parent={self.parent}, "
                f"frame={self.frame})")


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "rf", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.rec = self.rf = None
        if _profiler_enabled():
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        with _lock:
            if len(records) >= CAP:
                dropped += 1
                stack.append((None, None))
                return None
            i = len(records)
            parent, frame = stack[-1] if stack else (None, i)
            self.rec = Record(self.name, 0, 0, parent, frame)
            records.append(self.rec)
        stack.append((i, frame))
        self.rec.start = time.perf_counter_ns()
        return i

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        return False


def span(name: str):
    """A context that records the span `name` while spans record (its
    `__enter__` gives the record's index), else a shared null context
    (giving None)."""
    if _collecting or _profiler_enabled():
        return _Span(name)
    return _NULL


class collect:
    """Record spans inside this context, with no profiler."""

    def __enter__(self):
        global _collecting
        _collecting += 1
        return self

    def __exit__(self, *exc):
        global _collecting
        _collecting -= 1
        return False


def host_read(cuda: bool = True):
    """A context that spans a wait of the host for the device as `host.read`
    while spans record. `cuda` False (the site's CPU path, where nothing
    waits): the shared null context."""
    return span("host.read") if cuda else _NULL


def k3_handed(device):
    """While spans record: the (2,) int64 buffer on `device` into which the
    compositor K3's first pass adds the tiles it hands to its second and
    their chunks left (made at first use, zeros); else None."""
    global _k3_used
    if not (_collecting or _profiler_enabled()):
        return None
    device = torch.device(device)
    with _lock:
        buf = _k3.get(device)
        if buf is None:
            buf = _k3[device] = torch.zeros(2, dtype=torch.int64, device=device)
        _k3_used = True
    return buf


def count_frame(kind: str) -> None:
    """Count one viewer frame under `kind` of `graph_frames` while spans
    record."""
    if _collecting or _profiler_enabled():
        graph_frames[kind] += 1


def k3_resumed():
    """(tiles, chunks) that K3's first pass handed on while spans recorded
    since the last `reset()`, over every device (a copy to the host, which
    waits for the device: read it after the frames); None where no K3 ran
    while spans recorded."""
    with _lock:
        bufs = list(_k3.values()) if _k3_used else []
    if not bufs:
        return None
    tiles, chunks = (int(v) for v in sum(b.cpu() for b in bufs))
    return tiles, chunks


def reset() -> None:
    """Clear the records, the graph frame counts and K3's handed-on count
    (zeroed where it lies; call it with no span open); the launch counters
    are `ops.kernels`'."""
    global dropped, _k3_used
    del records[:]
    dropped = 0
    for k in graph_frames:
        graph_frames[k] = 0
    with _lock:
        for buf in _k3.values():
            buf.zero_()
        _k3_used = False


def frame_roots(recs: list) -> list:
    """Indices of the records that open a frame: a root named in
    `FRAME_ROOTS`."""
    return [i for i, r in enumerate(recs) if r.parent is None and r.name in FRAME_ROOTS]


def self_ns(recs: list) -> list:
    """Each record's self time: its duration less the part of it that its
    child spans cover."""
    kids: dict = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append((r.start, r.end))
    out = []
    for i, r in enumerate(recs):
        covered, last = 0, r.start
        for s, e in sorted(kids.get(i, ())):
            s, e = max(s, last), min(e, r.end)
            if e > s:
                covered += e - s
                last = e
        out.append(r.end - r.start - covered)
    return out


def frame_ms(frame: int, recs: list | None = None) -> dict:
    """ms by name of the spans of the frame whose root is `frame` (summed
    where a name repeats)."""
    recs = records if recs is None else recs
    out: dict = {}
    for i in range(frame, len(recs)):
        r = recs[i]
        if i == frame or r.frame == frame:
            out[r.name] = out.get(r.name, 0.0) + (r.end - r.start) * 1e-6
    return out
