"""`viewer.prologue_ms`: the viewer's host prologue, from `render()`'s entry
to its first front-end call (camera, model order, gates, the merged entry
buffer), in ms a frame over the traced steps: the port's `viewer.prologue`
spans (see `_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    return _mod.per_frame_ms(("viewer.prologue",))
