"""`query.paint_ms`: the query texture's paint on the host, in ms a frame
over the traced steps: the port's `query.paint` spans, one around each
pointer event's paint of a rect or a brush segment in `QueryToolset` (see
`_spans.py`). None on a program without those spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    return _mod.per_frame_ms(("query.paint",))
