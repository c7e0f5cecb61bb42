"""`session.segments_ms`: the overlays' segment build on the host (the mask
gizmos' and measurement lines' projection and the segment table), in ms a
frame over the traced steps: the port's `overlays.segments` spans (see
`_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    return _mod.per_frame_ms(("overlays.segments",))
