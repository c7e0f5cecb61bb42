"""`host.sync_wait_ms`: the time the host waits for the device, in ms a
frame over the traced steps: the port's `host.read` spans, one around each
device-to-host read or copy that syncs the stream; 0 where frames were
traced and none waited (see `_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    if _mod.frames() is None:
        return None
    return _mod.per_frame_ms(("host.read",)) or 0.0
