"""`host.syncs_per_frame`: the times the host waited for the device over
the traced steps, the port's `host.read` records (one around each
device-to-host read or copy that syncs the stream), over the number of
frames (see `_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    got = _mod.frames()
    return None if got is None else _mod.count("host.read") / got[2]
