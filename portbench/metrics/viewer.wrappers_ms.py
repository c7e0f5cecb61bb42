"""`viewer.wrappers_ms`: the host time of the frame's kernel wrappers, in
ms a frame over the traced steps: the self time of the port's `k1.frontend`,
`k2.sort` and `k3.composite` spans, without their `host.read` children (see
`_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    return _mod.per_frame_ms(("k1.frontend", "k2.sort", "k3.composite"), self_time=True)
