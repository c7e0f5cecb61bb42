"""`k3_composite.resumed_tiles`: the tiles a frame that the compositor K3's
first pass hands to its second over the traced frames: tiles still open
after its chunk budget with chunks left, which then resume across a thread
block cluster on several SMs. The port counts them on the device while its
spans record (`trace.k3_resumed`, read here once, after the window); the
number of frames is the span records' (see `_spans.py`). None where the
port has no such counter, or ran no K3 while spans recorded."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    got = _mod.frames()
    if got is None:
        return None
    trace, _, n = got
    resumed = getattr(trace, "k3_resumed", None)
    handed = None if resumed is None else resumed()
    return None if handed is None else handed[0] / n
