"""`query.resolve_ms`: a texture-mode release's resolve on the host, in ms a
release over the traced steps: the total of the port's `query.resolve`
spans (the texture branch of `end_selection_gesture`: the query geometry,
the texture sampled at the centres, the combine) over their count (see
`_spans.py`). None on a program without those spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    got = _mod.total_ms(("query.resolve",))
    n = _mod.count("query.resolve")
    return None if got is None or not n else got[0] / n
