"""`session.mask_upload_ms`: the copy of a model's splat positions to the
device for an EvaluateMask, in ms per evaluation over the traced steps: the
port's `mask.upload` spans over its `session.evaluate_mask` spans (see
`_spans.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_spans",
                                               Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    got = _mod.total_ms(("mask.upload",))
    n = _mod.count("session.evaluate_mask")
    return None if got is None or not n else got[0] / n
