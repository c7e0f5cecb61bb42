"""`k2_sort.roofline_pct`: the stage's share of its roofline over the traced
frames, in % (see `_roofline.py`)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_roofline",
                                               Path(__file__).with_name("_roofline.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(ctx: dict):
    return _mod.share(ctx, "k2_sort")
