"""`frame_ms_p95`: the 95th percentile of every frame's time in the window,
gesture frames included, in ms; each frame timed by CUDA events around
it."""

import numpy as np


def read(w: dict):
    v = w["step_ms"]
    return float(np.percentile(np.asarray(v, np.float64), 95)) if v else None
