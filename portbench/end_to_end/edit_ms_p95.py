"""`edit_ms_p95`: the 95th percentile, in ms, of the time from an edit
gesture's first call to the synced frame that shows it (CUDA events), over
every gesture of the window."""

import numpy as np


def read(w: dict):
    v = w["gesture_ms"]
    return float(np.percentile(np.asarray(v, np.float64), 95)) if v else None
