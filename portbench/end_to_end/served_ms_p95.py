"""`served_ms_p95`: the 95th percentile, in ms, of the time from sending a
request's POST /event to the last byte of its /frame.jpg (host clock),
over every request of the window."""

import numpy as np


def read(w: dict):
    v = w["step_ms"]
    return float(np.percentile(np.asarray(v, np.float64), 95)) if v else None
