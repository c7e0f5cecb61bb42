"""`frame_ms`: the window's wall time over the frames completed in it, in
ms (host clock): all the work over all the window's time."""


def read(w: dict):
    return w["window_s"] * 1e3 / w["steps"] if w["steps"] else None
