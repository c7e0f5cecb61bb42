"""`device.idle_pct`: the share of the traced window, in %, in which no
operation ran on the device: 1 - busy / wall, busy being the union of the
device operations' intervals in the profiler's trace."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
