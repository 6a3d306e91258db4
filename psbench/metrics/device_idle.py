"""Share of the traced window in which no operation ran on the device:
1 - (union of kernel, copy and fill intervals) / window, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.intervals:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
