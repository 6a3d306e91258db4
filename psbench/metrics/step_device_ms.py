"""Device busy time (union of kernel, copy and fill intervals) a step, over
the steps of the traced window."""


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if tr is None or not tr.intervals or not steps or "lr_steps" not in ctx:
        return None
    return tr.busy_s() / steps * 1e3
