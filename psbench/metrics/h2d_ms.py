"""Host time a step of ``batch_to_device``, the batch's copies to the
card (pageable copies hold the host until they are done): the sum of the
program's ``linear.h2d`` spans over the window's steps, in ms, read from
the profiler's trace; nothing unless it holds one ``linear.step`` span a
step."""

SPAN = "linear.h2d"


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if tr is None or not steps:
        return None
    if sum(name == "linear.step" for _, _, name in tr.host) != steps:
        return None
    return sum(e - s for s, e, name in tr.host if name == SPAN) / steps * 1e3
