"""Host time a step of enqueueing ``train_step`` and its bookkeeping,
with no wait for the card: the sum of the program's ``linear.launch``
spans over the window's steps, in ms, read from the profiler's trace;
nothing unless it holds one ``linear.step`` span a step."""

SPAN = "linear.launch"


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if tr is None or not steps:
        return None
    if sum(name == "linear.step" for _, _, name in tr.host) != steps:
        return None
    return sum(e - s for s, e, name in tr.host if name == SPAN) / steps * 1e3
