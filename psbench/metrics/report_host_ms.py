"""Host time a step of the report that ``LinearMethod.train`` makes every
``report_every`` steps, with its reads of the device left out: (sum of the
program's ``linear.report`` spans - sum of their ``linear.report.readback``
spans) over the window's steps, in ms, read from the profiler's trace;
nothing unless it holds one ``linear.step`` span a step."""


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if tr is None or not steps:
        return None
    if sum(name == "linear.step" for _, _, name in tr.host) != steps:
        return None
    report = sum(e - s for s, e, name in tr.host if name == "linear.report")
    readback = sum(e - s for s, e, name in tr.host if name == "linear.report.readback")
    return (report - readback) / steps * 1e3
