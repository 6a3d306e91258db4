"""Share of the window's device-idle time during which no range of the
program's ``linear.*`` spans was open, in %: the idle gaps between the
device's busy intervals, less the part of them that the union of the
``linear.*`` ranges covers, over the gaps. All on the profiler trace's
clock; nothing unless the trace holds one ``linear.step`` span a step."""

from psbench import stats


def _covered(gaps, ranges) -> float:
    """Time of the sorted, disjoint ``gaps`` that the sorted, disjoint
    ``ranges`` cover."""
    out, j = 0.0, 0
    for gs, ge in gaps:
        while j < len(ranges) and ranges[j][1] <= gs:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < ge:
            out += min(ge, ranges[k][1]) - max(gs, ranges[k][0])
            k += 1
    return out


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps")
    if tr is None or not steps or not tr.intervals:
        return None
    named = [(s, e) for s, e, name in tr.host if name.startswith("linear.")]
    if sum(name == "linear.step" for _, _, name in tr.host) != steps:
        return None
    gaps = sorted(stats.gaps(tr.intervals, *tr.window))
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    return 100.0 * (1.0 - _covered(gaps, stats.union(named)) / idle)
