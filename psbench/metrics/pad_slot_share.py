"""Share of the slots that a step's ``index_add_`` scatters that are pad
slots, in %: 100 x the sum of the program's ``linear.pad_slots`` counters
over the sum of its ``linear.slots`` counters, one of each a step, read
from the port's tracer ring (``utils/trace.py``), which records while the
traced window's profiler collects. A count from the batches' shapes, the
same on any device. Nothing unless the ring holds one ``linear.step`` span
a step of the window (a ring that overflowed, or a program without the
counters)."""

from parameter_server_tpu_torch.utils import trace


def read(ctx):
    steps = ctx.get("steps")
    if not steps or ctx.get("trace") is None:
        return None
    total = {"linear.slots": 0.0, "linear.pad_slots": 0.0}
    spans = 0
    for ev in trace.tracer.events():
        name = ev["name"]
        if ev["ph"] == "C" and name in total:
            total[name] += ev["args"]["value"]
        elif ev["ph"] == "X" and name == "linear.step":
            spans += 1
    if spans != steps or not total["linear.slots"]:
        return None
    return 100.0 * total["linear.pad_slots"] / total["linear.slots"]
