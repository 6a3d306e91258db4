"""The device trace of a traced run, from ``torch.profiler``.

``Profiled`` records the window with CPU and CUDA activity and exports the
Chrome trace into a directory of the run's own. ``DeviceTrace`` reads it:
the device's busy intervals (kernels, copies, fills), the device time of
each kernel name, and the host operations and harness ranges that were
open while the device sat idle. Times are seconds on the trace's clock."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from psbench import stats

WINDOW = "psbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class DeviceTrace:
    window: tuple[float, float]
    intervals: list[tuple[float, float]]
    kernels: dict[str, list[float]]  # name -> [device seconds, launches]
    host: list[tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.busy(self.intervals, *self.window)

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Device seconds and launches of every kernel whose name holds
        ``fragment``."""
        hit = [v for k, v in self.kernels.items() if fragment in k]
        return sum(v[0] for v in hit), int(sum(v[1] for v in hit))

    def host_at(self, t: float) -> str:
        """The innermost host operation or harness range open at ``t``."""
        best = None
        for s, e, name in self.host:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "host: no recorded operation"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.kernels.items()), key=lambda r: -r[1])
        idle = [[self.host_at((s + e) / 2), e - s]
                for s, e in stats.gaps(self.intervals, *self.window)[:top]]
        return {"device_ops": [[k, v] for k, v in ops[:top]], "idle_gaps": idle}

    @classmethod
    def read(cls, path: Path) -> "DeviceTrace":
        doc = json.loads(Path(path).read_text())
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        window = None
        intervals, host = [], []
        kernels: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev.get("dur", 0.0)) * 1e-6
            if cat in _DEVICE_CATS:
                intervals.append((s, e))
                k = kernels[ev.get("name", "?")]
                k[0] += e - s
                k[1] += 1
            elif cat in _HOST_CATS:
                if ev.get("name") == WINDOW:
                    window = (s, e)
                else:
                    host.append((s, e, ev.get("name", "?")))
        if window is None:
            raise ValueError(f"{path}: no {WINDOW} range in the trace")
        lo, hi = window
        host = [h for h in host if h[1] > lo and h[0] < hi]
        return cls(window, stats.clip(intervals, lo, hi), dict(kernels), host)


class Profiled:
    """Run the window under ``torch.profiler`` when ``on``; a plain window
    otherwise. ``trace`` is read after the ``with`` block."""

    def __init__(self, on: bool, out_dir: Path, device: str = "cuda", name: str = "device"):
        self.on = on
        self.cuda = device != "cpu"
        self.path = Path(out_dir) / f"{name}.trace.json"
        self.trace: DeviceTrace | None = None

    def __enter__(self) -> "Profiled":
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            import torch

            if self.cuda:
                torch.cuda.synchronize()
            self._range.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._prof.export_chrome_trace(str(self.path))
                self.trace = DeviceTrace.read(self.path)
        return False

