"""Canonical clock helpers: every timestamp names its clock AND unit.

A copy of the JAX package's ``utils/clock.py``. The wrappers bake clock
and unit into the name (``now_wall_us`` -> wall clock, microseconds), so
a timestamp never loses its unit in an un-suffixed local.

``skew_clamped_age_s`` is the one sanctioned place a foreign-wall
publish timestamp (a peer-echoed ``pts``) meets the local wall clock:
the floor-at-0 IS the skew handling (cross-node wall deltas go
negative, and negative age must never reach a histogram).
"""

from __future__ import annotations

import time

__all__ = [
    "now_mono_s",
    "now_mono_us",
    "now_perf_s",
    "now_wall_s",
    "now_wall_us",
    "skew_clamped_age_s",
]


def now_wall_s() -> float:
    """Wall-clock epoch seconds (``time.time``): the only clock that is
    meaningful ACROSS processes — and only modulo NTP skew, so wall
    deltas taken against a peer's stamp go through a skew clamp."""
    return time.time()


def now_wall_us() -> int:
    """Wall-clock epoch microseconds (the wire/publish-ts granularity:
    binary-header i64 slots and the RCU publish tuple carry these)."""
    return int(time.time() * 1e6)


def now_mono_s() -> float:
    """Monotonic seconds (``time.monotonic``): in-process intervals —
    deadlines, backoff, cache residence. Never crosses a process."""
    return time.monotonic()


def now_mono_us() -> int:
    """Monotonic microseconds, for µs-granular in-process intervals."""
    return int(time.monotonic() * 1e6)


def now_perf_s() -> float:
    """High-resolution perf counter seconds (``time.perf_counter``):
    micro-benchmark timing inside one process."""
    return time.perf_counter()


def skew_clamped_age_s(pts_us: float) -> float:
    """Realized age (seconds) of a µs-epoch publish timestamp against
    THIS process's wall clock, floored at 0: when ``pts_us`` came from
    a peer (or an NTP step landed between publish and serve), the raw
    difference can be negative by the cross-node skew — a negative age
    is clamped, never booked."""
    return max(time.time() - float(pts_us) / 1e6, 0.0)
