"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass


@dataclass
class Check:
    """A number compared against its limit: ``value`` must be finite and at
    most ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def line(self) -> str:
        return f"{self.name} {self.value!r} limit {self.limit!r}"


def checks_from(values: dict[str, float], limits: dict[str, float]) -> list[Check]:
    """One Check for each number, under the configuration's limit of the
    same name."""
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


def rel_gap(got: float, want: float, scale: float | None = None) -> float:
    """|got - want| over ``scale`` (by default |want|)."""
    s = abs(want) if scale is None else scale
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / s if s > 0 else (0.0 if got == want else math.inf)


def norm_gap(got: dict[str, float], want: dict[str, float]) -> float:
    """The worst leaf's gap of norms: |norm_got - norm_want| over the larger
    of that leaf's reference norm and the median leaf's."""
    med = statistics.median(want.values())
    return max(rel_gap(got[k], want[k], max(want[k], med)) for k in want)

