"""Half-open key ranges and shard math (reference analog: src/util/range.h).

A copy of the JAX package's ``utils/keyrange.py``: servers own one
contiguous range each of the dense key space ``[0, num_keys)``, split by
``even_divide`` (the reference's ``Range::EvenDivide``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open range [begin, end) over the dense key space."""

    begin: int
    end: int

    def __post_init__(self) -> None:
        if self.begin > self.end:
            raise ValueError(f"invalid range [{self.begin}, {self.end})")

    @property
    def size(self) -> int:
        return self.end - self.begin

    def contains(self, key: int) -> bool:
        return self.begin <= key < self.end

    def intersect(self, other: "KeyRange") -> "KeyRange":
        b, e = max(self.begin, other.begin), min(self.end, other.end)
        return KeyRange(b, max(b, e))

    def even_divide(self, n: int) -> list["KeyRange"]:
        """Split into n near-equal contiguous ranges (ref Range::EvenDivide)."""
        if n <= 0:
            raise ValueError("n must be positive")
        out = []
        for i in range(n):
            b = self.begin + (self.size * i) // n
            e = self.begin + (self.size * (i + 1)) // n
            out.append(KeyRange(b, e))
        return out

    def shard_of(self, key: int, n: int) -> int:
        """Index of the even_divide(n) shard containing ``key``."""
        if not self.contains(key):
            raise ValueError(f"key {key} outside {self}")
        off = key - self.begin
        # inverse of the even_divide boundary formula
        return min(n - 1, (off * n + n - 1) // self.size if self.size else 0)
