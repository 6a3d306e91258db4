"""Per-segment-scale int8/int16 gradient quantizer — the wire codec.

The payload is cut into fixed-length segments, each with its own symmetric
scale max|x|/qmax, so one outlier coordinate coarsens only its segment;
0.0 maps to exactly 0 (the KV store's pad-row invariant survives), and
rounding is stochastic (unbiased).

- ``SegmentQuantizer`` is the host codec of the wire tier, a copy of the
  JAX package's numpy class (tests hold the copy to the original).
- ``quantize_segments`` / ``dequantize_segments`` / ``dequantize_flat`` are
  the device-path forms (the JAX package's jitted twins). They are
  composites with no kernel behind them, so plain PyTorch is their port:
  they run on the tensor's device and take a ``torch.Generator`` (on that
  device) where the JAX twins take a PRNG key. The scale is max|x| times
  float32(1/qmax), as XLA computes the twins' ``/ qmax``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: smallest representable scale: a segment of exact zeros must decode to
#: exact zeros without a divide-by-zero on the encode side
_TINY = 1e-30


def _qmax(num_bytes: int) -> int:
    return (1 << (8 * num_bytes - 1)) - 1  # 127 / 32767


def _qdtype(num_bytes: int) -> torch.dtype:
    if num_bytes not in (1, 2):
        raise ValueError("num_bytes must be 1 or 2")
    return torch.int8 if num_bytes == 1 else torch.int16


def quantize_segments(
    gen: torch.Generator, x: torch.Tensor, num_bytes: int = 1, seg: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-path encode: ``x`` (flat float32, length a multiple of
    ``seg``) -> (q, per-segment float32 scales), on x's device."""
    dtype, qmax = _qdtype(num_bytes), _qmax(num_bytes)
    xs = x.reshape(-1, seg)
    scale = torch.clamp(xs.abs().amax(dim=1) * (1.0 / qmax), min=_TINY)
    t = xs / scale[:, None]
    floor = torch.floor(t)
    frac = t - floor
    up = torch.rand(t.shape, generator=gen, device=x.device) < frac
    q = torch.clamp(floor + up, -qmax, qmax).to(dtype)
    return q.reshape(-1), scale


def dequantize_segments(
    q: torch.Tensor, scale: torch.Tensor, num_bytes: int = 1, seg: int = 256
) -> torch.Tensor:
    """Device-path decode (inverse of :func:`quantize_segments`)."""
    _qdtype(num_bytes)
    qs = q.reshape(-1, seg).to(torch.float32)
    return (qs * scale[:, None]).reshape(-1)


def dequantize_flat(q: torch.Tensor, scale: torch.Tensor, seg: int = 256) -> torch.Tensor:
    """Decode of an arbitrary-length payload (the host codec's trimmed wire
    shape): re-pad ``q`` to the segment multiple, scale per segment, trim."""
    n = int(q.shape[0])
    flat = q.to(torch.float32)
    pad = (-n) % seg
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = flat.reshape(-1, seg) * scale[:, None].to(torch.float32)
    return out.reshape(-1)[:n]


@dataclass(frozen=True)
class SegmentQuantizer:
    """The host wire codec: int8/int16 payload + one f32 scale per ``seg``
    coordinates, stochastic (unbiased) rounding on encode.

    ``encode`` / ``decode`` are numpy-vectorized and shape-flexible
    (arbitrary input lengths; the pad needed for the segment reshape is
    internal and never serialized)."""

    num_bytes: int = 1
    seg: int = 256

    def __post_init__(self) -> None:
        if self.num_bytes not in (1, 2):
            raise ValueError("num_bytes must be 1 or 2")
        if self.seg < 1:
            raise ValueError("seg must be >= 1")

    @property
    def qmax(self) -> int:
        return _qmax(self.num_bytes)

    @property
    def dtype(self):
        return np.int8 if self.num_bytes == 1 else np.int16

    def _padded(self, x: np.ndarray) -> np.ndarray:
        flat = x.astype(np.float32, copy=False).reshape(-1)
        pad = (-len(flat)) % self.seg
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.float32)])
        return flat

    def encode(
        self, seed: int, x: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Quantize ``x`` -> (q: int8/int16 (n,), scales: f32 (nseg,)).
        ``seed`` feeds the stochastic-rounding RNG; distinct pushes must
        use distinct seeds (the handle's atomic counter does)."""
        n = int(np.size(x))
        xs = self._padded(x).reshape(-1, self.seg)
        scale = np.abs(xs).max(axis=1) / self.qmax
        np.maximum(scale, _TINY, out=scale)
        t = xs / scale[:, None]
        floor = np.floor(t)
        frac = t - floor
        up = np.random.default_rng(seed).random(t.shape, dtype=np.float32)
        q = floor + (up < frac)
        np.clip(q, -self.qmax, self.qmax, out=q)
        return (
            q.reshape(-1)[:n].astype(self.dtype),
            scale.astype(np.float32),
        )

    def encode_nearest(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Deterministic round-to-nearest encode (no seed) — the PULL
        side's form: weight reads have no error-feedback loop to redeem
        stochastic rounding's unbiasedness, so nearest halves the
        worst-case error and keeps repeated reads of one unchanged
        snapshot bit-identical (cacheable, diffable, reproducible)."""
        n = int(np.size(x))
        xs = self._padded(x).reshape(-1, self.seg)
        scale = np.abs(xs).max(axis=1) / self.qmax
        np.maximum(scale, _TINY, out=scale)
        q = np.rint(xs / scale[:, None])
        np.clip(q, -self.qmax, self.qmax, out=q)
        return (
            q.reshape(-1)[:n].astype(self.dtype),
            scale.astype(np.float32),
        )

    def decode(self, q: np.ndarray, scale: np.ndarray) -> np.ndarray:
        """Dequantize -> flat float32 of ``q``'s length (the encode-side
        pad was trimmed before the wire; re-pad, scale, trim again)."""
        n = int(np.size(q))
        flat = q.astype(np.float32, copy=False).reshape(-1)
        pad = (-n) % self.seg
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.float32)])
        out = flat.reshape(-1, self.seg) * scale[:, None].astype(np.float32)
        return out.reshape(-1)[:n]

    def wire_bytes(self, n: int) -> int:
        """Payload bytes for an ``n``-coordinate push (q + scales)."""
        nseg = -(-n // self.seg)
        return n * self.num_bytes + 4 * nseg
