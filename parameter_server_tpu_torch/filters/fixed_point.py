"""Fixed-point quantization codec with stochastic (unbiased) rounding.

Reference analog: src/filter/fixing_float.h — quantize floats into n-byte
fixed point with randomized rounding and per-array min/max scaling, applied
symmetrically on send/receive: a worker encodes its gradient before the
wire and the server decodes it before the apply queue.

Both encodes run the quantizer of ``ops/quantize_kernels.py`` on x's
device: the hand-written CUDA kernel on the card, its plain PyTorch version
on the CPU (the JAX package's ``encode`` / ``encode_fast`` split between
threefry and the TPU kernel is the device's choice here). The random
stream is Philox keyed by an int seed, where the JAX ``encode`` takes a
PRNG key; distinct pushes must use distinct seeds.

Stochastic rounding keeps E[decode(encode(x))] == x, which is what makes
low-bit gradient pushes safe for FTRL/AdaGrad."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from parameter_server_tpu_torch.ops.quantize_kernels import levels, quantize_stochastic


class Encoded(NamedTuple):
    q: torch.Tensor  # integer payload, x's shape
    lo: torch.Tensor  # per-array min (0-dim)
    scale: torch.Tensor  # (hi - lo) / levels (0-dim)


@dataclass(frozen=True)
class FixedPointCodec:
    """num_bytes in {1, 2}: int8 or int16 payloads (ref: FilterConfig
    num_bytes)."""

    num_bytes: int = 1

    def __post_init__(self) -> None:
        if self.num_bytes not in (1, 2):
            raise ValueError("num_bytes must be 1 or 2")

    def encode(self, seed: int, x: torch.Tensor) -> Encoded:
        """Quantize a float32 tensor to [lo, hi] with stochastic rounding,
        on x's device; ``seed`` keys the rounding's random stream."""
        return Encoded(*quantize_stochastic(seed, x, self.num_bytes))

    def encode_fast(self, seed: int, x: torch.Tensor) -> Encoded:
        """The device-path entry of the JAX package; the same as
        ``encode`` here (the kernel on CUDA tensors, plain on the CPU)."""
        return self.encode(seed, x)

    def decode(self, e: Encoded) -> torch.Tensor:
        zero = levels(self.num_bytes) // 2
        return (e.q.to(torch.float32) + zero) * e.scale + e.lo

    def bytes_saved(self, x: torch.Tensor) -> float:
        """Wire-size ratio vs float32."""
        return 1.0 - self.num_bytes / 4.0
