"""The stochastic fixed-point quantizer: hand-written CUDA for Hopper, with
its plain version.

``quantize_stochastic`` replaces ``quantize_stochastic_pallas``
(``parameter_server_tpu/ops/pallas_kernels.py``): the int8/int16 encode of
the fixed-point gradient codec (``filters/fixed_point.py``). Two passes, as
on the TPU:

- ``quantize_params``: lo = min x and scale = max(hi - lo, 1e-30)/levels, by
  one ``torch.aminmax`` and two scalar operations on x's device, kept as a
  (2,) tensor (lo, scale) that never leaves the device;
- ``stochastic_round`` (CUDA ``quantize_stochastic_kernel`` in
  ``csrc/quantize.cu``): q = floor(t) + [u < frac(t)] with t = (x - lo)/scale,
  less levels//2 and clamped to the integer type's range before the cast
  (the reference's cast saturates; a PyTorch cast wraps).

u comes from the top 24 bits of Philox4x32-10, keyed by the 64-bit seed,
with counter (i/4, 0, 0, 0) for element i and word i % 4 of that call. The
plain version (``stochastic_round_plain``) emulates that stream in int64
tensors (``philox4x32_10``: a product of two 32-bit words wraps in int64
and keeps its low 64 bits exact), so on the card the kernel's q equals the
plain version's bit for bit. The TPU kernel's hardware stream cannot be
reproduced: against the JAX package the port agrees on lo, scale and the
set {floor t, floor t + 1}, and on the statistics of the rounding.

scale is the span times the float32 reciprocal of levels, as XLA computes
the reference's ``/ levels`` under ``jit``: the port's scale equals the
TPU path's bit for bit (the JAX package's eager ``encode`` divides, one
ulp away at times).

The wrapper checks its inputs (float32, contiguous, non-empty, one device)
and raises on anything else. On CPU tensors it runs the plain version; on
CUDA tensors it launches the kernel or raises — nothing falls back. Every
successful launch adds one to ``LAUNCHES["quantize_stochastic"]``.
"""

from __future__ import annotations

import ctypes

import torch

from parameter_server_tpu_torch.ops import cuda_build

#: launches of the kernel since the last ``reset_launches()``
LAUNCHES = {"quantize_stochastic": 0}

_P, _I64, _INT, _U32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32
_ARGS = [_P, _P, _P, _I64, _INT, _U32, _U32, _INT, _P]

_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments
_QDTYPE = {1: torch.int8, 2: torch.int16}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def levels(num_bytes: int) -> int:
    """Rounding levels of an n-byte payload: 255 or 65535."""
    if num_bytes not in _QDTYPE:
        raise ValueError("num_bytes must be 1 or 2")
    return (1 << (8 * num_bytes)) - 1


def _check_x(x: torch.Tensor) -> torch.device:
    cuda_build.check_tensor("x", x, torch.float32)
    if x.numel() == 0:
        raise ValueError("x is empty: its min and max are undefined")
    return cuda_build.common_device(x=x)


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensors (the kernel's random stream)
# ---------------------------------------------------------------------------


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32-bit words."""
    s = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    return s & _MASK32, s >> 32


def philox4x32_10(ctr: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of (N, 4) int64 counters holding 32-bit words, with a
    (k0, k1) key: (N, 4) int64 words in [0, 2^32)."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        p0 = c0 * PHILOX_M[0]  # < 2^64: wraps in int64, low 64 bits exact
        p1 = c2 * PHILOX_M[1]
        hi0, lo0 = (p0 >> 32) & _MASK32, p0 & _MASK32
        hi1, lo1 = (p1 >> 32) & _MASK32, p1 & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_bits(seed: int, n: int, device: torch.device) -> torch.Tensor:
    """The kernel's n random words: word i % 4 of the Philox call with
    counter (i/4 mod 2^32, i/4 / 2^32, 0, 0), as (n,) int64."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    ctr = torch.stack([g & _MASK32, g >> 32, zero, zero], dim=-1)
    return philox4x32_10(ctr, seed_key(seed)).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# the two passes
# ---------------------------------------------------------------------------


def quantize_params(x: torch.Tensor, num_bytes: int = 1) -> torch.Tensor:
    """(lo, scale) of ``x`` as a (2,) float32 tensor on x's device: one
    ``aminmax``, then max(hi - lo, 1e-30) * float32(1/levels)."""
    lv = levels(num_bytes)
    _check_x(x)
    lo, hi = torch.aminmax(x)
    scale = torch.clamp(hi - lo, min=1e-30) * (1.0 / lv)
    return torch.stack([lo, scale])


def _check_params(x: torch.Tensor, params: torch.Tensor) -> torch.device:
    cuda_build.check_tensor("params", params, torch.float32)
    if params.shape != (2,):
        raise ValueError(f"params must be (lo, scale) of shape (2,), got {tuple(params.shape)}")
    _check_x(x)
    return cuda_build.common_device(x=x, params=params)


def stochastic_round_plain(
    seed: int, x: torch.Tensor, params: torch.Tensor, num_bytes: int = 1
) -> torch.Tensor:
    """The rounding pass in plain PyTorch, the kernel's arithmetic op for
    op: q = floor(t) + [u < t - floor(t)], t = (x - lo)/scale, then
    clamp(q - levels//2) to the integer type and cast."""
    half = levels(num_bytes) // 2
    dtype = _QDTYPE[num_bytes]
    lo, scale = params[0], params[1]
    t = (x - lo) / scale
    floor = torch.floor(t)
    frac = t - floor
    u = (philox_bits(seed, x.numel(), x.device) >> 8).to(torch.float32) * 2.0**-24
    q = floor + (u.view(x.shape) < frac).to(torch.float32)
    info = torch.iinfo(dtype)
    return torch.clamp(q - half, info.min, info.max).to(dtype)


def stochastic_round(
    seed: int, x: torch.Tensor, params: torch.Tensor, num_bytes: int = 1
) -> torch.Tensor:
    """The rounding pass: q of x's shape, int8 (``num_bytes`` 1) or int16
    (2), from (lo, scale) ``params`` on x's device."""
    levels(num_bytes)
    dev = _check_params(x, params)
    if dev.type == "cpu":
        return stochastic_round_plain(seed, x, params, num_bytes)
    q = torch.empty(x.shape, dtype=_QDTYPE[num_bytes], device=dev)
    k0, k1 = seed_key(seed)
    code = cuda_build.function("ps_quantize_stochastic", _ARGS)(
        x.data_ptr(), params.data_ptr(), q.data_ptr(), x.numel(), num_bytes,
        k0, k1, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(code, "quantize_stochastic")
    LAUNCHES["quantize_stochastic"] += 1
    return q


def quantize_stochastic(
    seed: int, x: torch.Tensor, num_bytes: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-point encode with stochastic rounding: (q, lo, scale), all on
    x's device (lo and scale 0-dim); decode is (q + levels//2)*scale + lo."""
    params = quantize_params(x, num_bytes)
    return stochastic_round(seed, x, params, num_bytes), params[0], params[1]


def quantize_stochastic_plain(
    seed: int, x: torch.Tensor, num_bytes: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``quantize_stochastic`` with the plain rounding pass."""
    params = quantize_params(x, num_bytes)
    return stochastic_round_plain(seed, x, params, num_bytes), params[0], params[1]
