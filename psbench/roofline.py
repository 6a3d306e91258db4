"""Operations and bytes that a step and a kernel need, counted from the
shapes of their inputs, whatever implements them.

Each input byte counts as read once and each output byte as written once.
Where the work depends on the data, the count is what these inputs need:
the real unique keys of a batch, not the padded slots a program carries."""

from __future__ import annotations

F32 = 4
# one FTRL element update, sqrt and division counted as one operation each:
# the weight (|z| - l1, sign, clamp, product, sqrt, beta +, /alpha, + l2,
# division), sigma (g*g, n +, sqrt, -, /alpha), dz (sigma*w, g -) and dn
FTRL_FLOPS = 18
# a nonzero's share of the logits (x*w, +) and of the gradient (x*err, +)
NNZ_FLOPS = 4
# an example's loss and residual: softplus (max, exp, log1p, +), y*logit,
# -, +, sigmoid (exp, +, division), -
EXAMPLE_FLOPS = 12


def lr_step(examples: int, nnz: int, unique: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one sparse LR step under FTRL: each unique key's
    z and n read once and written once; each nonzero's id, value and row
    id, and each label, read once; the weight, logits, loss, gradient and
    FTRL update."""
    nbytes = unique * 4 * F32 + nnz * 3 * 4 + examples * F32
    flops = nnz * NNZ_FLOPS + examples * EXAMPLE_FLOPS + unique * FTRL_FLOPS
    return float(nbytes), float(flops)


def ftrl_delta(rows: int) -> tuple[float, float]:
    """(bytes, FLOPs) of K2, the FTRL delta over ``rows`` rows: z, n and g
    read, dz and dn written (five float32 a row)."""
    return float(rows * 5 * F32), float(rows * FTRL_FLOPS)


def least_seconds(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    """The least time of the work on the device, and what sets it."""
    tb = nbytes / peaks.hbm_bytes_per_s
    tf = flops / peaks.f32_flops_per_s
    return (tb, "bytes") if tb >= tf else (tf, "flops")
