"""The whole step's share of the chip's peak, in %: the least time its work
needs (the larger of its bytes at the HBM rate and its FLOPs at the float32
rate, ``roofline.lr_step``, counted from the batches' shapes) over the wall
time of the traced window's steps."""

from psbench import roofline
from psbench.device import H100


def read(ctx):
    tr, shapes = ctx.get("trace"), ctx.get("lr_steps")
    if tr is None or not tr.intervals or not shapes:
        return None
    nbytes = flops = 0.0
    for examples, nnz, unique in shapes:
        b, f = roofline.lr_step(examples, nnz, unique)
        nbytes, flops = nbytes + b, flops + f
    least, _ = roofline.least_seconds(nbytes, flops, H100)
    return 100.0 * least / tr.window_s
