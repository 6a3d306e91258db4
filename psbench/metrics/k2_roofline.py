"""K2 (``ftrl_delta_kernel``, ``csrc/ftrl.cu``) against its roofline, in %:
the least time of the FTRL delta over each step's real unique keys
(``roofline.ftrl_delta``) over the kernel's device time in the trace."""

from psbench import roofline
from psbench.device import H100

KERNEL = "ftrl_delta_kernel"


def read(ctx):
    tr, shapes = ctx.get("trace"), ctx.get("lr_steps")
    if tr is None or not shapes:
        return None
    seconds, launches = tr.kernel_s(KERNEL)
    if not launches or seconds <= 0:
        return None
    nbytes = flops = 0.0
    for _, _, unique in shapes:
        b, f = roofline.ftrl_delta(unique)
        nbytes, flops = nbytes + b, flops + f
    least, _ = roofline.least_seconds(nbytes, flops, H100)
    return 100.0 * least / seconds
