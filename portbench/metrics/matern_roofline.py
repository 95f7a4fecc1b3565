"""``matern_roofline``: the general-nu Matern kernel's least time over its
device time, in percent, over the traced calls: the frozen yardstick's
(``yardstick/matern.py``) least time of every covariance block of a sweep,
forward (``matern_kernel``) and pullback (``matern_pullback_kernel``),
each launch counted at its kind's mean block, over the two kernels' device
time. None where the trace holds no launch of the forward kernel."""
from portbench.yardstick.matern import cov_blocks, matern_work
from portbench.yardstick.roofline import bound_ms

FORWARD, PULLBACK = "matern_kernel", "matern_pullback_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    blocks = cov_blocks(ctx["shape"])
    n_fwd, n_bwd = tr.kernel_launches(FORWARD), tr.kernel_launches(PULLBACK)
    if not n_fwd or not blocks:
        return None
    least = 0.0
    for n, pullback in ((n_fwd, False), (n_bwd, True)):
        mean = sum(bound_ms(*matern_work(ctx["C"], *blk, pullback=pullback))
                   for blk in blocks) / len(blocks)
        least += n * mean
    device_ms = (tr.kernel_us(name=FORWARD) + tr.kernel_us(name=PULLBACK)) / 1e3
    return 100.0 * least / device_ms
