"""``k1_roofline``: K1's (``leaf_factor_kernel``, the fused leaf
factorization) least time over its device time per launch, in percent.
The least time is the frozen yardstick's (``yardstick/roofline.py``) at
the leaves' shape: all sets' leaves of width 16 to 64 in one launch."""
from portbench.yardstick.roofline import bound_ms, leaf_factor_work

KERNEL = "leaf_factor_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    launches = tr.kernel_launches(KERNEL)
    levels = [lv for lv in ctx["shape"]["levels"]
              if lv["n_leaf"] and 16 <= lv["P"] <= 64]
    if not launches or not levels:
        return None
    bound = sum(bound_ms(*leaf_factor_work(ctx["C"] * lv["n_leaf"], lv["P"]))
                for lv in levels) / len(levels)
    return 100.0 * bound / (tr.kernel_us(name=KERNEL) / 1e3 / launches)
