"""``sweep_mfu``: the sweep's operations per call (the frozen count of
``yardstick/flops.py`` times the call's sets) over the window's mean time
per call, as a share of the card's float32 peak, in percent."""
from portbench.yardstick.peaks import FP32_FLOP_PER_S


def read(ctx):
    if not ctx["n_calls"]:
        return None
    per_call_s = ctx["window_s"] / ctx["n_calls"]
    return (100.0 * ctx["flops_per_set"] * ctx["C"] / per_call_s
            / FP32_FLOP_PER_S)
