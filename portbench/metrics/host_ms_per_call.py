"""``host_ms_per_call``: the median over the window's calls of the host's
time from the call until it returns, before the wait for the device (the
enqueue: the facade, the sweep's Python and autograd dispatch)."""
import numpy as np


def read(ctx):
    if not ctx["enqueue"]:
        return None
    return float(np.median(ctx["enqueue"]) * 1e3)
