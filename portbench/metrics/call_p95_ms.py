"""``call_p95_ms``: the 95th percentile of the window's calls, each timed
on the host clock from the call until its results are back on the host
(value and gradient) or the device has finished (posterior)."""
import numpy as np


def read(ctx):
    if not ctx["calls"]:
        return None
    return float(np.percentile(np.asarray(ctx["calls"]) * 1e3, 95))
