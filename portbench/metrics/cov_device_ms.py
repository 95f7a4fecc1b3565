"""``cov_device_ms``: the mean over the traced calls of the card's stream
time in the program's covariance evaluations that have no closed form
(CUDA events at the ends of its spans ``pymra.cov`` and, where the
covariance has a pullback kernel, ``pymra.bwd.cov``, summed over a call;
idle time inside them included). None where the program keeps no
``pymra.cov`` spans."""
from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    calls = traced_calls(ctx)
    fwd = per_call(calls, "pymra.cov", "device_ms")
    if fwd is None:
        return None
    bwd = per_call(calls, "pymra.bwd.cov", "device_ms")
    if bwd is not None:
        fwd = fwd + bwd
    return float(fwd.mean())
