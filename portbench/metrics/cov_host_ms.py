"""``cov_host_ms``: the median over the traced calls of the host's time in
the program's covariance evaluations that have no closed form (the
general-nu Matern's Bessel K): its spans ``pymra.cov`` (each evaluation
in passes A and B) and, where the covariance has a pullback kernel,
``pymra.bwd.cov`` (each pullback), summed over a call. None where the
program keeps no ``pymra.cov`` spans (a closed-form covariance, or a
program without them)."""
import numpy as np

from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    calls = traced_calls(ctx)
    fwd = per_call(calls, "pymra.cov", "host_ms")
    if fwd is None:
        return None
    bwd = per_call(calls, "pymra.bwd.cov", "host_ms")
    if bwd is not None:
        fwd = fwd + bwd
    return float(np.median(fwd))
