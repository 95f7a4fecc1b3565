"""``bwd_host_ms``: the median over the traced calls of the host's time
in the program's backward (the span ``pymra.bwd``: from the backward of
the marker on the log-likelihood to that of the marker on the parameters,
on autograd's thread)."""
import numpy as np

from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    ms = per_call(traced_calls(ctx), "pymra.bwd", "host_ms")
    return None if ms is None else float(np.median(ms))
