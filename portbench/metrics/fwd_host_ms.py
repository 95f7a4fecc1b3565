"""``fwd_host_ms``: the median over the traced calls of the host's time
in the program's facade call (the span ``pymra.call``: from the facade's
entry to its return, the sweep's forward passes with their Python and
dispatch; the caller's own tensor set-up and ``backward()`` outside)."""
import numpy as np

from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    ms = per_call(traced_calls(ctx), "pymra.call", "host_ms")
    return None if ms is None else float(np.median(ms))
