"""``bwd_device_ms``: the mean over the traced calls of the card's stream
time of the program's backward (CUDA events at the ends of the span
``pymra.bwd``; idle time inside it included)."""
from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    ms = per_call(traced_calls(ctx), "pymra.bwd", "device_ms")
    return None if ms is None else float(ms.mean())
