"""``leaf_pass_device_ms``: the mean over the traced calls of the card's
stream time of pass B, the leaves (CUDA events recorded at the ends of the
span ``pymra.pass.B``; idle time inside it included)."""
from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    ms = per_call(traced_calls(ctx), "pymra.pass.B", "device_ms")
    return None if ms is None else float(ms.mean())
