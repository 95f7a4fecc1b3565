"""``library_device_ms_per_set``: device milliseconds of every kernel that
is not one of the port's own (cuBLAS, cuSOLVER, torch's elementwise and
reductions) per parameter set, over the traced calls."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernel_count():
        return None
    return tr.kernel_us(own=False) / 1e3 / tr.calls / ctx["C"]
