"""``own_kernels_device_ms_per_set``: device milliseconds of the port's
hand-written kernels (every ``__global__`` function of its CUDA sources)
per parameter set, over the traced calls."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernel_count():
        return None
    return tr.kernel_us(own=True) / 1e3 / tr.calls / ctx["C"]
