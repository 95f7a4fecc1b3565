"""``launches_per_call``: device kernels the profiler recorded per call
over the traced calls (copies and fills not counted)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernel_count():
        return None
    return tr.kernel_count() / tr.calls
