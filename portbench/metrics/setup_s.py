"""``setup_s``: seconds from the start of the run's process to the first
call of the window (imports, CUDA start, the kernels' libraries, the data
from the seed, the plan and its upload, the sets, the warm-up calls)."""


def read(ctx):
    return ctx["setup_s"]
