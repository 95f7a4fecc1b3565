"""``plan_s``: seconds of the program's planner in the run's set-up (the
span ``pymra.setup.plan`` around ``build_plan`` in the model's
constructor; the upload and the kernels' libraries are spans of their
own)."""
from portbench.yardstick.spans import setup_spans


def read(ctx):
    plans = setup_spans("pymra.setup.plan")
    if not plans or plans[-1]["host_ms"] is None:
        return None
    return plans[-1]["host_ms"] / 1e3
