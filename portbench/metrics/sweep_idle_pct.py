"""``sweep_idle_pct``: the device's idle time in the traced stretch that
the program holds, in percent of the stretch: every idle gap of the
device (as ``device_idle_pct`` takes them: the stretch less the union of
its activities) whose middle falls inside one of the program's root spans
(``pymra.call``, ``pymra.bwd``), put on the trace's clock by each call's
``pymra.clock`` anchor. The rest of ``device_idle_pct`` is the caller's."""
from portbench.yardstick.spans import on_trace_clock, traced_calls


def read(ctx):
    tr = ctx["trace"]
    spans = on_trace_clock(ctx, traced_calls(ctx))
    if spans is None or not tr.window_us:
        return None
    busy = tr.busy_intervals()
    edges = [tr.t0] + [x for ab in busy for x in ab] + [tr.t1]
    held = 0.0
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        mid = 0.5 * (a + b)
        if b > a and any(s <= mid <= e for s, e in spans):
            held += b - a
    return 100.0 * held / tr.window_us
