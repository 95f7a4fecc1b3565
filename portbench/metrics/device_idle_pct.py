"""``device_idle_pct``: the share of the traced stretch (the profiled
calls, from the first call to the last synchronise) that the union of the
device's activities leaves empty, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
