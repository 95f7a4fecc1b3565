"""``post_sets_per_s``: parameter sets whose likelihood and posterior maps
completed with a finite objective in the window, over the window's
seconds."""


def read(ctx):
    if ctx["kind"] != "posterior":
        return None
    return (ctx["attempted"] - ctx["failed"]) / ctx["window_s"]
