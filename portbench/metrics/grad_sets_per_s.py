"""``grad_sets_per_s``: parameter sets whose value and gradient came back
finite in the window, over the window's seconds (all its calls, all its
time)."""


def read(ctx):
    if ctx["kind"] != "value_and_grad":
        return None
    return (ctx["attempted"] - ctx["failed"]) / ctx["window_s"]
