"""``cov_fallback_share``: the share, in percent, of the general-nu
Matern's entries (entries times sets) whose Bessel pair the program
evaluated by its series or continued fraction: on the card those the
kernel's per-nu table did not cover, on the CPU every entry with a positive
scaled distance (the twin has no table). The program's counter
``cov_fallback_entries`` over its ``cov_entries``, both kept with each
``pymra.cov`` span and summed over the traced calls. None where the
traced calls hold no ``pymra.cov`` span or one lacks either counter."""
from portbench.yardstick.spans import traced_calls


def read(ctx):
    calls = traced_calls(ctx)
    if calls is None:
        return None
    counts = [r.get("counts", {}) for recs in calls for r in recs
              if r["name"] == "pymra.cov"]
    if not counts:
        return None
    fell = [c.get("cov_fallback_entries") for c in counts]
    total = [c.get("cov_entries") for c in counts]
    if any(v is None for v in fell + total) or not sum(total):
        return None
    return 100.0 * sum(fell) / sum(total)
