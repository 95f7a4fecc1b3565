"""``cov_entries_per_set``: covariance entries the program evaluated per
parameter set in a traced call: its counter ``cov_entries`` (entries times
sets, kept with each ``pymra.cov`` span), summed over a call, over the
call's sets; the mean over the traced calls. None where the program keeps
no such counter."""
from portbench.yardstick.spans import traced_calls


def read(ctx):
    calls = traced_calls(ctx)
    if calls is None:
        return None
    per_call = []
    for recs in calls:
        n = [r.get("counts", {}).get("cov_entries") for r in recs
             if r["name"] == "pymra.cov"]
        if not n or any(v is None for v in n):
            return None
        per_call.append(sum(n) / ctx["C"])
    return float(sum(per_call) / len(per_call))
