"""``escalated_members_per_call``: members of the jittered kernels (K1's
two factorizations, K2, K6, K7, KC) whose selected escalation factor is
above 1, per traced call: the program's counter of its facade calls (the
factors kept with their spans, compared with 1 after the stretch)."""
from portbench.yardstick.spans import per_call, traced_calls


def read(ctx):
    n = per_call(traced_calls(ctx), "pymra.call", "escalated")
    return None if n is None else float(n.mean())
