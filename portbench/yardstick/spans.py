"""The program's own spans of a traced stretch, read by the per-layer
metrics of the facade, the passes and the escalations.

``pymra_torch.utils.profiling`` keeps the spans of the last traced calls:
a ``pymra.call`` root a facade call (its passes and levels inside), a
``pymra.bwd`` root for its backward, and an empty ``pymra.clock`` profiler
range at the start of each call, whose host event in the trace and the
host time the program read inside it put the call's spans on the trace's
clock. A tree whose program keeps no spans (no ``profiling.spans``) reads
as nothing: every reader then returns None.
"""
from __future__ import annotations

import numpy as np

__all__ = ["traced_calls", "per_call", "on_trace_clock", "setup_spans",
           "CLOCK"]

#: the program's clock anchor (its profiler range's name)
CLOCK = "pymra.clock"


def _records():
    try:
        from pymra_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def traced_calls(ctx):
    """The span records of the traced stretch's calls, one list a call in
    the order they ran: the last ``ctx["trace"].calls`` facade calls, each
    closed and anchored (made while the profiler recorded); else None."""
    tr = ctx["trace"]
    if tr is None:
        return None
    recs = _records()
    if recs is None:
        return None
    roots = [r for r in recs if r["name"] == "pymra.call"]
    if len(roots) < tr.calls:
        return None
    roots = roots[len(roots) - tr.calls:]
    if any(r["end_ns"] is None or r["anchor_ns"] is None for r in roots):
        return None
    by_call = {r["call"]: [] for r in roots}
    for r in recs:
        if r["call"] in by_call:
            by_call[r["call"]].append(r)
    return [by_call[r["call"]] for r in roots]


def per_call(calls, name: str, field: str):
    """``field`` of the spans ``name`` summed over each call (None where a
    call has no such closed span, or one lacks the field)."""
    if calls is None:
        return None
    out = []
    for recs in calls:
        vals = [r[field] for r in recs if r["name"] == name]
        if not vals or any(v is None for v in vals):
            return None
        out.append(float(sum(vals)))
    return np.array(out)


def on_trace_clock(ctx, calls):
    """The calls' root spans (``pymra.call``, ``pymra.bwd``) as intervals
    on the trace's clock (microseconds from its start), each call's put
    there by its anchor: the ``pymra.clock`` host event whose order in the
    stretch matches the call's, at its middle; None without one each."""
    tr = ctx["trace"]
    if calls is None or tr is None:
        return None
    clocks = sorted((h[1], h[2]) for h in tr.host if h[0] == CLOCK)
    if len(clocks) != len(calls):
        return None
    out = []
    for recs, (a, b) in zip(calls, clocks):
        offset = 0.5 * (a + b) - recs[0]["anchor_ns"] * 1e-3
        out += [(r["start_ns"] * 1e-3 + offset, r["end_ns"] * 1e-3 + offset)
                for r in recs if r["parent"] is None
                and r["end_ns"] is not None]
    return out


def setup_spans(name: str) -> list:
    """The set-up spans ``name`` the program kept, oldest first."""
    recs = _records()
    if recs is None:
        return []
    return [r for r in recs if r["call"] is None and r["name"] == name]
