"""``cov_fallback_share`` reads the program's counter: the share of the
general-nu Matern's entries whose Bessel pair took the series or the
continued fraction, from the ``pymra.cov`` spans of the traced calls, and
nothing where a program lacks the counter."""
from __future__ import annotations

from portbench.metrics import cov_fallback_share


def _cov(n, fell=None):
    counts = {"cov_entries": n}
    if fell is not None:
        counts["cov_fallback_entries"] = fell
    return {"name": "pymra.cov", "counts": counts}


ROOT = {"name": "pymra.call", "counts": {}}


def test_fallback_share_reads_the_kernels_counter(monkeypatch):
    """``cov_fallback_share`` is the counter ``cov_fallback_entries`` over
    ``cov_entries``, summed over the traced calls' ``pymra.cov`` spans;
    None where a span lacks the counter (a program without it) or where no
    ``pymra.cov`` span exists."""
    for calls, want in (
            ([[ROOT, _cov(300, 3), _cov(100, 0)], [ROOT, _cov(600, 7)]],
             1.0),
            ([[ROOT, _cov(300, 0)], [ROOT, _cov(700, 0)]], 0.0),
            ([[ROOT, _cov(300, 3), _cov(100)]], None),
            ([[ROOT], [ROOT]], None),
            (None, None)):
        monkeypatch.setattr(cov_fallback_share, "traced_calls",
                            lambda ctx, calls=calls: calls)
        assert cov_fallback_share.read({}) == want
