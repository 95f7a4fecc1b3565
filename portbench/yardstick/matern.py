"""The least time of the general-nu Matern kernel of the program
(``matern_kernel`` and ``matern_pullback_kernel``, the covariance and its
pullback in ``l`` and ``sig``) on one sweep's covariance blocks: the
bytes and operations that :func:`portbench.yardstick.roofline.bound_ms`
takes, frozen here.

Bytes: each input read once (the two blocks of points, one where a block
is of a set of points against itself, and ``l`` and ``sig``), each output
written once (the covariance; the pullback's two sums a set), in float32;
the pullback reads the covariance's cotangent in place of writing it.

Operations: a floor per entry and set that no float32-accurate Bessel K
undercuts. A minimax rational approximation of ``s^nu K_nu(s)`` that holds
float32's precision over a regime is of degree 6 or more (12 fused
multiply-adds, 24 operations, and a division), ``s^nu e^-s`` a logarithm
and an exponential (some 8 fused multiply-adds each) and the distance in
the plane and its scaling 7 more: some 64 operations. The floor counts
half of that, 32, for the covariance, and 48 for the pullback, which
needs ``K_(nu-1)`` beside ``K_nu`` and two sums; at the grad4 cells'
shapes the bytes bound both.
"""
from __future__ import annotations

__all__ = ["FWD_OPS", "PULLBACK_OPS", "cov_blocks", "matern_work"]

#: operations per entry and set, at the least
FWD_OPS = 32.0
PULLBACK_OPS = 48.0
#: coordinates of a point
DIM = 2


def cov_blocks(shape: dict) -> list[tuple[int, int, int, bool]]:
    """``(B, p, q, self_pair)`` of each covariance evaluation of one sweep
    (passes A and B) on the frozen tree's shape (``harness.tree_shape``):
    at each interior level below the root its nodes' knots against their
    ancestors' knots, then against themselves; at each leaf level its
    leaves' locations (padded to the widest) against their ancestors'
    knots, then against themselves."""
    r = shape["r"]
    out = []
    for m, lv in enumerate(shape["levels"]):
        if lv["n_int"]:
            if m:
                out.append((lv["n_int"], r, m * r, False))
            out.append((lv["n_int"], r, r, True))
    for m, lv in enumerate(shape["levels"]):
        if lv["n_leaf"]:
            if m:
                out.append((lv["n_leaf"], lv["P"], m * r, False))
            out.append((lv["n_leaf"], lv["P"], lv["P"], True))
    return out


def matern_work(sets: int, b: int, p: int, q: int, self_pair: bool,
                pullback: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one launch on ``sets`` parameter sets of a
    ``[b, p, q]`` block."""
    entries = float(sets) * b * p * q
    points = b * p * DIM if self_pair else b * (p + q) * DIM
    out = 2 * sets if pullback else 0
    nbytes = 4.0 * (entries + points + 2 * sets + out)
    return nbytes, entries * (PULLBACK_OPS if pullback else FWD_OPS)
