"""Operations of one sweep, counted from the tree's shapes.

A frozen copy of the algorithmic count of the repository's cost model
(``flops``, not ``flops_executed``), by the same conventions: a matmul
``[n, a, b] @ [n, b, c]`` is ``2 n a b c`` operations, a covariance
evaluation of one pair ``KERNEL_FLOPS``, a Cholesky factorization ``p^3 /
3``, a triangular solve with ``q`` columns ``p^2 q``. The forward pass
(likelihood, and on request the posterior) follows the sweep's passes A to
D. The backward pass of the gradient is counted as twice the forward's
likelihood operations, the usual convention for reverse mode (each
product's pullback is two products of the same size), so one value and
gradient is three forwards. ``C`` parameter sets are ``C`` times one set.
"""
from __future__ import annotations

__all__ = ["KERNEL_FLOPS", "sweep_flops", "value_and_grad_flops"]

KERNEL_FLOPS = 20


def sweep_flops(shape: dict, posterior: bool) -> float:
    """Operations of one forward sweep of one parameter set.

    ``shape``: ``r``, ``M`` and per level ``levels[m] = {"n_int", "n_leaf",
    "P", "c"}`` (``P`` the padded leaf width, ``c`` the leaves per parent
    when every parent has the same number, else 0)."""
    r, M = shape["r"], shape["M"]
    lv = shape["levels"]
    f = 0.0
    for m in range(M + 1):  # pass A: interior prior and chain matrices
        n, S = lv[m]["n_int"], m * r
        if not n:
            continue
        f += KERNEL_FLOPS * n * r * (S + r)
        if S:
            f += 2 * n * r * S * S + 2 * n * r * r * S
            f += 2 * n * S * r * S + 2 * n * S * r * r
        f += n * r ** 3 / 3 + n * r ** 3
    for m in range(M + 1):  # pass B: leaves
        n, P, c = lv[m]["n_leaf"], lv[m]["P"], lv[m]["c"]
        if not n:
            continue
        S = m * r
        f += KERNEL_FLOPS * n * P * (S + P)
        if S:
            f += 2 * n * P * S * S * 2 + 2 * n * P * P * S
        f += 2 * n * P ** 3 + 2 * n * P * P
        if S:
            f += 2 * n * P * P * S + 2 * n * P * S * S + 2 * n * P * S
        f += 2 * n * P ** 3 / 3 + n * P ** 3 + n * P * P
        if S:
            f += 2 * n * P * P * S + 2 * n * P * S * S + 2 * n * P * S
        f += n * P * P
    for m in range(M, -1, -1):  # pass C: upward
        n, S = lv[m]["n_int"], m * r
        if not n:
            continue
        f += 2 * n * r ** 3 + n * r ** 3 / 3 + 2 * n * r * r
        if S:
            f += 2 * n * r * r * S + 2 * n * r * S * S
    if posterior:  # pass D
        for m in range(M + 1):
            n, S = lv[m]["n_int"], m * r
            if not n:
                continue
            f += n * r ** 3
            if S:
                f += 2 * n * r * S + 2 * n * r * S * S
        for m in range(M + 1):
            n, P = lv[m]["n_leaf"], lv[m]["P"]
            if not n:
                continue
            S = m * r
            f += 2 * n * P * P + n * P ** 3 + n * P * P
            if S:
                f += (2 * n * P * P * S + 2 * n * P * S + 2 * n * P * S * S
                      + n * P * S)
    return float(f)


def value_and_grad_flops(shape: dict) -> float:
    """One set's likelihood and its gradient: three forwards."""
    return 3.0 * sweep_flops(shape, posterior=False)
