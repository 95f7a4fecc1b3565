"""The least time a kernel could take on the card: a frozen copy of the
``work`` / ``bound_ms`` arithmetic of the repository's chip check, for the
kernels the benchmark reads a roofline share of.

Each input is read once (of a symmetric or triangular input only its lower
triangle, ``P (P + 1) / 2`` entries a member), each output written once, in
float32; a Cholesky factorization or a triangular inverse is ``P^3 / 3``
operations a member. The bound is the larger of the bytes over the HBM rate
and the operations over the float32 peak.
"""
from __future__ import annotations

from portbench.yardstick.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

__all__ = ["bound_ms", "leaf_factor_work"]


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3


def leaf_factor_work(b: int, p: int) -> tuple[float, float]:
    """(bytes, operations) of one call of K1, the fused leaf factorization,
    on ``b`` members of width ``p``: in the conditional block ``C`` and the
    data Gram ``A`` (lower triangles) and the knot mask ``[b, p]``; out the
    posterior factor's inverse ``[b, p, p]`` and four numbers a member (two
    log-determinants, two escalation factors). Operations: the prior
    factorization, the posterior factorization and its inverse, each
    ``p^3 / 3``, once: what a member that needs no jitter escalation
    takes, the least these inputs need."""
    tri = p * (p + 1) // 2
    nbytes = 4.0 * (2 * b * tri + b * p + b * p * p + 4 * b)
    flops = 3.0 * b * p ** 3 / 3.0
    return nbytes, flops
