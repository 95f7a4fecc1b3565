"""Static FLOP / memory-byte / collective-byte accounting for the MRA sweep
(counterpart of ``pymra_tpu/utils/accounting.py``).

Every tensor of :func:`pymra_torch.tree.sweep.mra_sweep` has a static shape
set by the :class:`~pymra_torch.tree.sweep.DevicePlan`, so the sweep's
arithmetic and memory traffic follow from the plan on the host, without
running anything. The counts are the JAX package's, convention for
convention, and equal its counts on the same plan
(``tests/test_torch_utils.py``): a matmul of ``[n, a, b] @ [n, b, c]``
counts ``2*n*a*b*c`` operations; a covariance evaluation of one pair
``KERNEL_FLOPS``; a Cholesky ``n*p^3/3``, and ``flops_executed`` charges
every factorization ``CHOL_CASCADE`` (=3) times, the escalation's worst
case (``flops``, the useful work, charges it once); memory bytes count
each materialized tensor as one write plus one read per consumer, at 4
bytes an entry (float32).

Where the port moves other bytes than this model (it describes the TPU's
kernel structure, the JAX package's Pallas dispatch):

  * the leaf stage: the model charges one ``[n, P, P]`` factor tensor out
    of one fused kernel. The port's K1 (``leaf_factor``) also writes the
    per-member log-determinants and escalation factors, and its inputs
    ``C_own``, ``A_oo`` and the knot mask are separate tensors in memory;
  * the prior chain's inverse factors are separate tensors (torch's
    triangular solve per interior level), and the leaf messages' Gram
    blocks are taken in float64 (``_message_downdate``: twice the bytes of
    the float32 the model charges);
  * collectives: the model charges one ``psum`` of the per-parent ``(A,
    omega)`` messages per level that needs one and an ``[N]`` posterior
    all-gather. The port over ``torch.distributed`` sums each level's
    messages in ONE packed ``all_reduce`` (the same bytes), sums the
    likelihood totals in one more, and reassembles the posterior with an
    ``all_reduce`` of every rank's mean and variance segments placed in a
    zero buffer (``2 * n_shards * slots`` entries, not ``N``: gloo, the
    backend that runs several ranks on one card, has no all-gather of CUDA
    tensors).

The counts are left as the JAX package defines them: they are the model
both packages are compared against. No peak rate is carried here; the
card's peaks stand beside the measurements (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["sweep_cost", "SweepCost", "KERNEL_FLOPS", "CHOL_CASCADE"]

#: operations charged per covariance-kernel evaluation (squared distance in
#: d=2: ~6, sqrt: ~4 equivalent, exp: ~10)
KERNEL_FLOPS = 20
#: factorization attempts of the jitter escalation (1, 1e2, 1e4)
CHOL_CASCADE = 3
F32 = 4  # bytes


class SweepCost(NamedTuple):
    flops: float  #: algorithmic operations per evaluation
    flops_executed: float  #: incl. the unconditional cholesky-cascade retries
    hbm_bytes: float  #: estimated device-memory traffic per evaluation
    psum_bytes_per_level: list  #: [(level, bytes)] collective volume under sharding
    leaf_flops: float  #: shardable (leaf-axis) share of ``flops``
    interior_flops: float  #: replicated share of ``flops``
    per_level: list  #: itemized [(label, flops, bytes)]


def _numel(a) -> int:
    return int(np.prod(a.shape))


def _chol_flops(n, p):
    return n * p**3 / 3.0


def sweep_cost(dplan, compute_posterior: bool = True,
               int_shard_from: int = 10 ** 9) -> SweepCost:
    """Exact-shape cost model of one ``mra_sweep`` evaluation.

    ``int_shard_from``: the critical depth a sharded run would use
    (``pymra_torch.parallel.sharded.int_shard_level``). Interior levels at
    or below it count as *shardable* work (``leaf_flops``) and their
    message aggregation needs no collective; the only per-parent message
    collective left is at the transition level, plus the posterior output
    collective. The huge default replicates every interior level.

    The leaf-pass estimate assumes the fused leaf factorization (one
    ``Li`` tensor in memory, no materialized prior factor): the kernel
    structure (float32, ``jitter != 0``) with leaf width 16 <= P <= 64 and
    ``keep_internals=False``, the flagship configuration. Other
    configurations materialize extra [n, P, P] factors, so their memory
    traffic is undercounted here (see the module docstring for the port's
    other differences).
    """
    r = dplan.r
    M = dplan.M
    N = dplan.n_locs
    lvl0 = dplan.levels[0]
    d = int(lvl0.int_knots.shape[-1] if _numel(lvl0.int_knots)
            else lvl0.leaf_locs.shape[-1])

    flops = 0.0
    flops_exec = 0.0
    hbm = 0.0
    leaf_flops = 0.0
    interior_flops = 0.0
    psum_levels = []
    items = []

    def add(label, f, b, leaf_origin, exec_extra=0.0):
        nonlocal flops, flops_exec, hbm, leaf_flops, interior_flops
        flops += f
        flops_exec += f + exec_extra
        hbm += b
        if leaf_origin:
            leaf_flops += f
        else:
            interior_flops += f
        items.append((label, f, b))

    # ---------------- Pass A: interior prior + chain matrices --------------
    for m, lvl in enumerate(dplan.levels):
        n = lvl.int_knots.shape[0]
        if n == 0:
            continue
        S = m * r
        f = 0.0
        b = 0.0
        # covariance evals: C_all [n, r, S] and C_raw [n, r, r]
        f += KERNEL_FLOPS * n * r * (S + r)
        b += F32 * n * (r * S * 2 + r * r)  # write+read C_all; C_raw fused
        if S:
            f += 2 * n * r * S * S  # Zt = C_all GinvT^T
            f += 2 * n * r * r * S  # C_own downdate
            b += F32 * n * (S * S + r * S * 2)  # read GinvT; write+read Zt
        # cholesky + triangular inverse + chain-matrix recursions
        cf = _chol_flops(n, r)
        f += cf + n * r**3  # chol + triangular_inverse_lower
        if S:
            f += 2 * n * S * r * S + 2 * n * S * r * r  # neg, neg@LinvT
            b += F32 * n * ((S + r) ** 2 * 2 + (S + r) * d * 2)  # chain writes
        add(f"A{m} interior prior (n={n}, S={S})", f, b,
            m >= int_shard_from, exec_extra=(CHOL_CASCADE - 1) * cf)

    # ---------------- Pass B: leaf conditional + A/omega + factorizations --
    for m, lvl in enumerate(dplan.levels):
        n = lvl.leaf_locs.shape[0]
        if n == 0:
            continue
        P = lvl.leaf_locs.shape[1]
        S = m * r
        f = 0.0
        b = 0.0
        f += KERNEL_FLOPS * n * P * (S + P)  # C_all + C_raw
        b += F32 * n * (P * S * 2 + P * P)
        if S:
            f += 2 * n * P * S * S  # Zt
            f += 2 * n * P * S * S  # W
            f += 2 * n * P * P * S  # C_own downdate
            b += F32 * n * (P * S * 4 + P * P * 2)  # Zt, W write+read; C_own
        else:
            b += F32 * n * P * P
        # grouped parent-aggregation: head Gram/downdate blocks land at
        # [n/c, S, S] instead of [n, S, S] (tree/sweep.py Pass B)
        c = (dplan.groups[m][0]
             if dplan.groups is not None and m < len(dplan.groups) else 0)
        n_head = n // c if c else n
        # A/omega assembly (head/own blocks)
        f += 2 * n * P * P * P  # A_oo
        f += 2 * n * P * P  # omg_o
        if S:
            f += 2 * n * P * P * S  # A_oh
            f += 2 * n * P * S * S  # A_hh (per-parent when grouped)
            f += 2 * n * P * S  # omg_h
            b += F32 * (n * (P * P + P * S) + n_head * S * S)  # A writes
        else:
            b += F32 * n * P * P
        # factorizations + solves: the whole leaf factorization stage is
        # ONE kernel (K1, leaf_factor): K_leaf is assembled in the kernel
        # from C_own + the knot mask, the prior factor never leaves it,
        # and the posterior factorization emits only its inverse — memory
        # sees C_own + A_oo in and one [n, P, P] factor tensor (Li) out
        cf = 2 * _chol_flops(n, P)  # L_prior (logdet-only), L_post+inverse
        f += cf + n * P**3  # in-kernel forward-substitution inverse
        f += n * P * P  # v
        b += F32 * n * P * P * 2  # Li write+read
        if S:
            f += n * P * P * S  # Xblk solve
            f += 2 * n * P * S * S  # ATil downdate
            f += 2 * n * P * S  # omgTil
            f += n * P * P * S  # G solve
            b += F32 * (n * P * S * 2 + n_head * S * S)
        f += n * P * P  # g solve
        add(f"B{m} leaf pass (n={n}, P={P}, S={S})", f, b, True,
            exec_extra=(CHOL_CASCADE - 1) * cf)

    # ---------------- Pass C: upward interior ------------------------------
    for m in range(M, -1, -1):
        lvl = dplan.levels[m]
        n = lvl.int_knots.shape[0]
        if n == 0:
            continue
        S = m * r
        w = S + r
        f = 0.0
        b = F32 * n * (w * w + w) * 2  # A/omg aggregate read+write
        f += 2 * n * r * r * r  # Kmat = Kc Kc^T
        cf = _chol_flops(n, r)
        f += cf
        f += n * r * r  # v
        if S:
            f += n * r * r * S  # Xblk
            f += 2 * n * r * S * S  # ATil
            f += n * r * r * S  # G
        f += n * r * r  # g
        # psum volume at this level (A_sh + omg_sh): under the critDepth
        # scheme messages to SHARDED levels stay device-local; a level
        # needs the collective only when it is replicated AND receives
        # from sharded children — the transition level (crit - 1) or a
        # replicated parent of a leaf level
        has_leaf_child = (m + 1 <= M
                          and dplan.levels[m + 1].leaf_locs.shape[0] > 0)
        if m < int_shard_from and (m == int_shard_from - 1
                                   or has_leaf_child):
            psum_levels.append((m, F32 * n * (w * w + w)))
        add(f"C{m} upward (n={n}, S={S})", f, b, m >= int_shard_from,
            exec_extra=(CHOL_CASCADE - 1) * cf)

    # ---------------- Pass D: posterior (downward) -------------------------
    if compute_posterior:
        for m, lvl in enumerate(dplan.levels):
            n = lvl.int_knots.shape[0]
            if n == 0:
                continue
            S = m * r
            f = n * r**3  # LinvT
            if S:
                f += 2 * n * r * S  # w_own
                f += 2 * n * r * S * S  # G Vp
            b = F32 * n * ((S + r) ** 2 * 2)
            add(f"D{m} posterior chain (n={n}, S={S})", f, b,
                m >= int_shard_from)
        for m, lvl in enumerate(dplan.levels):
            n = lvl.leaf_locs.shape[0]
            if n == 0:
                continue
            P = lvl.leaf_locs.shape[1]
            S = m * r
            f = 0.0
            b = 0.0
            f += 2 * n * P * P  # mean_l = T_own g
            f += n * P * P * P  # half solve
            f += n * P * P  # var_l rownorm
            b += F32 * n * P * P * 3  # B_own, L_post re-read; half write
            if S:
                f += 2 * n * P * P * S  # h = W - T_own G
                f += 2 * n * P * S  # mean head
                f += 2 * n * P * S * S  # hv
                f += n * P * S  # rownorm
                b += F32 * n * (P * S * 3 + P * S)  # W, G re-read; h, hv
            b += F32 * n * P * 2 * 2  # mean/var scatter
            add(f"D{m} leaf moments (n={n}, P={P}, S={S})", f, b, True)
        # posterior output collective: the JAX package all-gathers the
        # per-shard slot segments (mean+var), recorded as the
        # equivalent-allreduce volume of an [N] float32 vector (the port's
        # zero-buffer all_reduce moves more: see the module docstring)
        psum_levels.append((-1, F32 * N))

    return SweepCost(
        flops=flops,
        flops_executed=flops_exec,
        hbm_bytes=hbm,
        psum_bytes_per_level=psum_levels,
        leaf_flops=leaf_flops,
        interior_flops=interior_flops,
        per_level=items,
    )
