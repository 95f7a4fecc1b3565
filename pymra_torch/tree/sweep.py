"""Batched MRA sweep: likelihood + posterior moments
(counterpart of ``pymra_tpu/tree/sweep.py``).

Every tree level is one batch: all nodes of a level go through the same
batched matmul / factorization. The passes and their mathematics are the
JAX package's (see its module docstring for the mapping to Katzfuss 2017
and the reference pyMRA):

* Pass A (prior, downward over interior levels): each node's conditional
  prior block against its joint ancestor-knot chain, its jittered Cholesky
  factor and the fused chain stash ``GG = [Ginv^T | GL^T]``.
* Pass B (leaves): the conditional leaf blocks, the data Gram ``A`` and
  ``omega`` per block, the leaf factorizations and the own downdate.
* Pass C (upward over interior levels): child messages summed per parent,
  each node's posterior factor and downdate.
* Pass D (posterior): per-node chain matrices ``U = [V | w]`` and the
  per-leaf mean/variance, reassembled by one gather.

Dispatch: with float32 and ``jitter > 0`` the sweep takes the *kernel
structure* the card runs, the JAX package's Pallas dispatch (its Pass B
leaf branches, ``tree/sweep.py:1026-1078``):

* every jittered Cholesky through
  :func:`pymra_torch.ops.linalg.cholesky_jittered` (K2) up to P = 64 and
  :func:`pymra_torch.ops.linalg.cholesky_cascade` (KC over the blocked
  K8) above;
* leaves with ``16 <= P <= 64`` and diagonal R through the fused
  :func:`pymra_torch.ops.linalg.leaf_factor` (K1);
* the same leaves with a dense R through two kernels: the prior
  log-determinant by :func:`pymra_torch.ops.linalg.cholesky_logdet` (K6),
  the posterior inverse factor and log-determinant by
  :func:`pymra_torch.ops.linalg.cholesky_inv_logdet` (K7);
* narrower leaves: the prior log-determinant by K6, the posterior factor
  by K2 and triangular solves; wider leaves: both factors by KC and the
  posterior inverse by the blocked
  :func:`pymra_torch.ops.linalg.triangular_inverse_lower`.

That is the leaf *route* ``auto`` of the flag ``PYMRA_LEAF_SOLVE``
(:mod:`pymra_torch.utils.config`, the JAX package's
``_use_inverse_solves``): the inverse route where the kernel structure runs
and P >= 16, the triangular route elsewhere. ``inv`` takes the inverse
route everywhere; ``tri`` takes the triangular one everywhere: the prior
log-determinant by K6, the posterior factor by K2 (KC above 64) and every
leaf solve by :func:`pymra_torch.ops.linalg.solve_triangular_batched` (K5)
where ``16 <= P <= 64`` and ``P + Q <= 112``, torch's solve (cuBLAS
``trsm`` on the card) elsewhere, as the JAX package takes XLA's.

Wherever a leaf has its inverse factor the solves are matmuls with it.
Otherwise (float64, or ``jitter == 0``) the sweep takes the *plain
structure* of the JAX package's CPU path: ``torch.linalg`` factorizations
and triangular solves, which run on CPU tensors only. The ops wrappers
choose the CUDA kernel or its plain twin by the tensors' device, so a CPU
run of the kernel structure executes the exact sequence of operations the
card does.

Dense measurement error (``r_dense``): each leaf whitens its data and basis
against the Cholesky factor of its own R block (the reference's slicing of
R to children; cross-leaf entries drop out) and sends its parent the
ungrouped message.

Differentiation: both structures differentiate end to end with autograd
(``MRAModel.loglik_fn``, or ``sweep(...).loglik.backward()``). Every
jittered factorization is linearized at its selected escalation factor —
the kernels' autograd Functions in the kernel structure,
:class:`_CholCascade` in the plain one — so a discarded attempt never
reaches a gradient. Jitter scales are structural (detached).

Index mode (``make_device_plan(..., index_points=True)``): the plan's
points are ``[..., 1]`` long location indices instead of coordinates, for a
covariance given as a dense matrix
(:class:`pymra_torch.kernels.MatrixKernel`). No pass does arithmetic on
points: they are only stacked, gathered and handed to the covariance.

``keep_internals`` returns the per-level stashes the basis matrices are
assembled from (:mod:`pymra_torch.tree.basis`); it takes the unfused leaf
route and replays the posterior's per-ancestor downdates.

A batch of parameter sets (a covariance with a ``batch_shape`` of
``(C,)``, such as a :class:`pymra_torch.kernels.Kernel` with ``[C]``
hyper-parameters: the port's counterpart of ``jax.vmap`` over chains,
particles or Monte-Carlo draws): every tensor that depends on the
hyper-parameters carries a leading ``[C]`` axis in front of the node axis,
and the likelihood comes out ``[C]``. The plan, the points, ``y``, ``R`` and
:func:`prepare_obs`'s tensors stay shared and unbatched. Each
factorization and solve sees ``C`` times the level's batch in one call, so
each level's kernels launch once for all ``C`` sets; the jitter scale stays
per member, hence per set. Every pass takes the batch: the posterior
comes out ``[C, N]``; a dense R's blocks are factored and ``y`` whitened
once for all sets (only the basis is whitened per set, the sets riding as
columns of one solve); ``keep_internals`` returns every stash with the
``[C]`` axis in front (``jax.vmap``'s output); a sharded sweep sums the
sets' partial sums in the same collectives. No path loops over the sets.

Tracing (:mod:`pymra_torch.utils.profiling`): inside a traced facade call
each pass is a span (``pymra.pass.A`` to ``D``, ``pymra.prep`` where the
observations are prepared per call) and each level of passes A, B and C a
child span; at the end of each pass an identity marker on a tensor the pass
hands on puts the pass's boundary into the backward. Untraced, each span
site tests one boolean.

Sharding (``axis_name``: the data axis's ``torch.distributed`` process
group, where the JAX package names a ``shard_map`` axis): each rank runs
the sweep on its slice of a plan padded by
:func:`pymra_torch.parallel.sharded.pad_plan_for_sharding` — its window of
every leaf level and of the interior levels from ``int_shard_from`` on
(the reference's ``critDepth``), the coarser levels whole on every rank.
The leaf-origin messages to a replicated level, the single window message
at the transition level and the likelihood totals are summed over the
group by ``all_reduce`` (differentiable: the backward sums the cotangents
the same way), so every rank ends with the same objective. The posterior
is reassembled through the plan's ``post_inv`` slot map
(:func:`pymra_torch.parallel.sharded.sharded_sweep`). Ranks issue the
same collectives in the same order: nothing in the sweep branches on data.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from pymra_torch.ops.linalg import (
    MAX_P,
    cholesky_cascade,
    cholesky_inv_logdet,
    cholesky_jittered,
    cholesky_logdet,
    cholesky_pullback_ref,
    leaf_factor,
    set_matmul_precision,
    solve_triangular_batched,
    triangular_inverse_lower,
)
from pymra_torch.tree.plan import TreePlan
from pymra_torch.utils import profiling as _tr
from pymra_torch.utils.config import flag

__all__ = ["DeviceLevel", "DevicePlan", "SweepResult", "make_device_plan",
           "mra_sweep", "prepare_obs", "LOG2PI", "set_matmul_precision"]

LOG2PI = float(np.log(2.0 * np.pi))

#: leaf widths that go through the fused leaf kernel (diagonal R) or the
#: two-kernel branch (dense R) in the kernel structure
LEAF_FUSED_MIN_P = 16
LEAF_FUSED_MAX_P = 64
#: a triangular solve in the kernel structure takes K5 for 16 <= P <= 64
#: and P + Q up to this (the JAX package's ``_tri_solve`` dispatch)
SOLVE_KERNEL_MAX_PQ = 112


@dataclasses.dataclass
class DeviceLevel:
    """Per-level tensors on the device (see ``plan.LevelGroup``)."""

    int_knots: torch.Tensor  # [n_int, r, d] knot coordinates (or indices)
    int_path: torch.Tensor  # [n_int, level]
    int_parent: torch.Tensor  # [n_int]
    leaf_locs: torch.Tensor  # [n_leaf, P, d] (or [n_leaf, P, 1] indices)
    leaf_loc_gidx: torch.Tensor  # [n_leaf, P] (pad = N)
    leaf_loc_mask: torch.Tensor  # [n_leaf, P] bool
    leaf_is_knot: torch.Tensor  # [n_leaf, P] bool
    leaf_path: torch.Tensor  # [n_leaf, level]
    leaf_parent: torch.Tensor  # [n_leaf]


@dataclasses.dataclass
class DevicePlan:
    """Device-resident static plan.

    ``groups[m] = (c_leaf, c_int, n_leaf, n_int)`` gives the uniform
    children-per-parent count of level ``m``'s leaves and interior nodes
    when they are stored contiguously under their parents (0 when not);
    ``iota_groups`` certifies that such parents are exactly
    ``repeat(arange(n_parents), c)``, so parent stashes are broadcast
    instead of gathered. ``post_inv [N]`` is each location's slot in the
    concatenation of all leaf levels' flattened ``[n_leaf * P]`` slots
    (the leaves partition the locations), so the posterior is reassembled
    by one gather; ``None`` falls back to scatter-adds. With
    ``index_points`` the point tensors (``int_knots``, ``leaf_locs``) hold
    long location indices ``[..., 1]``; ``dtype`` is the float dtype of the
    sweep's arithmetic either way.

    A plan padded for sharding over ``n`` ranks
    (:func:`pymra_torch.parallel.sharded.pad_plan_for_sharding`) has
    ``shard_groups = n``: on each rank the grouped parent rows of a leaf
    level under a replicated parent level are the contiguous window
    ``[rank * g, (rank + 1) * g)`` of the parent stashes (``g`` the rank's
    group count), read by a slice instead of a gather. Its ``post_inv`` maps
    each location to its slot in the concatenation of every rank's slot
    segments (rank-major). ``int_shard_from`` is the first interior level
    whose nodes are split over the ranks too (the huge default: none); at
    such levels ``groups[m][3]`` is the per-rank interior count.
    """

    levels: tuple[DeviceLevel, ...]
    n_locs: int
    r: int
    M: int
    groups: tuple | None = None
    post_inv: torch.Tensor | None = None
    iota_groups: bool = False
    index_points: bool = False
    dtype: torch.dtype = torch.float32
    shard_groups: int = 0
    int_shard_from: int = 10 ** 9

    @property
    def device(self) -> torch.device:
        return self.levels[0].leaf_loc_gidx.device


def plan_groups(plan: TreePlan) -> list[tuple[int, int, int, int]]:
    """``DevicePlan.groups`` of a host plan (see :class:`DevicePlan`)."""
    groups = []
    prev_n_int = 0
    for g in plan.levels:
        c_leaf = c_int = 0
        if prev_n_int:
            if g.n_leaf and g.n_leaf % prev_n_int == 0:
                c = g.n_leaf // prev_n_int
                if np.array_equal(np.asarray(g.leaf_parent),
                                  np.repeat(np.arange(prev_n_int), c)):
                    c_leaf = c
            if g.n_int and g.n_int % prev_n_int == 0:
                c = g.n_int // prev_n_int
                if np.array_equal(np.asarray(g.int_parent),
                                  np.repeat(np.arange(prev_n_int), c)):
                    c_int = c
        groups.append((c_leaf, c_int, int(g.n_leaf), int(g.n_int)))
        prev_n_int = g.n_int
    return groups


def plan_post_inv(plan: TreePlan) -> np.ndarray | None:
    """``DevicePlan.post_inv`` of a host plan, or None when the leaf slots
    do not hold every location exactly once."""
    n = plan.n_locs
    flat = [np.asarray(g.leaf_loc_gidx).reshape(-1) for g in plan.levels
            if g.n_leaf]
    if not flat:
        return None
    cat = np.concatenate(flat)
    valid = np.flatnonzero(cat < n)
    owners = cat[valid]
    if len(owners) != n or len(np.unique(owners)) != n:
        return None
    inv = np.empty(n, dtype=np.int64)
    inv[owners] = valid
    return inv


def make_device_plan(plan: TreePlan, dtype=torch.float32, device="cuda",
                     index_points: bool = False) -> DevicePlan:
    """Upload a host :class:`TreePlan` as static tensors on ``device``.

    Coordinates are pre-gathered per node; padded leaf slots point at the
    last location and are masked (as in the JAX package, whose docstring
    says location 0 while its code also clamps to the last). With
    ``index_points`` the points are the global location indices, ``[...,
    1]`` long, for :class:`pymra_torch.kernels.MatrixKernel`.
    """
    locs = np.asarray(plan.locs)
    n = len(locs)
    if index_points:
        locs = np.arange(n, dtype=np.int64)[:, None]
    d = locs.shape[1]
    levels = []
    for g in plan.levels:
        ik = locs[g.int_knot_gidx] if g.n_int else np.zeros((0, plan.r, d))
        ll = (locs[np.minimum(g.leaf_loc_gidx, n - 1)] if g.n_leaf
              else np.zeros((0, 0, d)))
        levels.append({
            "int_knots": ik, "int_path": g.int_path,
            "int_parent": g.int_parent, "leaf_locs": ll,
            "leaf_loc_gidx": g.leaf_loc_gidx,
            "leaf_loc_mask": g.leaf_loc_mask,
            "leaf_is_knot": g.leaf_is_knot, "leaf_path": g.leaf_path,
            "leaf_parent": g.leaf_parent,
        })
    return device_plan_from_numpy(levels, n, plan.r, plan.M,
                                  plan_groups(plan), plan_post_inv(plan),
                                  True, dtype=dtype, device=device,
                                  index_points=index_points)


def device_plan_from_numpy(levels, n_locs: int, r: int, M: int, groups,
                           post_inv, iota_groups: bool, dtype=torch.float32,
                           device="cuda",
                           index_points: bool = False) -> DevicePlan:
    """Build a :class:`DevicePlan` from numpy arrays: ``levels`` holds, per
    level, ``{field: array}`` keyed by the :class:`DeviceLevel` field names
    (e.g. ``{k: np.asarray(v) for k, v in jax_level._asdict().items()}``);
    the other arguments are the plan attributes of the same names
    (``post_inv`` as an array or None). With ``index_points`` the point
    arrays are location indices and stay long; else they become
    ``dtype``."""
    dev = torch.device(device)

    # torch.tensor copies: arrays taken from JAX are read-only
    def idx(a):
        return torch.tensor(np.asarray(a), dtype=torch.long, device=dev)

    def flt(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def msk(a):
        return torch.tensor(np.asarray(a), dtype=torch.bool, device=dev)

    pts = idx if index_points else flt
    conv = {"int_knots": pts, "leaf_locs": pts, "leaf_loc_mask": msk,
            "leaf_is_knot": msk}
    lv = tuple(DeviceLevel(**{f.name: conv.get(f.name, idx)(lvl[f.name])
                              for f in dataclasses.fields(DeviceLevel)})
               for lvl in levels)
    return DevicePlan(
        lv, int(n_locs), int(r), int(M),
        groups=(tuple(tuple(int(v) for v in g) for g in groups)
                if groups is not None else None),
        post_inv=idx(post_inv) if post_inv is not None else None,
        iota_groups=bool(iota_groups), index_points=bool(index_points),
        dtype=dtype)


class SweepResult(NamedTuple):
    #: the reference's ``getLikelihood()`` value: ``logdet(Sigma_y) +
    #: y^T Sigma_y^{-1} y`` over observed entries — a minimization objective
    #: equal to ``-2 loglik - n_obs log 2pi``
    objective: torch.Tensor
    #: the proper marginal log-density of the observed data
    loglik: torch.Tensor
    mean: torch.Tensor | None  # [N] posterior mean at every location
    var: torch.Tensor | None  # [N] posterior variance at every location


# ---------------------------------------------------------------------------
# factorizations and solves, dispatched by dtype and jitter
# ---------------------------------------------------------------------------

def _kernel_structure(dtype: torch.dtype, jitter: float) -> bool:
    return dtype == torch.float32 and bool(jitter)


def _plain_only(mat: torch.Tensor) -> None:
    if mat.device.type != "cpu":
        raise NotImplementedError(
            "the sweep on an accelerator runs float32 with jitter > 0 "
            "(kernel structure); the plain structure (float64 or jitter 0) "
            "runs on the CPU only")


def _cholesky_nan(mat: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky`` that returns NaN for a failed member
    instead of raising (the JAX/XLA semantics the escalation relies on)."""
    _plain_only(mat)
    L, info = torch.linalg.cholesky_ex(mat)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _jit_scale(mat: torch.Tensor, jitter: float,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """Per-member jitter ``jitter*(scale+1)``, ``scale`` the mean |diagonal|
    of ``mat`` unless given; structural, so no gradient flows into it."""
    if scale is None:
        scale = torch.diagonal(mat, dim1=-2, dim2=-1).abs().mean(-1)
    return jitter * (scale.detach() + 1.0)


def _chol(mat: torch.Tensor, jitter: float,
          scale: torch.Tensor | None = None) -> torch.Tensor:
    """Cholesky factor of ``mat + f*jitter*(scale+1)*I``, ``scale`` the mean
    |diagonal| of ``mat`` unless given (posterior blocks pass their prior
    block's scale), ``f`` escalating 1, 1e2, 1e4 per member on failure."""
    if not jitter:
        return _cholesky_nan(mat)
    jit_scale = _jit_scale(mat, jitter, scale)
    if _kernel_structure(mat.dtype, jitter):
        chol = (cholesky_jittered if mat.shape[-1] <= MAX_P
                else cholesky_cascade)
        return chol(mat.contiguous(), jit_scale.contiguous())[0]
    return _CholCascade.apply(mat, jit_scale)


def _chol_logdiag(mat: torch.Tensor, jitter: float) -> torch.Tensor:
    """``sum log diag`` of :func:`_chol`'s factor; in the kernel structure
    up to P = 64 without forming the factor (K6, the JAX package's
    ``_chol_logdiag``)."""
    if _kernel_structure(mat.dtype, jitter) and mat.shape[-1] <= MAX_P:
        jit_scale = _jit_scale(mat, jitter)
        return cholesky_logdet(mat.contiguous(), jit_scale.contiguous())[0]
    return _logdiag_sum(_chol(mat, jitter))


class _CholCascade(torch.autograd.Function):
    """The plain structure's jitter cascade (the JAX package's
    ``_chol_cascade``): factor ``mat + jit_scale*I``; members that come
    back NaN are retried at 1e2x and 1e4x, selected by ``torch.where``.

    Differentiated at the selected factor only (the JAX package's custom
    JVP): a discarded NaN attempt never reaches the Cholesky pullback, so
    an escalated member gets a finite gradient and cannot poison healthy
    members. ``jit_scale`` is a structural constant."""

    @staticmethod
    def forward(ctx, mat, jit_scale):
        eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
        jit_scale = jit_scale[..., None, None]
        c = _cholesky_nan(mat + jit_scale * eye)
        for factor in (1e2, 1e4):
            bad = ~torch.isfinite(c).all(-1).all(-1)[..., None, None]
            c = torch.where(
                bad, _cholesky_nan(mat + (factor * jit_scale) * eye), c)
        ctx.save_for_backward(c)
        return c

    @staticmethod
    def backward(ctx, lbar):
        c, = ctx.saved_tensors
        return cholesky_pullback_ref(c, lbar, solve=_tri_solve)[0], None


def _tri_solve(L: torch.Tensor, B: torch.Tensor, trans: bool = False,
               kernel: bool = False, q: int | None = None) -> torch.Tensor:
    """Solve ``L x = B`` (or ``L^T x = B``) for a batch of lower factors.
    With ``kernel`` (the kernel structure) factors of width 16 to 64 with
    ``P + Q <= 112`` go through K5, as the JAX package's ``_tri_solve``
    takes its Pallas kernel there; everything else is ``torch.linalg``.
    ``q`` is the width the route is decided on (default ``B``'s: one
    parameter set's, where the sets of a batch ride as columns)."""
    p = L.shape[-1]
    q = B.shape[-1] if q is None else q
    if (kernel and LEAF_FUSED_MIN_P <= p <= LEAF_FUSED_MAX_P
            and p + q <= SOLVE_KERNEL_MAX_PQ):
        return solve_triangular_batched(L.contiguous(), B.contiguous(), trans)
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B,
                                             upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def _shared_solve(L: torch.Tensor, B: torch.Tensor, nd: int,
                  kernel: bool) -> torch.Tensor:
    """``L^-1 B`` for factors ``L [n, P, P]`` shared by the sets of ``B
    [(C,) n, P, Q]``: the sets ride as the columns of one solve (``L`` is
    not copied), the route decided on one set's ``Q``, as ``jax.vmap``
    batches a triangular solve whose factor is unbatched."""
    if not nd:
        return _tri_solve(L, B, kernel=kernel)
    C, n, P, Q = B.shape
    X = _tri_solve(L, B.permute(1, 2, 0, 3).reshape(n, P, C * Q),
                   kernel=kernel, q=Q)
    return X.reshape(n, P, C, Q).permute(2, 0, 1, 3)


def _use_inverse_solves(p: int, kernel_structure: bool) -> bool:
    """The leaf route (the JAX package's ``_use_inverse_solves``): invert
    the leaf's posterior factor once and make its solves matmuls, or solve
    with the factor. ``PYMRA_LEAF_SOLVE=inv|tri`` chooses; ``auto`` inverts
    in the kernel structure from P = 16 on, where the JAX package inverts
    on the TPU."""
    mode = flag("PYMRA_LEAF_SOLVE")
    if mode == "auto":
        return kernel_structure and p >= LEAF_FUSED_MIN_P
    return mode == "inv"


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of small (r x r) lower triangles."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _logdiag_sum(chol: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def _message_downdate(W, w, X):
    """The leaf's message to its parent, ``W^T diag(w) W - X^T X`` (with
    ``w`` None, ``W^T W - X^T X``: the dense-R form, ``W`` the whitened
    head basis).

    The two Gram blocks carry the data weight ``1/R`` and nearly cancel
    when R is small: on the N=10^4 bench tree (R = 1e-4) a float32
    subtraction left the float32 objective 1.7e-3 off its float64 golden on
    an NVIDIA H100 (700 W), most of the 2e-3 budget; with both products and
    their difference taken in float64 and rounded once, 1.3e-4. The
    float64 GEMM is ~0.55 ms of a 25.6 ms N=10^6 evaluation on that card.
    """
    wide = torch.float64 if W.dtype == torch.float32 else W.dtype
    Wd, Xd = W.to(wide), X.to(wide)
    Ww = Wd if w is None else Wd * w.to(wide)[..., None]
    out = Ww.transpose(-1, -2) @ Wd
    return (out - Xd.transpose(-1, -2) @ Xd).to(W.dtype)


def _jitter_lift(C_raw, C_own, jitter):
    """Floor conditional variances relative to the prior variance (the
    low-precision downdate chain can push them slightly negative)."""
    d_raw = torch.diagonal(C_raw, dim1=-2, dim2=-1)
    d_own = torch.diagonal(C_own, dim1=-2, dim2=-1)
    lift = torch.clamp(jitter * d_raw - d_own, min=0.0)
    eye = torch.eye(C_own.shape[-1], dtype=C_own.dtype, device=C_own.device)
    return C_own + lift[..., :, None] * eye


def _window(stash: torch.Tensor, start: int, length: int,
            axis: int = -3) -> torch.Tensor:
    """Rows ``[start, start + length)`` of ``stash`` along its node axis
    ``axis`` (a stash's third from the end, behind a batch), zero rows past
    its end (a rank's window that covers padding groups)."""
    short = start + length - stash.shape[axis]
    if short > 0:
        pad = list(stash.shape)
        pad[axis] = short
        stash = torch.cat([stash, stash.new_zeros(pad)], dim=axis)
    return stash.narrow(axis, start, length)


def _chain_cond(covfn, X, parent, chain_Q, chain_GG, jitter,
                want_W: bool = False, group: int = 0, iota: bool = False,
                shard: tuple[int, int] | None = None):
    """Conditional pass against the joint ancestor-knot chain:

        [Zt | W] = Sigma(X, Q_all) [Ginv^T | GL^T]
        C_own    = Sigma(X, X) - Zt Zt^T

    ``Zt`` is the whitened cross-covariance, ``W`` the conditional ancestor
    basis. With ``group = c > 0`` the nodes sit c-per-parent contiguously:
    each parent stash row is read once and consumed by a reshaped batched
    matmul (with ``iota`` the parent rows are the stash itself). With
    ``shard = (rank, n_ranks)`` on a sharded plan the rank's ``n/c``
    parent rows are the window ``[rank * n/c, (rank + 1) * n/c)`` of the
    replicated stashes, zero past their end: padding groups read zero rows
    (``Zt = W = 0``) and carry zero observation weight.

    Returns ``(Zt [n, q, S], C_own [n, q, q], W | None, Wg | None)``; ``Wg``
    is the group-major ``[n/c, c q, S]`` view of ``W``. A batched ``covfn``
    and ``chain_GG`` (a ``[C]`` axis in front of the nodes) put the same
    axis in front of every output; ``X`` and ``chain_Q`` are points, shared.
    """
    n, q = X.shape[0], X.shape[1]
    S = chain_GG.shape[-2]
    W = Wg = None
    if group:
        Xg = X.reshape(n // group, group * q, X.shape[-1])
        if shard is not None:
            psg = n // group  # the rank's groups, padding groups included
            Qg = _window(chain_Q, shard[0] * psg, psg)
            GGg = _window(chain_GG, shard[0] * psg, psg)
        elif iota:
            Qg, GGg = chain_Q, chain_GG
        else:
            gpar = parent[::group]
            Qg, GGg = chain_Q[gpar], _rows(chain_GG, gpar)
        if not want_W:
            GGg = GGg[..., :S]
        ZW = covfn(Xg, Qg) @ GGg  # [(C,) n/c, c q, S or 2S]
        batch = ZW.shape[:-3]
        Zt = ZW[..., :S].reshape(batch + (n, q, S))
        if want_W:
            Wg = ZW[..., S:]
            W = Wg.reshape(batch + (n, q, S))
    else:
        Qp = chain_Q[parent]
        GGp = _rows(chain_GG if want_W else chain_GG[..., :S], parent)
        ZW = covfn(X, Qp) @ GGp
        Zt = ZW[..., :S]
        if want_W:
            W = ZW[..., S:]
    C_raw = covfn(X, X)
    C_own = C_raw - Zt @ Zt.transpose(-1, -2)
    if jitter:
        C_own = _jitter_lift(C_raw, C_own, jitter)
    return Zt, C_own, W, Wg


def prepare_obs(dplan: DevicePlan, y, r_diag) -> tuple:
    """Per-leaf observation tensors of a sweep, independent of the
    covariance hyper-parameters: weights ``w = 1/R`` on observed slots,
    ``w*y``, and per-leaf ``logdet R``, ``y^T R^-1 y`` and observation
    counts. Call once per data vector and pass to :func:`mra_sweep` as
    ``prep=`` to skip the slot gather of ``y`` in every evaluation."""
    N = dplan.n_locs
    fl = dict(dtype=dplan.dtype, device=dplan.device)
    y = torch.as_tensor(y, **fl).reshape(-1)
    r_diag = torch.as_tensor(r_diag, **fl).expand(N)
    y_ext = torch.cat([y, torch.zeros(1, **fl)])
    r_ext = torch.cat([r_diag, torch.ones(1, **fl)])
    out = []
    for lvl in dplan.levels:
        if lvl.leaf_locs.shape[0] == 0:
            out.append(None)
            continue
        y_leaf = y_ext[lvl.leaf_loc_gidx]
        r_leaf = r_ext[lvl.leaf_loc_gidx]
        obs = torch.isfinite(y_leaf) & lvl.leaf_loc_mask
        zero = torch.zeros((), **fl)
        y0 = torch.where(obs, y_leaf, zero)
        w = torch.where(obs, 1.0 / r_leaf, zero)
        out.append({
            "w": w,
            "wy": w * y0,
            "logdet_R": torch.where(obs, torch.log(r_leaf), zero).sum(-1),
            "quad_y": (w * y0 * y0).sum(-1),
            "n_obs": obs.sum(-1).to(dplan.dtype),
        })
    return tuple(out)


def _dense_obs(dplan: DevicePlan, y, r_dense) -> tuple:
    """Per-leaf observation tensors under a dense ``[N, N]`` R: the
    observed-slot mask ``o``, ``y`` with zeros off it, the counts, and each
    leaf's own R block with unobserved and padded slots decoupled
    (identity rows and columns), so they contribute nothing."""
    N = dplan.n_locs
    fl = dict(dtype=dplan.dtype, device=dplan.device)
    y = torch.as_tensor(y, **fl).reshape(-1)
    R = torch.as_tensor(r_dense, **fl)
    if tuple(R.shape) != (N, N):
        raise ValueError(f"r_dense: shape {tuple(R.shape)}, expected "
                         f"({N}, {N})")
    out = []
    for lvl in dplan.levels:
        if lvl.leaf_locs.shape[0] == 0:
            out.append(None)
            continue
        # padded slots (index N) read the last location; the mask drops it
        gidx = lvl.leaf_loc_gidx.clamp(max=N - 1)
        y_leaf = y[gidx]
        obs = torch.isfinite(y_leaf) & lvl.leaf_loc_mask
        o = obs.to(dplan.dtype)
        P = gidx.shape[1]
        R_m = (R[gidx[:, :, None], gidx[:, None, :]]
               * (o[:, :, None] * o[:, None, :])
               + (1.0 - o)[:, :, None] * torch.eye(P, **fl))
        out.append({"o": o, "y0": torch.where(obs, y_leaf,
                                              torch.zeros((), **fl)),
                    "R_m": R_m, "n_obs": o.sum(-1)})
    return tuple(out)


def mra_sweep(
    dplan: DevicePlan,
    covfn: Callable,
    y,
    r_diag,
    compute_posterior: bool = True,
    jitter: float = 0.0,
    keep_internals: bool = False,
    axis_name: str | None = None,
    r_dense=None,
    prep: tuple | None = None,
    posterior_segments: bool = False,
) -> SweepResult | tuple[SweepResult, dict]:
    """Run the full MRA computation: likelihood and (optionally) posterior.

    Args:
      dplan: static device plan from :func:`make_device_plan`.
      covfn: batched covariance ``(x [..., p, d], y [..., q, d]) ->
        [..., p, q]``, typically a :class:`pymra_torch.kernels.Kernel`.
      y: ``[N]`` observations, NaN marking missing entries.
      r_diag: scalar or ``[N]`` measurement-error variance (diagonal R).
      compute_posterior: also run the downward pass for mean/var.
      jitter: scale-relative diagonal regularization before each Cholesky.
      r_dense: optional ``[N, N]`` measurement-error covariance (array or
        tensor); each leaf whitens against its own block of it, entries
        coupling different leaves drop out. ``r_diag`` and ``prep`` are
        then ignored.
      prep: optional :func:`prepare_obs` output for this ``(y, r_diag)``;
        ``y``/``r_diag`` are then ignored.
      keep_internals: also return the per-level stashes, as the JAX
        package: ``(result, {"prior_L", "chain_Q", "chain_GG", "leaf",
        "interior"})``. The leaves then keep their prior factor
        (``L_prior``), the basis blocks ``Bstack`` and, with the posterior,
        the posterior basis blocks ``post_blocks``; the fused leaf kernel
        is off. Not with sharded interior levels.
      axis_name: the ``torch.distributed`` process group of the data axis
        when ``dplan`` is this rank's slice of a plan padded for sharding
        (:func:`pymra_torch.parallel.sharded.local_plan`); the shard index
        is the rank in the group. Leaf-origin partial sums are summed over
        the group, the coarse levels run replicated.
      posterior_segments: (with ``axis_name``; used by
        :func:`pymra_torch.parallel.sharded.sharded_sweep`) return this
        rank's posterior slot segments as ``mean``/``var`` instead of
        ``[N]`` vectors; the caller reassembles them through
        ``dplan.post_inv``.

    A ``covfn`` with a ``batch_shape`` of ``(C,)`` (a
    :class:`pymra_torch.kernels.Kernel` with ``[C]`` hyper-parameters) runs
    ``C`` parameter sets through one sweep, on every path: ``objective``
    and ``loglik`` come out ``[C]``, ``mean`` and ``var`` ``[C, N]`` (a
    rank's segments ``[C, slots]``) and every stash of ``keep_internals``
    has the ``[C]`` axis in front, as ``jax.vmap`` of the sweep returns
    them. One batch axis only.
    """
    batch = _batch_of(covfn)
    group = axis_name
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(
            f"axis_name: expected the data axis's torch.distributed "
            f"ProcessGroup (for example mesh.get_group('data')), got "
            f"{group!r}; the port has no named mesh axes inside the sweep")
    if posterior_segments and group is None:
        raise ValueError("posterior_segments needs a process group "
                         "(axis_name): they are one rank's segments")
    set_matmul_precision()
    dense = None
    if r_dense is not None or prep is None:
        sp = _tr.begin("pymra.prep") if _tr.ON else None
        if r_dense is not None:
            dense = _dense_obs(dplan, y, r_dense)
        else:
            prep = prepare_obs(dplan, y, r_diag)
        if sp is not None:
            _tr.end(sp)
    return _mra_sweep_impl(dplan, covfn, compute_posterior, float(jitter),
                           prep, dense, keep_internals, group,
                           posterior_segments, batch)


def _batch_of(covfn) -> tuple[int, ...]:
    """The covariance's batch of parameter sets: ``()`` or ``(C,)``."""
    batch = tuple(getattr(covfn, "batch_shape", ()))
    if len(batch) > 1:
        raise ValueError(f"mra_sweep: one batch axis of parameter sets, got "
                         f"batch_shape {batch}")
    return batch


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of a group; the backward sums the cotangents the
    same way (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _all_reduce(x: torch.Tensor, group, what: str) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group``, differentiably. ``what``
    names the collective (``"messages"``, ``"totals"`` or ``"posterior"``)
    for tracing and timing."""
    return _AllReduce.apply(x, group)


def _all_reduce_packed(tensors, group, what: str) -> list:
    """:func:`_all_reduce` of several tensors in one collective."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group,
                       what)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def _int_group(dplan: DevicePlan, m: int, n_local: int) -> int:
    """Uniform children-per-parent of interior level ``m`` (0 = not
    grouped); ``groups[m][3]`` is the per-rank count at sharded levels."""
    if not m or dplan.groups is None:
        return 0
    ci = dplan.groups[m][1]
    return ci if (ci and n_local == dplan.groups[m][3]) else 0


def _window_start(shard_idx, crit: int, m: int, n_local: int, c: int):
    """First parent row of this rank's window at the transition level
    ``m == crit`` of a sharded sweep; None elsewhere, where the parent
    stash is whole or already local."""
    if c and shard_idx is not None and m == crit:
        return shard_idx * (n_local // c)
    return None


def _rows(stash, idx):
    """Rows ``idx`` of a stash ``[(C,) n, a, b]``: a gather over its node
    axis, the third from the end, shared by a batch in front of it."""
    return stash[..., idx, :, :]


def _parent_rows(stash, parent, c: int, n_local: int, start=None):
    """Per-node rows of a parent-level stash ``[(C,) n_par, a, b]``: a
    broadcast when the plan certifies iota grouping (the stash is local to
    the rank or whole), the rank's window from row ``start`` at the
    transition level of a sharded plan, else a gather."""
    if c:
        n_par = n_local // c
        if stash.shape[-3] == n_par:
            return stash.repeat_interleave(c, dim=-3)
        if start is not None:
            return stash[..., start:start + n_par, :, :].repeat_interleave(
                c, dim=-3)
    return _rows(stash, parent)


def _mra_sweep_impl(dplan, covfn, compute_posterior, jitter, prep, dense,
                    keep_internals, group=None, posterior_segments=False,
                    batch=()):
    # ``batch``: ``()`` or ``(C,)``, the axis in front of the node axis of
    # every hyper-parameter-dependent tensor; ``nd`` is the node axis
    nd = len(batch)
    levels = dplan.levels
    M, r = dplan.M, dplan.r
    dtype = dplan.dtype
    fl = dict(dtype=dtype, device=dplan.device)
    kernel_structure = _kernel_structure(dtype, jitter)

    # shard bookkeeping (the JAX package's shard_map branch): on a plan
    # padded for sharding, this rank's windows start at rank * (its count);
    # interior levels >= crit hold only this rank's nodes
    shard_idx = None
    if group is not None and dplan.shard_groups:
        shard_idx = dist.get_rank(group)
    crit = dplan.int_shard_from if shard_idx is not None else 10 ** 9
    if keep_internals and crit <= M:
        raise ValueError(
            "keep_internals is not supported with sharded interior levels "
            "(DevicePlan.int_shard_from); run the diagnostic sweep "
            "unsharded")

    # ---------------- Pass A: prior (downward), interior levels ------------
    # chain stashes: stacked ancestor knots (own last) and the fused chain
    # matrix GG = [Ginv^T | GL^T], built by the block recursions
    #   Ginv^T = [[GinvT_p, -GinvT_p Zt^T Linv^T], [0, Linv^T]]
    #   GL^T   = [[GLT_p,   -GinvT_p Zt^T       ], [0, I     ]]
    prior_L: list = [None] * (M + 1)
    chain_Q: list = [None] * (M + 1)
    chain_GG: list = [None] * (M + 1)
    sp = _tr.begin("pymra.pass.A") if _tr.ON else None
    for m, lvl in enumerate(levels):
        n_int = lvl.int_knots.shape[0]
        if n_int == 0:
            continue
        lsp = _tr.begin("pymra.pass.A.level", m) if _tr.ON else None
        Q = lvl.int_knots
        grp_i = _int_group(dplan, m, n_int)
        shard_i = None
        iota_i = False
        if grp_i:
            if shard_idx is not None and m == crit:
                shard_i = (shard_idx, dplan.shard_groups)
            else:
                # the parent stash is local (a sharded level over sharded
                # parents) or whole with certified iota grouping
                iota_i = chain_GG[m - 1] is not None and (
                    chain_GG[m - 1].shape[-3] * grp_i == n_int)
        pgrp = grp_i if (iota_i or shard_i) else 0
        pstart = _window_start(shard_idx, crit, m, n_int, pgrp)
        if m == 0:
            C_own = covfn(Q, Q)
            Zt = None
        else:
            Zt, C_own, _, _ = _chain_cond(
                covfn, Q, lvl.int_parent, chain_Q[m - 1], chain_GG[m - 1],
                jitter, group=pgrp, iota=iota_i, shard=shard_i)
        L = _chol(C_own, jitter)
        LinvT = _tri_inv(L).transpose(-1, -2)
        prior_L[m] = L
        eye_r = torch.eye(r, **fl).expand(batch + (n_int, r, r))
        if m == 0:
            chain_Q[m] = Q
            chain_GG[m] = torch.cat([LinvT, eye_r], dim=-1)
        else:
            S = m * r
            GGp = _parent_rows(chain_GG[m - 1], lvl.int_parent, pgrp, n_int,
                               pstart)
            GpT, GLTp = GGp[..., :S], GGp[..., S:]
            neg = -(GpT @ Zt.transpose(-1, -2))  # [(C,) n, S, r]
            zeros_bot = torch.zeros(batch + (n_int, r, S), **fl)
            chain_GG[m] = torch.cat([
                torch.cat([GpT, neg @ LinvT, GLTp, neg], dim=-1),
                torch.cat([zeros_bot, LinvT, zeros_bot, eye_r], dim=-1),
            ], dim=-2)
            chain_Q[m] = torch.cat([
                _parent_rows(chain_Q[m - 1], lvl.int_parent, pgrp, n_int,
                             pstart), Q,
            ], dim=-2)
        if lsp is not None:
            _tr.end(lsp)
    if sp is not None:
        # traced: the backward's boundary between passes B and A
        prior_L = list(_tr.mark("A", *prior_L))
        _tr.end(sp)

    # ---------------- Pass B: leaf groups — A, omega, own downdate ---------
    leaf_stash: list = [None] * (M + 1)
    # per parent level: (ATil, omgTil, parent rows, leaf origin, children
    # per parent); parent rows None = this rank's window of parents. Leaf
    # origin parts are partial sums over the ranks, summed in Pass C
    children: list = [[] for _ in range(M + 1)]
    # likelihood increments: "rep" computed whole on every rank, "sh" this
    # rank's part of a sum over the ranks (serially everything is "rep",
    # in the passes' order)
    leaf_key = "rep" if group is None else "sh"
    tot = {key: [torch.zeros(batch, **fl), torch.zeros(batch, **fl)]
           for key in {"rep", leaf_key}}

    def add(key, d, u):
        tot[key][0] = tot[key][0] + d
        tot[key][1] = tot[key][1] + u

    n_obs_total = torch.zeros((), **fl)

    sp = _tr.begin("pymra.pass.B") if _tr.ON else None
    for m, lvl in enumerate(levels):
        n_leaf = lvl.leaf_locs.shape[0]
        if n_leaf == 0:
            continue
        lsp = _tr.begin("pymra.pass.B.level", m) if _tr.ON else None
        P = lvl.leaf_locs.shape[1]
        S = m * r
        X = lvl.leaf_locs
        grp = 0
        shard = None
        leaf_iota = False
        if m and dplan.groups is not None:
            c_leaf, _, gn_leaf, _ = dplan.groups[m]
            if c_leaf and n_leaf == gn_leaf:
                grp = c_leaf
                if shard_idx is not None:
                    if m - 1 >= crit:
                        # sharded parents: this rank's leaf window sits
                        # exactly over its interior window
                        leaf_iota = True
                    else:
                        shard = (shard_idx, dplan.shard_groups)
        if m == 0:
            C_own = covfn(X, X)
            W = Wg = None
        else:
            # iota (the stash read directly) only where this rank sees the
            # whole leaf axis, or its aligned window of both axes
            _, C_own, W, Wg = _chain_cond(
                covfn, X, lvl.leaf_parent, chain_Q[m - 1], chain_GG[m - 1],
                jitter, want_W=True, group=grp,
                iota=(dplan.iota_groups and group is None) or leaf_iota,
                shard=shard)
        kmask_f = lvl.leaf_is_knot.to(dtype)
        # own-basis block: conditional covariance with own-knot columns only
        B_own = C_own * kmask_f[:, None, :]
        if dense is not None:
            # correlated measurement error: whiten y and the basis against
            # this leaf's own R block. R's factor and the whitened y are the
            # data's, shared by the sets of a batch; only the basis is
            # whitened per set
            dn = dense[m]
            L_R = _chol(dn["R_m"], jitter)
            Bstack = torch.cat([W, B_own], dim=-1) if S else B_own
            Bw = _shared_solve(L_R, Bstack * dn["o"][:, :, None], nd,
                               kernel_structure)
            yw = _tri_solve(L_R, dn["y0"][..., None],
                            kernel=kernel_structure)
            Bw_h, Bw_o = Bw[..., :S], Bw[..., S:]
            A_oo = Bw_o.transpose(-1, -2) @ Bw_o
            omg_o = (Bw_o.transpose(-1, -2) @ yw)[..., 0]
            if S:
                A_oh = Bw_o.transpose(-1, -2) @ Bw_h
                omg_h = (Bw_h.transpose(-1, -2) @ yw)[..., 0]
            lp = {"logdet_R": 2.0 * _logdiag_sum(L_R),
                  "quad_y": (yw * yw).sum((-2, -1)), "n_obs": dn["n_obs"]}
        else:
            lp = prep[m]
            w, wy = lp["w"], lp["wy"]
            Bw = B_own * w[:, :, None]
            A_oo = Bw.transpose(-1, -2) @ B_own
            omg_o = (B_own.transpose(-1, -2) @ wy[..., None])[..., 0]
            if S:
                A_oh = Bw.transpose(-1, -2) @ W

        use_inv = _use_inverse_solves(P, kernel_structure)
        # the JAX package's fused_ok: the leaf kernels that produce the
        # inverse factor without forming L_post run on the inverse route
        fused = (use_inv and kernel_structure and P <= LEAF_FUSED_MAX_P
                 and not keep_internals)
        L_prior = None
        if fused and dense is None:
            # one kernel: prior log-det, posterior inverse factor + log-det;
            # K_leaf and K_leaf + A_oo never exist in memory
            Li, ld_prior, ld_post, _, _ = leaf_factor(
                C_own.contiguous(), kmask_f.contiguous(), A_oo.contiguous(),
                jitter)
            L_post = None
        else:
            # prior weight precision on own knots, identity on masked slots
            pair = kmask_f[:, :, None] * kmask_f[:, None, :]
            eyeP = torch.eye(P, **fl)
            K_leaf = C_own * pair + (1.0 - kmask_f)[:, :, None] * eyeP
            if keep_internals:
                # the basis matrices read the leaf prior factor itself
                L_prior = _chol(K_leaf, jitter)
                ld_prior = _logdiag_sum(L_prior)
            else:
                ld_prior = _chol_logdiag(K_leaf, jitter)
            prior_scale = torch.diagonal(K_leaf, dim1=-2, dim2=-1).abs().mean(-1)
            if fused:
                # two kernels (dense R): posterior inverse factor and
                # log-det in one pass, the factor never formed
                K_post = K_leaf + A_oo
                jit_post = _jit_scale(K_post, jitter, prior_scale)
                Li, ld_post, _ = cholesky_inv_logdet(
                    K_post.contiguous(), jit_post.contiguous())
                L_post = None
            else:
                L_post = _chol(K_leaf + A_oo, jitter, scale=prior_scale)
                ld_post = _logdiag_sum(L_post)
                # the inverse route: the solves become matmuls with the
                # (blocked, above 64) inverse, as in the JAX package
                Li = triangular_inverse_lower(L_post) if use_inv else None

        def solve(B, trans=False):
            """``L^-1 B`` (or ``L^-T B``) for the leaf's posterior factor:
            matmuls when a kernel produced ``Li = L^-1``."""
            if Li is not None:
                return (Li.transpose(-1, -2) if trans else Li) @ B
            return _tri_solve(L_post, B, trans, kernel=kernel_structure)

        v = solve(omg_o[..., None])[..., 0]  # [n, P]

        # likelihood increments: log-Cholesky differences plus the R
        # log-determinant and the data quadratic form
        d_leaf = 2.0 * (ld_post - ld_prior) + lp["logdet_R"]
        u_leaf = lp["quad_y"] - (v * v).sum(-1)
        add(leaf_key, d_leaf.sum(-1), u_leaf.sum(-1))
        n_obs_total = n_obs_total + lp["n_obs"].sum()

        if S:
            Xblk = solve(A_oh)  # [n, P, S]
            if grp and dense is None:
                # aggregate the head messages straight at the parent: the
                # same contractions over c*P rows land [n/c, S, S] blocks
                # with no per-leaf A_hh in memory
                n_par = n_leaf // grp
                Xblkg = Xblk.reshape(batch + (n_par, grp * P, S))
                ATil = _message_downdate(Wg, w.reshape(n_par, grp * P), Xblkg)
                omgTil = (
                    (Wg.transpose(-1, -2)
                     @ wy.reshape(n_par, grp * P)[..., None])[..., 0]
                    - (Xblkg.transpose(-1, -2)
                       @ v.reshape(batch + (n_par, grp * P))[..., None])[
                           ..., 0])
                if shard is not None:
                    # the rows are this rank's window of parents
                    children[m].append((ATil, omgTil, None, True, 1))
                else:
                    # with sharded parents every child of a local parent
                    # is on this rank: the sums are complete
                    children[m].append((ATil, omgTil, lvl.leaf_parent[::grp],
                                        not leaf_iota, 1))
            else:
                if dense is None:
                    ATil = _message_downdate(W, w, Xblk)
                    omg_h = (W.transpose(-1, -2) @ wy[..., None])[..., 0]
                else:
                    ATil = _message_downdate(Bw_h, None, Xblk)
                omgTil = omg_h - (Xblk.transpose(-1, -2) @ v[..., None])[..., 0]
                children[m].append((ATil, omgTil, lvl.leaf_parent, True, grp))
            G = solve(Xblk, trans=True)  # [(C,) n, P, S]
        else:
            G = torch.zeros(batch + (n_leaf, P, 0), **fl)
        g = solve(v[..., None], trans=True)[..., 0]
        leaf_stash[m] = {"W": W, "B_own": B_own, "grp": grp,
                         "L_prior": L_prior, "L_post": L_post, "Li": Li,
                         "G": G, "g": g}
        if keep_internals:
            # prior basis blocks, with or without the posterior
            leaf_stash[m]["Bstack"] = (torch.cat([W, B_own], dim=-1) if S
                                       else B_own)
        if lsp is not None:
            _tr.end(lsp)
    if sp is not None:
        # the boundary between passes C and B: the likelihood increments
        # and what the posterior reads of the leaves
        _mark_with_stash("B", tot[leaf_key], leaf_stash)
        _tr.end(sp)

    # ---------------- Pass C: upward interior levels -----------------------
    int_stash: list = [None] * (M + 1)
    sp = _tr.begin("pymra.pass.C") if _tr.ON else None
    for m in range(M, -1, -1):
        lvl = levels[m]
        n_int = lvl.int_knots.shape[0]
        if n_int == 0:
            continue
        lsp = _tr.begin("pymra.pass.C.level", m) if _tr.ON else None
        S = m * r
        # children's messages per parent; leaf-origin parts are this rank's
        # partial sums, summed over the ranks in one collective
        msgs = {True: None, False: None}  # leaf origin -> (A, omega)
        for pa, po, pp, leaf_origin, grp in children[m + 1]:
            if pp is None:
                # this rank's window of parents: zeros elsewhere (and past
                # the last parent, where padding groups land)
                start = shard_idx * pa.shape[nd]

                def placed(t):
                    lead = t.new_zeros(batch + (start,) + t.shape[nd + 1:])
                    return _window(torch.cat([lead, t], dim=nd), 0, n_int,
                                   nd)

                pa_s, po_s = placed(pa), placed(po)
            elif grp and pa.shape[nd] == grp * n_int:
                pa_s = pa.reshape(batch + (n_int, grp) + pa.shape[nd + 1:]
                                  ).sum(nd + 1)
                po_s = po.reshape(batch + (n_int, grp) + po.shape[nd + 1:]
                                  ).sum(nd + 1)
            else:
                pa_s = pa.new_zeros(batch + (n_int,) + pa.shape[nd + 1:]
                                    ).index_add(nd, pp, pa)
                po_s = po.new_zeros(batch + (n_int,) + po.shape[nd + 1:]
                                    ).index_add(nd, pp, po)
            prev = msgs[leaf_origin]
            msgs[leaf_origin] = ((pa_s, po_s) if prev is None
                                 else (prev[0] + pa_s, prev[1] + po_s))
        if group is not None and msgs[True] is not None:
            msgs[True] = tuple(_all_reduce_packed(msgs[True], group,
                                                  "messages"))
        parts = [p for p in (msgs[True], msgs[False]) if p is not None]
        if not parts:
            parts = [(torch.zeros(batch + (n_int, S + r, S + r), **fl),
                      torch.zeros(batch + (n_int, S + r), **fl))]
        A, omg = parts[0]
        for pa_s, po_s in parts[1:]:
            A = A + pa_s
            omg = omg + po_s

        Kc = prior_L[m]
        Kmat = Kc @ Kc.transpose(-1, -2)
        prior_scale = torch.diagonal(Kmat, dim1=-2, dim2=-1).abs().mean(-1)
        L_post = _chol(Kmat + A[..., S:, S:], jitter, scale=prior_scale)
        v = _tri_solve(L_post, omg[..., S:, None])[..., 0]
        lvl_sharded = shard_idx is not None and m >= crit
        add("sh" if lvl_sharded else "rep",
            (2.0 * (_logdiag_sum(L_post) - _logdiag_sum(Kc))).sum(-1),
            -(v * v).sum((-2, -1)))

        if S:
            Xblk = _tri_solve(L_post, A[..., S:, :S])
            ATil = A[..., :S, :S] - Xblk.transpose(-1, -2) @ Xblk
            omgTil = omg[..., :S] - (Xblk.transpose(-1, -2)
                                     @ v[..., None])[..., 0]
            c_int = _int_group(dplan, m, n_int)
            if lvl_sharded and m == crit:
                # the transition to the replicated levels: sum the local
                # messages per parent (whole parent groups per rank) and
                # send one window message, summed over the ranks in Pass C
                n_par = n_int // c_int
                children[m].append((
                    ATil.reshape(batch + (n_par, c_int, S, S)).sum(nd + 1),
                    omgTil.reshape(batch + (n_par, c_int, S)).sum(nd + 1),
                    None, True, 1))
            else:
                children[m].append((ATil, omgTil, lvl.int_parent, False,
                                    c_int))
            G = _tri_solve(L_post, Xblk, trans=True)
        else:
            G = torch.zeros(batch + (n_int, r, 0), **fl)
        g = _tri_solve(L_post, v[..., None], trans=True)[..., 0]
        int_stash[m] = {"L_post": L_post, "G": G, "g": g}
        if lsp is not None:
            _tr.end(lsp)

    d_total, u_total = tot["rep"]
    if group is not None:
        d_sh, u_sh, n_obs_total = _all_reduce_packed(
            (tot["sh"][0], tot["sh"][1], n_obs_total), group, "totals")
        d_total = d_total + d_sh
        u_total = u_total + u_sh
    objective = d_total + u_total
    loglik = -0.5 * (objective + n_obs_total * LOG2PI)
    if sp is not None:
        # the boundary between passes D (or the caller) and C
        out = [objective, loglik]
        _mark_with_stash("C", out, int_stash)
        objective, loglik = out
        _tr.end(sp)
    mean = var = None
    if compute_posterior:
        sp = _tr.begin("pymra.pass.D") if _tr.ON else None
        mean, var = _posterior(dplan, leaf_stash, int_stash, kernel_structure,
                               keep_internals, group, shard_idx, crit,
                               posterior_segments, batch)
        if sp is not None:
            mean, var = _tr.mark("D", mean, var)
            _tr.end(sp)
    result = SweepResult(objective, loglik, mean, var)
    if keep_internals:
        # the knot chains are points, shared by the sets: broadcast (a
        # view), as jax.vmap broadcasts an unbatched output
        chain_Q = [q if q is None else q.expand(batch + q.shape)
                   for q in chain_Q]
        return result, {"prior_L": prior_L, "chain_Q": chain_Q,
                        "chain_GG": chain_GG, "leaf": leaf_stash,
                        "interior": int_stash}
    return result


def _mark_with_stash(label: str, values: list, stash: list) -> None:
    """A traced sweep's pass boundary (:func:`pymra_torch.utils.profiling.mark`)
    on ``values`` and the stashes' ``g``, which the posterior reads, through
    one marker; replaced in place."""
    rows = [st for st in stash if st is not None]
    marked = _tr.mark(label, *values, *(st["g"] for st in rows))
    values[:] = marked[:len(values)]
    for st, g in zip(rows, marked[len(values):]):
        st["g"] = g


def _posterior(dplan, leaf_stash, int_stash, kernel_structure,
               keep_internals, group=None, shard_idx=None, crit=10 ** 9,
               posterior_segments=False, batch=()):
    """Pass D: the posterior mean and variance at every location. With
    ``keep_internals`` each leaf replays its per-ancestor downdates and
    stashes the posterior basis blocks (``post_blocks``) instead of the
    chain contraction against ``U``. On a rank of a sharded sweep the
    chain rows follow Pass A's windows; with
    ``posterior_segments`` the rank's slot segments are returned, else its
    scattered moments are summed over the ranks. Under a batch ``(C,)``
    every stash and moment has the ``[C]`` axis in front of its nodes and
    the moments come out ``[C, N]`` (segments ``[C, slots]``)."""
    nd = len(batch)
    levels = dplan.levels
    M, N, r = dplan.M, dplan.n_locs, dplan.r
    fl = dict(dtype=dplan.dtype, device=dplan.device)

    # per-node chain matrices U = [V | w] by the recursions
    #   w(node) = [w_p, g - G w_p]
    #   V(node) = [[V_p, 0], [-G V_p, L_post^-T]]
    post_U: list = [None] * (M + 1)
    for m in range(M + 1):
        st = int_stash[m]
        if st is None or keep_internals:
            continue
        LinvT = _tri_inv(st["L_post"]).transpose(-1, -2)
        if m == 0:
            post_U[0] = torch.cat([LinvT, st["g"][..., None]], dim=-1)
            continue
        G = st["G"]  # [(C,) n, r, S]
        n_i = G.shape[-3]
        c_i = _int_group(dplan, m, n_i)
        Up = _parent_rows(post_U[m - 1], levels[m].int_parent, c_i, n_i,
                          _window_start(shard_idx, crit, m, n_i, c_i))
        GU = G @ Up  # [(C,) n, r, S+1]
        S = m * r
        top = torch.cat([Up[..., :S], torch.zeros(batch + (n_i, S, r), **fl),
                         Up[..., S:]], dim=-1)
        bot = torch.cat([-GU[..., :S], LinvT,
                         (st["g"] - GU[..., S])[..., None]], dim=-1)
        post_U[m] = torch.cat([top, bot], dim=-2)

    mean_parts: list = []
    var_parts: list = []
    for m, lvl in enumerate(levels):
        st = leaf_stash[m]
        if st is None:
            continue
        T_own = st["B_own"]  # [(C,) n, P, P]
        S = m * r
        if keep_internals:
            # posterior basis blocks (the reference's BTil): T's block k
            # just before step k's contribution
            st["post_blocks"] = {m: T_own}
        mean_l = (T_own @ st["g"][..., None])[..., 0]
        if st["Li"] is not None:
            half = st["Li"] @ T_own.transpose(-1, -2)
        else:
            half = _tri_solve(st["L_post"], T_own.transpose(-1, -2),
                              kernel=kernel_structure)
        var_l = (half * half).sum(-2)
        if S and keep_internals:
            # replay the per-ancestor downdates, stashing each block
            T = st["W"] - T_own @ st["G"]
            for j in range(m - 1, -1, -1):
                anc = lvl.leaf_path[:, j]
                stj = int_stash[j]
                blk = T[..., j * r:(j + 1) * r]
                st["post_blocks"][j] = blk
                mean_l = mean_l + (blk @ stj["g"][..., anc, :, None])[..., 0]
                halfj = _tri_solve(_rows(stj["L_post"], anc),
                                   blk.transpose(-1, -2))
                var_l = var_l + (halfj * halfj).sum(-2)
                if j:
                    T = T[..., :j * r] - blk @ _rows(stj["G"], anc)
        elif S:
            # one per-parent chain contraction against U = [V | w] gives the
            # ancestor levels' mean and variance contributions together
            h = st["W"] - T_own @ st["G"]
            grp = st["grp"]
            n_l, P_l = h.shape[-3], h.shape[-2]
            if grp:
                Upar = post_U[m - 1]
                if shard_idx is not None and m - 1 >= crit:
                    pass  # sharded parents: the rows are this rank's
                elif shard_idx is not None:
                    # the rank's window of the replicated chain (padding
                    # groups read zero rows; their h is 0)
                    psg = n_l // grp
                    Upar = _window(Upar, shard_idx * psg, psg)
                elif not (dplan.iota_groups and group is None):
                    Upar = _rows(Upar, lvl.leaf_parent[::grp])
                hU = h.reshape(batch + (n_l // grp, grp * P_l, S)) @ Upar
                mean_l = mean_l + hU[..., S].reshape(batch + (n_l, P_l))
                var_l = var_l + (hU[..., :S] * hU[..., :S]).sum(-1).reshape(
                    batch + (n_l, P_l))
            else:
                hU = h @ _rows(post_U[m - 1], lvl.leaf_parent)
                mean_l = mean_l + hU[..., S]
                var_l = var_l + (hU[..., :S] * hU[..., :S]).sum(-1)
        mean_parts.append((lvl, mean_l))
        var_parts.append((lvl, var_l))

    def slots(parts):
        """The leaf levels' moments in slot order: ``[(C,) slots]``."""
        return torch.cat([p.reshape(batch + (-1,)) for _, p in parts], dim=-1)

    if posterior_segments:
        return slots(mean_parts), slots(var_parts)
    if dplan.post_inv is not None and group is None:
        mean_out = slots(mean_parts)[..., dplan.post_inv]
        var_out = slots(var_parts)[..., dplan.post_inv]
    else:
        mean_out = torch.zeros(batch + (N + 1,), **fl)
        var_out = torch.zeros(batch + (N + 1,), **fl)
        for (lvl, ml), (_, vl) in zip(mean_parts, var_parts):
            gidx = lvl.leaf_loc_gidx.reshape(-1)
            zero = torch.zeros((), **fl)
            mean_out = mean_out.index_add(nd, gidx, torch.where(
                lvl.leaf_loc_mask, ml, zero).reshape(batch + (-1,)))
            var_out = var_out.index_add(nd, gidx, torch.where(
                lvl.leaf_loc_mask, vl, zero).reshape(batch + (-1,)))
        mean_out, var_out = mean_out[..., :N], var_out[..., :N]
        if group is not None:
            # each location's moments came from its owner rank only
            mean_out, var_out = _all_reduce_packed((mean_out, var_out), group,
                                                   "posterior")
    return mean_out, var_out
