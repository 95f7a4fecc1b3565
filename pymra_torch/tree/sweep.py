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
structure* the card runs — every jittered Cholesky through
:func:`pymra_torch.ops.linalg.cholesky_jittered`, leaves with
``16 <= P <= 64`` through :func:`pymra_torch.ops.linalg.leaf_factor`
(their solves become matmuls with the inverse factor), narrower leaves
through ``cholesky_jittered`` and triangular solves. Otherwise (float64,
or ``jitter == 0``) it takes the *plain structure* of the JAX package's CPU
path: ``torch.linalg`` factorizations and triangular solves, which run on
CPU tensors only. The ops wrappers choose the CUDA kernel or its plain twin
by the tensors' device, so a CPU run of the kernel structure executes the
exact sequence of operations the card does.

Not ported yet (they raise ``NotImplementedError``): dense ``r_dense``
measurement error, ``keep_internals``, sharding (``axis_name``) and
``posterior_segments``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from pymra_torch.ops.linalg import cholesky_jittered, leaf_factor
from pymra_torch.tree.plan import TreePlan

__all__ = ["DeviceLevel", "DevicePlan", "SweepResult", "make_device_plan",
           "mra_sweep", "prepare_obs", "LOG2PI", "set_matmul_precision"]

LOG2PI = float(np.log(2.0 * np.pi))

#: leaf widths that go through the fused leaf kernel in the kernel structure
LEAF_FUSED_MIN_P = 16
LEAF_FUSED_MAX_P = 64


def set_matmul_precision() -> None:
    """Full float32 in every matmul: no TF32 in cuBLAS or cuDNN.

    The N=10^4 bench tree's tiny measurement error (R = 1e-4) conditions
    its posterior blocks at ~1e4 and amplifies reduced-precision matmul
    residue through the log-determinants; on the JAX package's reference
    runs a 3-pass bf16 matmul put that objective 4e-2 off its golden value.
    TF32 keeps about three decimal digits, the same hazard.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class DeviceLevel:
    """Per-level tensors on the device (see ``plan.LevelGroup``)."""

    int_knots: torch.Tensor  # [n_int, r, d] knot coordinates
    int_path: torch.Tensor  # [n_int, level]
    int_parent: torch.Tensor  # [n_int]
    leaf_locs: torch.Tensor  # [n_leaf, P, d]
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
    by one gather; ``None`` falls back to scatter-adds.
    """

    levels: tuple[DeviceLevel, ...]
    n_locs: int
    r: int
    M: int
    groups: tuple | None = None
    post_inv: torch.Tensor | None = None
    iota_groups: bool = False

    @property
    def dtype(self) -> torch.dtype:
        lvl = self.levels[0]
        return (lvl.int_knots if lvl.int_knots.numel() else
                lvl.leaf_locs).dtype

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


def make_device_plan(plan: TreePlan, dtype=torch.float32,
                     device="cpu") -> DevicePlan:
    """Upload a host :class:`TreePlan` as static tensors on ``device``.

    Coordinates are pre-gathered per node; padded leaf slots point at the
    last location and are masked.
    """
    locs = np.asarray(plan.locs)
    n = len(locs)
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
                                  True, dtype=dtype, device=device)


def device_plan_from_numpy(levels, n_locs: int, r: int, M: int, groups,
                           post_inv, iota_groups: bool, dtype=torch.float32,
                           device="cpu") -> DevicePlan:
    """Build a :class:`DevicePlan` from numpy arrays: ``levels`` holds, per
    level, ``{field: array}`` keyed by the :class:`DeviceLevel` field names
    (e.g. ``{k: np.asarray(v) for k, v in jax_level._asdict().items()}``);
    the other arguments are the plan attributes of the same names
    (``post_inv`` as an array or None)."""
    dev = torch.device(device)

    # torch.tensor copies: arrays taken from JAX are read-only
    def idx(a):
        return torch.tensor(np.asarray(a), dtype=torch.long, device=dev)

    def flt(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def msk(a):
        return torch.tensor(np.asarray(a), dtype=torch.bool, device=dev)

    conv = {"int_knots": flt, "leaf_locs": flt, "leaf_loc_mask": msk,
            "leaf_is_knot": msk}
    lv = tuple(DeviceLevel(**{f.name: conv.get(f.name, idx)(lvl[f.name])
                              for f in dataclasses.fields(DeviceLevel)})
               for lvl in levels)
    return DevicePlan(
        lv, int(n_locs), int(r), int(M),
        groups=(tuple(tuple(int(v) for v in g) for g in groups)
                if groups is not None else None),
        post_inv=idx(post_inv) if post_inv is not None else None,
        iota_groups=bool(iota_groups))


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
            "(kernel structure); the plain Cholesky it would need here is "
            "K4 cholesky, not ported yet (ROADMAP queue 2)")


def _cholesky_nan(mat: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky`` that returns NaN for a failed member
    instead of raising (the JAX/XLA semantics the escalation relies on)."""
    _plain_only(mat)
    L, info = torch.linalg.cholesky_ex(mat)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _chol(mat: torch.Tensor, jitter: float,
          scale: torch.Tensor | None = None) -> torch.Tensor:
    """Cholesky factor of ``mat + f*jitter*(scale+1)*I``, ``scale`` the mean
    |diagonal| of ``mat`` unless given (posterior blocks pass their prior
    block's scale), ``f`` escalating 1, 1e2, 1e4 per member on failure."""
    if not jitter:
        return _cholesky_nan(mat)
    if scale is None:
        scale = torch.diagonal(mat, dim1=-2, dim2=-1).abs().mean(-1)
    jit_scale = jitter * (scale.detach() + 1.0)
    if _kernel_structure(mat.dtype, jitter):
        return cholesky_jittered(mat.contiguous(), jit_scale.contiguous())[0]
    # plain structure with jitter: the JAX package's unconditional cascade
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    jit_scale = jit_scale[..., None, None]
    c = _cholesky_nan(mat + jit_scale * eye)
    for factor in (1e2, 1e4):
        bad = ~torch.isfinite(c).all(-1).all(-1)[..., None, None]
        c = torch.where(bad, _cholesky_nan(mat + (factor * jit_scale) * eye),
                        c)
    return c


def _tri_solve(L: torch.Tensor, B: torch.Tensor, trans: bool = False
               ) -> torch.Tensor:
    """Solve ``L x = B`` (or ``L^T x = B``) for a batch of lower factors."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B,
                                             upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of small (r x r) lower triangles."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _logdiag_sum(chol: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def _message_downdate(W, w, X):
    """The leaf's message to its parent, ``W^T diag(w) W - X^T X``.

    The two Gram blocks carry the data weight ``1/R`` and nearly cancel
    when R is small: on the N=10^4 bench tree (R = 1e-4) a float32
    subtraction left the float32 objective 1.7e-3 off its float64 golden on
    an NVIDIA H100 (700 W), most of the 2e-3 budget; with both products and
    their difference taken in float64 and rounded once, 1.3e-4. The
    float64 GEMM is ~0.55 ms of a 25.6 ms N=10^6 evaluation on that card.
    """
    wide = torch.float64 if W.dtype == torch.float32 else W.dtype
    Wd, Xd = W.to(wide), X.to(wide)
    out = (Wd * w.to(wide)[..., None]).transpose(-1, -2) @ Wd
    return (out - Xd.transpose(-1, -2) @ Xd).to(W.dtype)


def _jitter_lift(C_raw, C_own, jitter):
    """Floor conditional variances relative to the prior variance (the
    low-precision downdate chain can push them slightly negative)."""
    d_raw = torch.diagonal(C_raw, dim1=-2, dim2=-1)
    d_own = torch.diagonal(C_own, dim1=-2, dim2=-1)
    lift = torch.clamp(jitter * d_raw - d_own, min=0.0)
    eye = torch.eye(C_own.shape[-1], dtype=C_own.dtype, device=C_own.device)
    return C_own + lift[..., :, None] * eye


def _chain_cond(covfn, X, parent, chain_Q, chain_GG, jitter,
                want_W: bool = False, group: int = 0, iota: bool = False):
    """Conditional pass against the joint ancestor-knot chain:

        [Zt | W] = Sigma(X, Q_all) [Ginv^T | GL^T]
        C_own    = Sigma(X, X) - Zt Zt^T

    ``Zt`` is the whitened cross-covariance, ``W`` the conditional ancestor
    basis. With ``group = c > 0`` the nodes sit c-per-parent contiguously:
    each parent stash row is read once and consumed by a reshaped batched
    matmul (with ``iota`` the parent rows are the stash itself).

    Returns ``(Zt [n, q, S], C_own [n, q, q], W | None, Wg | None)``; ``Wg``
    is the group-major ``[n/c, c q, S]`` view of ``W``.
    """
    n, q = X.shape[0], X.shape[1]
    S = chain_GG.shape[-2]
    W = Wg = None
    if group:
        Xg = X.reshape(n // group, group * q, X.shape[-1])
        if iota:
            Qg, GGg = chain_Q, chain_GG
        else:
            gpar = parent[::group]
            Qg, GGg = chain_Q[gpar], chain_GG[gpar]
        if not want_W:
            GGg = GGg[..., :S]
        ZW = covfn(Xg, Qg) @ GGg  # [n/c, c q, S or 2S]
        Zt = ZW[..., :S].reshape(n, q, S)
        if want_W:
            Wg = ZW[..., S:]
            W = Wg.reshape(n, q, S)
    else:
        Qp = chain_Q[parent]
        GGp = (chain_GG if want_W else chain_GG[..., :S])[parent]
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
) -> SweepResult:
    """Run the full MRA computation: likelihood and (optionally) posterior.

    Args:
      dplan: static device plan from :func:`make_device_plan`.
      covfn: batched covariance ``(x [..., p, d], y [..., q, d]) ->
        [..., p, q]``, typically a :class:`pymra_torch.kernels.Kernel`.
      y: ``[N]`` observations, NaN marking missing entries.
      r_diag: scalar or ``[N]`` measurement-error variance (diagonal R).
      compute_posterior: also run the downward pass for mean/var.
      jitter: scale-relative diagonal regularization before each Cholesky.
      prep: optional :func:`prepare_obs` output for this ``(y, r_diag)``;
        ``y``/``r_diag`` are then ignored.

    ``keep_internals``, ``axis_name``, ``r_dense`` and
    ``posterior_segments`` are not ported yet and raise.
    """
    if keep_internals:
        raise NotImplementedError(
            "keep_internals (basis-matrix stashes) is a sweep side path "
            "still to be ported (ROADMAP queue 1)")
    if axis_name is not None or posterior_segments:
        raise NotImplementedError(
            "sharded sweeps are still to be ported (ROADMAP queue 1, "
            "sharding)")
    if r_dense is not None:
        raise NotImplementedError(
            "dense measurement error (r_dense) is a sweep side path still "
            "to be ported (ROADMAP queue 1)")
    set_matmul_precision()
    if prep is None:
        prep = prepare_obs(dplan, y, r_diag)
    return _mra_sweep_impl(dplan, covfn, compute_posterior, float(jitter),
                           prep)


def _mra_sweep_impl(dplan, covfn, compute_posterior, jitter, prep):
    levels = dplan.levels
    M, N, r = dplan.M, dplan.n_locs, dplan.r
    dtype = dplan.dtype
    fl = dict(dtype=dtype, device=dplan.device)
    kernel_structure = _kernel_structure(dtype, jitter)

    def int_group(m: int, n_local: int) -> int:
        """Uniform children-per-parent of interior level ``m`` (0 = not
        grouped)."""
        if not m or dplan.groups is None:
            return 0
        ci = dplan.groups[m][1]
        return ci if (ci and n_local == dplan.groups[m][3]) else 0

    def parent_rows(stash, parent, c: int, n_local: int):
        """Per-node rows of a parent-level stash: a broadcast when the
        plan certifies iota grouping, else a gather."""
        if c and stash.shape[0] * c == n_local:
            return stash.repeat_interleave(c, dim=0)
        return stash[parent]

    # ---------------- Pass A: prior (downward), interior levels ------------
    # chain stashes: stacked ancestor knots (own last) and the fused chain
    # matrix GG = [Ginv^T | GL^T], built by the block recursions
    #   Ginv^T = [[GinvT_p, -GinvT_p Zt^T Linv^T], [0, Linv^T]]
    #   GL^T   = [[GLT_p,   -GinvT_p Zt^T       ], [0, I     ]]
    prior_L: list = [None] * (M + 1)
    chain_Q: list = [None] * (M + 1)
    chain_GG: list = [None] * (M + 1)
    for m, lvl in enumerate(levels):
        n_int = lvl.int_knots.shape[0]
        if n_int == 0:
            continue
        Q = lvl.int_knots
        grp_i = int_group(m, n_int)
        iota_i = bool(grp_i) and chain_GG[m - 1] is not None and (
            chain_GG[m - 1].shape[0] * grp_i == n_int)
        pgrp = grp_i if iota_i else 0
        if m == 0:
            C_own = covfn(Q, Q)
            Zt = None
        else:
            Zt, C_own, _, _ = _chain_cond(
                covfn, Q, lvl.int_parent, chain_Q[m - 1], chain_GG[m - 1],
                jitter, group=pgrp, iota=iota_i)
        L = _chol(C_own, jitter)
        LinvT = _tri_inv(L).transpose(-1, -2)
        prior_L[m] = L
        eye_r = torch.eye(r, **fl).expand(n_int, r, r)
        if m == 0:
            chain_Q[m] = Q
            chain_GG[m] = torch.cat([LinvT, eye_r], dim=-1)
        else:
            S = m * r
            GGp = parent_rows(chain_GG[m - 1], lvl.int_parent, pgrp, n_int)
            GpT, GLTp = GGp[..., :S], GGp[..., S:]
            neg = -(GpT @ Zt.transpose(-1, -2))  # [n, S, r]
            zeros_bot = torch.zeros(n_int, r, S, **fl)
            chain_GG[m] = torch.cat([
                torch.cat([GpT, neg @ LinvT, GLTp, neg], dim=-1),
                torch.cat([zeros_bot, LinvT, zeros_bot, eye_r], dim=-1),
            ], dim=-2)
            chain_Q[m] = torch.cat([
                parent_rows(chain_Q[m - 1], lvl.int_parent, pgrp, n_int), Q,
            ], dim=-2)

    # ---------------- Pass B: leaf groups — A, omega, own downdate ---------
    leaf_stash: list = [None] * (M + 1)
    # per parent level: (ATil, omgTil, parent rows, children per parent)
    children: list = [[] for _ in range(M + 1)]
    d_total = torch.zeros((), **fl)
    u_total = torch.zeros((), **fl)
    n_obs_total = torch.zeros((), **fl)

    for m, lvl in enumerate(levels):
        n_leaf = lvl.leaf_locs.shape[0]
        if n_leaf == 0:
            continue
        P = lvl.leaf_locs.shape[1]
        S = m * r
        X = lvl.leaf_locs
        grp = 0
        if m and dplan.groups is not None:
            c_leaf, _, gn_leaf, _ = dplan.groups[m]
            if c_leaf and n_leaf == gn_leaf:
                grp = c_leaf
        if m == 0:
            C_own = covfn(X, X)
            W = Wg = None
        else:
            _, C_own, W, Wg = _chain_cond(
                covfn, X, lvl.leaf_parent, chain_Q[m - 1], chain_GG[m - 1],
                jitter, want_W=True, group=grp, iota=dplan.iota_groups)
        kmask_f = lvl.leaf_is_knot.to(dtype)
        # own-basis block: conditional covariance with own-knot columns only
        B_own = C_own * kmask_f[:, None, :]
        lp = prep[m]
        w, wy = lp["w"], lp["wy"]
        Bw = B_own * w[:, :, None]
        A_oo = Bw.transpose(-1, -2) @ B_own
        omg_o = (B_own.transpose(-1, -2) @ wy[..., None])[..., 0]
        if S:
            A_oh = Bw.transpose(-1, -2) @ W

        if kernel_structure and LEAF_FUSED_MIN_P <= P <= LEAF_FUSED_MAX_P:
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
            ld_prior = _logdiag_sum(_chol(K_leaf, jitter))
            prior_scale = torch.diagonal(K_leaf, dim1=-2, dim2=-1).abs().mean(-1)
            L_post = _chol(K_leaf + A_oo, jitter, scale=prior_scale)
            ld_post = _logdiag_sum(L_post)
            Li = None
        def solve(B, trans=False):
            """``L^-1 B`` (or ``L^-T B``) for the leaf's posterior factor:
            matmuls when the leaf kernel produced ``Li = L^-1``."""
            if Li is not None:
                return (Li.transpose(-1, -2) if trans else Li) @ B
            return _tri_solve(L_post, B, trans)

        v = solve(omg_o[..., None])[..., 0]  # [n, P]

        # likelihood increments: log-Cholesky differences plus the R
        # log-determinant and the data quadratic form
        d_leaf = 2.0 * (ld_post - ld_prior) + lp["logdet_R"]
        u_leaf = lp["quad_y"] - (v * v).sum(-1)
        d_total = d_total + d_leaf.sum()
        u_total = u_total + u_leaf.sum()
        n_obs_total = n_obs_total + lp["n_obs"].sum()

        if S:
            Xblk = solve(A_oh)  # [n, P, S]
            if grp:
                # aggregate the head messages straight at the parent: the
                # same contractions over c*P rows land [n/c, S, S] blocks
                # with no per-leaf A_hh in memory
                n_par = n_leaf // grp
                Xblkg = Xblk.reshape(n_par, grp * P, S)
                ATil = _message_downdate(Wg, w.reshape(n_par, grp * P), Xblkg)
                omgTil = (
                    (Wg.transpose(-1, -2)
                     @ wy.reshape(n_par, grp * P)[..., None])[..., 0]
                    - (Xblkg.transpose(-1, -2)
                       @ v.reshape(n_par, grp * P)[..., None])[..., 0])
                children[m].append((ATil, omgTil, lvl.leaf_parent[::grp], 1))
            else:
                ATil = _message_downdate(W, w, Xblk)
                omg_h = (W.transpose(-1, -2) @ wy[..., None])[..., 0]
                omgTil = omg_h - (Xblk.transpose(-1, -2) @ v[..., None])[..., 0]
                children[m].append((ATil, omgTil, lvl.leaf_parent, 0))
            G = solve(Xblk, trans=True)  # [n, P, S]
        else:
            G = torch.zeros(n_leaf, P, 0, **fl)
        g = solve(v[..., None], trans=True)[..., 0]
        leaf_stash[m] = {"W": W, "B_own": B_own, "grp": grp,
                         "L_post": L_post, "Li": Li, "G": G, "g": g}

    # ---------------- Pass C: upward interior levels -----------------------
    int_stash: list = [None] * (M + 1)
    for m in range(M, -1, -1):
        lvl = levels[m]
        n_int = lvl.int_knots.shape[0]
        if n_int == 0:
            continue
        S = m * r
        A = torch.zeros(n_int, S + r, S + r, **fl)
        omg = torch.zeros(n_int, S + r, **fl)
        for pa, po, pp, grp in children[m + 1]:
            if grp and pa.shape[0] == grp * n_int:
                A = A + pa.reshape(n_int, grp, *pa.shape[1:]).sum(1)
                omg = omg + po.reshape(n_int, grp, *po.shape[1:]).sum(1)
            else:
                A = A.index_add(0, pp, pa)
                omg = omg.index_add(0, pp, po)

        Kc = prior_L[m]
        Kmat = Kc @ Kc.transpose(-1, -2)
        prior_scale = torch.diagonal(Kmat, dim1=-2, dim2=-1).abs().mean(-1)
        L_post = _chol(Kmat + A[:, S:, S:], jitter, scale=prior_scale)
        v = _tri_solve(L_post, omg[:, S:, None])[..., 0]
        d_total = d_total + (2.0 * (_logdiag_sum(L_post)
                                    - _logdiag_sum(Kc))).sum()
        u_total = u_total - (v * v).sum()

        if S:
            Xblk = _tri_solve(L_post, A[:, S:, :S])
            ATil = A[:, :S, :S] - Xblk.transpose(-1, -2) @ Xblk
            omgTil = omg[:, :S] - (Xblk.transpose(-1, -2) @ v[..., None])[..., 0]
            children[m].append((ATil, omgTil, lvl.int_parent,
                                int_group(m, n_int)))
            G = _tri_solve(L_post, Xblk, trans=True)
        else:
            G = torch.zeros(n_int, r, 0, **fl)
        g = _tri_solve(L_post, v[..., None], trans=True)[..., 0]
        int_stash[m] = {"L_post": L_post, "G": G, "g": g}

    objective = d_total + u_total
    loglik = -0.5 * (objective + n_obs_total * LOG2PI)
    if not compute_posterior:
        return SweepResult(objective, loglik, None, None)

    # ---------------- Pass D: posterior ------------------------------------
    # per-node chain matrices U = [V | w] by the recursions
    #   w(node) = [w_p, g - G w_p]
    #   V(node) = [[V_p, 0], [-G V_p, L_post^-T]]
    post_U: list = [None] * (M + 1)
    for m in range(M + 1):
        st = int_stash[m]
        if st is None:
            continue
        LinvT = _tri_inv(st["L_post"]).transpose(-1, -2)
        if m == 0:
            post_U[0] = torch.cat([LinvT, st["g"][..., None]], dim=-1)
            continue
        G = st["G"]  # [n, r, S]
        n_i = G.shape[0]
        Up = parent_rows(post_U[m - 1], levels[m].int_parent,
                         int_group(m, n_i), n_i)  # [n, S, S+1]
        GU = G @ Up  # [n, r, S+1]
        S = m * r
        top = torch.cat([Up[..., :S], torch.zeros(n_i, S, r, **fl),
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
        T_own = st["B_own"]  # [n, P, P]
        S = m * r
        mean_l = (T_own @ st["g"][..., None])[..., 0]
        if st["Li"] is not None:
            half = st["Li"] @ T_own.transpose(-1, -2)
        else:
            half = _tri_solve(st["L_post"], T_own.transpose(-1, -2))
        var_l = (half * half).sum(-2)
        if S:
            # one per-parent chain contraction against U = [V | w] gives the
            # ancestor levels' mean and variance contributions together
            h = st["W"] - T_own @ st["G"]
            grp = st["grp"]
            n_l, P_l = h.shape[0], h.shape[1]
            if grp:
                Upar = post_U[m - 1]
                if not dplan.iota_groups:
                    Upar = Upar[lvl.leaf_parent[::grp]]
                hU = h.reshape(n_l // grp, grp * P_l, S) @ Upar
                mean_l = mean_l + hU[..., S].reshape(n_l, P_l)
                var_l = var_l + (hU[..., :S] * hU[..., :S]).sum(-1).reshape(
                    n_l, P_l)
            else:
                hU = h @ post_U[m - 1][lvl.leaf_parent]
                mean_l = mean_l + hU[..., S]
                var_l = var_l + (hU[..., :S] * hU[..., :S]).sum(-1)
        mean_parts.append((lvl, mean_l))
        var_parts.append((lvl, var_l))

    if dplan.post_inv is not None:
        mean_out = torch.cat([p.reshape(-1) for _, p in mean_parts])[
            dplan.post_inv]
        var_out = torch.cat([p.reshape(-1) for _, p in var_parts])[
            dplan.post_inv]
    else:
        mean_out = torch.zeros(N + 1, **fl)
        var_out = torch.zeros(N + 1, **fl)
        for (lvl, ml), (_, vl) in zip(mean_parts, var_parts):
            gidx = lvl.leaf_loc_gidx.reshape(-1)
            zero = torch.zeros((), **fl)
            mean_out = mean_out.index_add(
                0, gidx, torch.where(lvl.leaf_loc_mask, ml, zero).reshape(-1))
            var_out = var_out.index_add(
                0, gidx, torch.where(lvl.leaf_loc_mask, vl, zero).reshape(-1))
        mean_out, var_out = mean_out[:N], var_out[:N]
    return SweepResult(objective, loglik, mean_out, var_out)
