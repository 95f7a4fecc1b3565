"""Sharded (multi-rank) MRA execution (counterpart of
``pymra_tpu/parallel/sharded.py``).

Splits the *leaf axis* of the device plan over the ranks of a mesh axis:
each rank runs the heavy leaf-level work (covariance evaluation, A/omega
assembly, leaf factorizations, posterior moments) on its window of
subtrees, and, where the tree allows, the fine interior levels too (the
reference's ``critDepth``, ``DevicePlan.int_shard_from``). The coarse
levels run replicated on every rank after one ``all_reduce`` of the
messages they receive from sharded children
(:func:`pymra_torch.tree.sweep.mra_sweep` with ``axis_name=`` the data
group).

The JAX package expresses this with ``shard_map`` over a padded plan whose
leaf arrays are sharded; here each rank holds its slice of the padded plan
(:func:`local_plan`) and calls the sweep on it: the same program, one
process per shard. The reference's fork gives serial != parallel (its
forks draw unseeded random knots, SURVEY quirk #5); here sharded results
equal the serial sweep's up to the order of the cross-rank sums.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from pymra_torch.parallel.mesh import Mesh
from pymra_torch.tree import sweep as _sweep
from pymra_torch.tree.sweep import DevicePlan, mra_sweep, prepare_obs

__all__ = ["int_shard_level", "pad_plan_for_sharding", "local_plan",
           "sharded_sweep", "sharded_loglik_fn", "mean_grad"]

_INT_FIELDS = ("int_knots", "int_path", "int_parent")
_LEAF_FIELDS = ("leaf_locs", "leaf_loc_gidx", "leaf_loc_mask", "leaf_is_knot",
                "leaf_path", "leaf_parent")


def int_shard_level(dplan: DevicePlan, n_shards: int) -> int:
    """The critical depth :func:`pad_plan_for_sharding` assigns: the first
    interior level whose nodes split over ``n_shards`` ranks (levels at or
    below it are sharded; levels above stay replicated), or a huge
    sentinel when the tree's shape admits no interior sharding (see
    :func:`pad_plan_for_sharding` for the conditions). Host metadata only.
    """
    if not (dplan.iota_groups and dplan.groups is not None):
        return 10 ** 9
    n_int_by_level = [lvl.int_knots.shape[0] for lvl in dplan.levels]
    int_levels = [m for m, n in enumerate(n_int_by_level) if n > 0]
    if not int_levels:
        return 10 ** 9
    deepest = int_levels[-1]
    # leaf level m constrains sharding of its parent level m-1: it must
    # itself be shardable without padding and group-aligned
    leaf_floor = -1
    for m, lvl in enumerate(dplan.levels):
        n_leaf = lvl.leaf_locs.shape[0]
        if not n_leaf or m == 0:
            continue
        c_leaf = dplan.groups[m][0]
        ok = (c_leaf > 0 and n_leaf % n_shards == 0
              and (n_leaf // n_shards) % c_leaf == 0
              and n_leaf == c_leaf * n_int_by_level[m - 1])
        if not ok:
            leaf_floor = max(leaf_floor, m - 1)
    crit = 10 ** 9
    m = deepest
    while m >= 1:
        n_i = n_int_by_level[m]
        c_i = dplan.groups[m][1]
        uniform = c_i > 0 and n_i == c_i * n_int_by_level[m - 1]
        if (n_i % n_shards == 0 and uniform and m > leaf_floor
                and (n_i // n_shards) % c_i == 0):
            crit = m
            m -= 1
        else:
            break
    return crit


def _pad_axis0(t: torch.Tensor, target: int, fill) -> torch.Tensor:
    n = t.shape[0]
    if n == target:
        return t
    return torch.cat([t, t.new_full((target - n,) + tuple(t.shape[1:]),
                                    fill)])


def pad_plan_for_sharding(dplan: DevicePlan, n_shards: int) -> DevicePlan:
    """Pad every leaf level's node axis to a multiple of ``n_shards`` (times
    its children-per-parent count when grouped) with inert dummy leaves:
    no locations, no knots, no observations, parent 0.

    The returned plan still holds every rank's rows; :func:`local_plan`
    cuts one rank's slice. Its metadata, equal to the JAX package's
    ``pad_plan_for_sharding`` on the same plan:

      * ``groups``: each grouped leaf level's count is the per-rank count
        (the sweep sees one rank's window), and, at sharded interior
        levels, the interior count too;
      * ``shard_groups = n_shards`` for an iota-grouped source plan: a
        rank's grouped parent rows are a contiguous window of the
        replicated stashes (``DevicePlan.shard_groups``);
      * ``post_inv [N]``: each location's slot in the rank-major
        concatenation of every rank's slot segments (the JAX code builds
        this replicated ``[N]`` map; its docstring's ``[n_shards, N]`` is
        stale);
      * ``int_shard_from`` (:func:`int_shard_level`): interior level ``m``
        and every level below it are sharded iff, from the deepest
        interior level up, ``n_int(m)`` divides by ``n_shards`` (interior
        levels are never padded), every deeper interior level is uniformly
        iota-grouped under its parent level, the per-rank window at the
        transition level covers whole parent groups, and every leaf level
        below a sharded interior level is uniformly grouped, divisible
        without padding and window-aligned. Otherwise it keeps its huge
        default and only the leaves are sharded.
    """
    levels = []
    groups = []
    for m, lvl in enumerate(dplan.levels):
        n_leaf = lvl.leaf_locs.shape[0]
        c_leaf, c_int, _, gn_int = (
            dplan.groups[m] if dplan.groups is not None else (0, 0, 0, 0))
        align = n_shards * c_leaf if c_leaf else n_shards
        target = ((n_leaf + align - 1) // align) * align
        groups.append((c_leaf, c_int, target // n_shards, gn_int))
        if n_leaf == target:
            levels.append(lvl)
            continue
        levels.append(dataclasses.replace(
            lvl,
            leaf_locs=_pad_axis0(lvl.leaf_locs, target, 0),
            leaf_loc_gidx=_pad_axis0(lvl.leaf_loc_gidx, target, dplan.n_locs),
            leaf_loc_mask=_pad_axis0(lvl.leaf_loc_mask, target, False),
            leaf_is_knot=_pad_axis0(lvl.leaf_is_knot, target, False),
            leaf_path=_pad_axis0(lvl.leaf_path, target, 0),
            leaf_parent=_pad_axis0(lvl.leaf_parent, target, 0),
        ))
    int_shard_from = int_shard_level(dplan, n_shards)

    post_inv = None
    shard_groups = 0
    if dplan.iota_groups:
        shard_groups = n_shards
        n = dplan.n_locs
        # a rank's slot segment: the concatenation over leaf levels of its
        # [target / n_shards, P] rows, flattened row-major; a location's
        # slot in the rank-major concatenation of the segments is
        # owner * slots_per_shard + its slot in the owner's segment
        slots_per_shard = sum(
            (lvl.leaf_loc_gidx.shape[0] // n_shards)
            * lvl.leaf_loc_gidx.shape[1]
            for lvl in levels if lvl.leaf_loc_gidx.shape[0])
        pinv = np.zeros(n, dtype=np.int64)
        offset = 0
        for lvl in levels:
            if not lvl.leaf_loc_gidx.shape[0]:
                continue
            gidx = lvl.leaf_loc_gidx.cpu().numpy()
            ps, P = gidx.shape[0] // n_shards, gidx.shape[1]
            rows = np.arange(gidx.shape[0], dtype=np.int64)[:, None]
            cols = np.arange(P, dtype=np.int64)[None, :]
            owner = rows // ps
            slot = np.broadcast_to(
                owner * slots_per_shard + offset + (rows - owner * ps) * P
                + cols, gidx.shape)
            valid = gidx < n
            pinv[gidx[valid]] = slot[valid]
            offset += ps * P
        post_inv = torch.as_tensor(pinv, device=dplan.device)
    if int_shard_from <= dplan.M:
        # the per-rank interior counts the sweep sees at sharded levels
        groups = [(c_leaf, c_int, psg_leaf,
                   gn_int // n_shards if m >= int_shard_from else gn_int)
                  for m, (c_leaf, c_int, psg_leaf, gn_int)
                  in enumerate(groups)]
    return DevicePlan(
        tuple(levels), dplan.n_locs, dplan.r, dplan.M,
        groups=tuple(groups) if dplan.groups is not None else None,
        post_inv=post_inv, iota_groups=False,
        index_points=dplan.index_points, dtype=dplan.dtype,
        shard_groups=shard_groups, int_shard_from=int_shard_from)


def local_plan(dplan_p: DevicePlan, index: int, n_shards: int) -> DevicePlan:
    """Rank ``index``'s slice of a plan padded for ``n_shards`` ranks (the
    port's counterpart of the JAX package's ``_plan_specs``): its window of
    every leaf level and of every interior level from ``int_shard_from``
    on; the coarser interior levels and ``post_inv`` whole."""
    levels = []
    for m, lvl in enumerate(dplan_p.levels):
        cut = {}
        n_leaf = lvl.leaf_locs.shape[0]
        if n_leaf:
            ps = n_leaf // n_shards
            cut.update({f: getattr(lvl, f)[index * ps:(index + 1) * ps]
                        for f in _LEAF_FIELDS})
        if m >= dplan_p.int_shard_from:
            pi = lvl.int_knots.shape[0] // n_shards
            cut.update({f: getattr(lvl, f)[index * pi:(index + 1) * pi]
                        for f in _INT_FIELDS})
        levels.append(dataclasses.replace(lvl, **cut))
    return dataclasses.replace(dplan_p, levels=tuple(levels))


def _local_prep(prep, index: int, n_shards: int):
    """Rank ``index``'s slice of :func:`prepare_obs` tensors of a padded
    plan."""
    out = []
    for lp in prep:
        if lp is None:
            out.append(None)
            continue
        ps = lp["w"].shape[0] // n_shards
        out.append({k: v[index * ps:(index + 1) * ps] for k, v in lp.items()})
    return tuple(out)


def _group(mesh: Mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def sharded_sweep(
    dplan: DevicePlan,
    covfn: Callable,
    y,
    r_diag,
    mesh: Mesh,
    axis: str = "data",
    compute_posterior: bool = True,
    jitter: float = 0.0,
    prep: tuple | None = None,
):
    """The MRA sweep with the leaves split over ``mesh`` axis ``axis``;
    every rank of the axis calls it and receives the whole result.

    Equal to :func:`pymra_torch.tree.sweep.mra_sweep` on the unpadded plan
    up to the order of the cross-rank sums. ``dplan`` is the whole plan,
    padded for this axis's size or not (an unpadded one is padded here).
    ``prep``: optional :func:`prepare_obs` tensors of the PADDED plan
    (``prepare_obs(pad_plan_for_sharding(dplan, n), y, r_diag)``); each
    rank takes its slice. Hoist it out of an MLE/HMC loop, or use
    :func:`sharded_loglik_fn`.

    The posterior comes back in location order on every rank: each rank's
    slot segments are placed in a zero buffer, summed over the ranks
    (exact: every slot has one owner, and ``x + 0 = x``) and gathered
    through ``post_inv``. A covariance with a ``[C]`` batch of parameter
    sets gives ``[C]`` objectives and ``[C, N]`` moments, every set in the
    same collectives.
    """
    group, index, n = _group(mesh, axis)
    dplan_p = (dplan if dplan.shard_groups == n
               else pad_plan_for_sharding(dplan, n))
    local = local_plan(dplan_p, index, n)
    if prep is not None:
        prep = _local_prep(prep, index, n)
    segments = compute_posterior and local.post_inv is not None
    res = mra_sweep(local, covfn, y, r_diag,
                    compute_posterior=compute_posterior, jitter=jitter,
                    prep=prep, axis_name=group, posterior_segments=segments)
    if segments:
        # [(C,) slots] per rank; the sets of a batch ride along
        slots = res.mean.shape[-1]
        buf = res.mean.new_zeros((2,) + res.mean.shape[:-1] + (n * slots,))
        buf[..., index * slots:(index + 1) * slots] = torch.stack(
            [res.mean, res.var])
        buf = _sweep._all_reduce(buf, group, "posterior")
        res = res._replace(mean=buf[0][..., local.post_inv],
                           var=buf[1][..., local.post_inv])
    return res


class _MeanGrad(torch.autograd.Function):
    """Identity forward; the backward averages the cotangent over the
    ranks of ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def mean_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, with its gradient averaged over the ranks of ``group``.

    A loglik replicated over the ranks of a sharded sweep differentiates,
    on each rank, to ``n`` times its own sharded part (the backward of the
    sweep's ``all_reduce`` sums the ``n`` ranks' cotangents) plus the
    replicated part; the mean over the ranks is the serial gradient. The
    JAX package gets this from ``shard_map``'s transpose."""
    return _MeanGrad.apply(x, group)


def sharded_loglik_fn(dplan: DevicePlan, y, r_diag, mesh: Mesh,
                      axis: str = "data", jitter: float = 0.0,
                      kernel_builder: Callable | None = None,
                      batched: bool = False) -> Callable:
    """``theta -> loglik`` with leaf-sharded evaluation, for gradient-based
    inference on domains too large for one card; every rank of the axis
    calls it with the same ``theta`` and gets the same loglik and, after
    ``backward``, the serial gradient (no reduction is left to the caller).

    ``theta`` follows :meth:`pymra_torch.tree.model.MRAModel.loglik_fn`: a
    dict of tensors mapped to a covariance by ``kernel_builder``, or, with
    no builder, a :class:`pymra_torch.kernels.Kernel` whose parameter
    buffers receive the gradient. The padded plan, this rank's slice and
    its observation tensors are prepared once, here.

    ``batched``: ``theta`` holds ``C`` parameter sets (leaves or Kernel
    parameters with a leading ``[C]`` axis) and the function returns
    ``[C]``, all sets through one sharded sweep, as ``MRAModel.loglik_fn``
    takes it: on a chain x data mesh a rank of the chain axis runs its
    chains in lockstep (``nuts(..., batched=True)`` with the generators of
    :func:`pymra_torch.parallel.chains.shard_generators`), the port's form
    of the JAX package's ``vmap`` over chains inside ``shard_map`` over the
    data. Every rank of the data axis must call it with the same number of
    sets.
    """
    from pymra_torch.kernels import Kernel

    group, index, n = _group(mesh, axis)
    dplan_p = pad_plan_for_sharding(dplan, n)
    local = local_plan(dplan_p, index, n)
    prep = prepare_obs(local, y, r_diag)
    device = local.device

    def fn(theta):
        if isinstance(theta, dict):
            if kernel_builder is None:
                raise TypeError("a dict theta needs a kernel_builder")
            theta = {k: mean_grad(v.to(device), group)
                     if torch.is_tensor(v) else v for k, v in theta.items()}
            cov = kernel_builder(theta)
        elif isinstance(theta, Kernel) and kernel_builder is None:
            cov = theta.replace(**{k: mean_grad(v.to(device), group)
                                   for k, v in theta.params.items()})
        else:
            raise TypeError(
                "theta: a dict of tensors with a kernel_builder, or a Kernel "
                f"without one; got {type(theta).__name__}")
        if batched and not getattr(cov, "batch_shape", ()):
            raise NotImplementedError(
                f"a batched sharded_loglik_fn needs a covariance with a [C] "
                f"batch of hyper-parameters; {type(cov).__name__} has none "
                "(a MatrixKernel has no hyper-parameter to batch)")
        out = mra_sweep(local, cov, None, None, compute_posterior=False,
                        jitter=jitter, prep=prep, axis_name=group).loglik
        if not batched and out.dim():
            raise ValueError(
                f"sharded_loglik_fn: the covariance carries a batch "
                f"{tuple(out.shape)} of parameter sets; pass batched=True")
        return out

    return fn
