"""Multi-resolution basis-matrix assembly (counterpart of
``pymra_tpu/tree/basis.py``).

The reference's ``MRATree.getBasisFunctionsMatrix``: the ``N x (sum_m r
J^m)`` matrix whose column blocks are the per-node prior basis ``B`` (or
posterior ``BTil``), optionally right-multiplied by a square root of the
node's weight (co)variance so that ``B @ B.T`` approximates the prior (or
posterior) covariance. The sweep's ``keep_internals`` stashes hold every
leaf's conditional cross-covariances (prior) and downdate-replay blocks
(posterior); they are moved to the host once and scattered into the dense
matrix with numpy.

As in the JAX package: rows are in global location order (``order='root'``)
or in leaf-traversal order (``order='leaves'``); ``times_kc`` uses the
inverse-transpose Cholesky square root ``L^-T`` (so ``(B L^-T)(B L^-T)^T =
B K^-1 B^T`` exactly) where the reference takes an eigh-based factor: the
reconstructed covariances are identical, single columns differ by an
orthogonal factor.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["basis_matrix"]


def _to_host(x):
    """The stash with every tensor as a numpy array (float64 as computed,
    float32 widened: the assembly runs in float64)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x


def basis_matrix(model, cov, y=None, R=1.0, distr: str = "prior",
                 group_by_resolution: bool = False, order: str = "root",
                 times_kc: bool = False):
    """Assemble the multi-resolution basis matrix.

    Args:
      model: :class:`pymra_torch.tree.model.MRAModel`.
      cov: covariance callable (a :class:`pymra_torch.kernels.Kernel`, or a
        :class:`pymra_torch.kernels.MatrixKernel` on an index-mode model).
      y, R: observations and noise (used by ``distr='posterior'``).
      distr: ``'prior'`` or ``'posterior'``.
      group_by_resolution: a list of per-resolution matrices instead of one
        horizontally stacked matrix.
      order: ``'root'`` (global location order) or ``'leaves'`` (rows in
        leaf-traversal order, reference ``getOrderFromLeaves``).
      times_kc: right-multiply each block by the node's weight-covariance
        square root.

    Returns:
      ``[N, n_basis]`` float64 numpy array, or a list of per-level arrays.
    """
    from pymra_torch.tree.sweep import mra_sweep

    batch = tuple(getattr(cov, "batch_shape", ()))
    if batch:
        raise NotImplementedError(
            f"basis_matrix: the covariance carries a batch {batch} of "
            "parameter sets; the basis matrix is assembled on the host for "
            "one set (as the JAX package's, which is not vmapped): pass one "
            "set's Kernel, or read the batched stashes of "
            "mra_sweep(..., keep_internals=True)")
    if distr not in ("prior", "posterior"):
        raise ValueError("distr must be 'prior' or 'posterior'")
    if order not in ("root", "leaves"):
        raise ValueError("order must be 'root' or 'leaves'")
    posterior = distr == "posterior"
    plan = model.plan
    n = plan.n_locs
    if y is None:
        y = np.zeros(n)
    _, internals = mra_sweep(
        model.dplan, cov, np.asarray(y, dtype=np.float64).ravel(), R,
        compute_posterior=True, jitter=model.jitter, keep_internals=True)
    internals = _to_host(internals)

    # ----- column layout: per level, per node ------------------------------
    col_offsets: list[dict] = []  # per level: node -> (start, width)
    level_cols: list[int] = []
    for g in plan.levels:
        offs = {}
        cur = 0
        for i in range(g.n_int):
            offs[("int", i)] = (cur, plan.r)
            cur += plan.r
        if g.n_leaf:
            widths = g.leaf_is_knot.sum(axis=1)
            for i in range(g.n_leaf):
                offs[("leaf", i)] = (cur, int(widths[i]))
                cur += int(widths[i])
        col_offsets.append(offs)
        level_cols.append(cur)

    mats = [np.zeros((n, c)) for c in level_cols]

    # ----- scatter the leaf stashes -----------------------------------------
    for m_leaf, g in enumerate(plan.levels):
        if g.n_leaf == 0:
            continue
        st = internals["leaf"][m_leaf]
        Bstack = st["Bstack"]  # [n_l, P, S+P]
        post_blocks = st["post_blocks"] if posterior else None
        S = m_leaf * plan.r
        for i in range(g.n_leaf):
            rows = g.leaf_loc_gidx[i][g.leaf_loc_mask[i]]
            nrows = len(rows)
            # ancestor blocks at levels 0..m_leaf-1
            for k in range(m_leaf):
                anc = int(g.leaf_path[i, k])
                start, width = col_offsets[k][("int", anc)]
                if posterior:
                    blk = post_blocks[k][i][:nrows]
                else:
                    blk = Bstack[i][:nrows, k * plan.r:(k + 1) * plan.r]
                if times_kc:
                    L = (internals["interior"][k]["L_post"] if posterior
                         else internals["prior_L"][k])[anc]
                    blk = blk @ np.linalg.inv(L).T
                mats[k][rows, start:start + width] += blk
            # own leaf block (columns = own knots only)
            start, width = col_offsets[m_leaf][("leaf", i)]
            kcols = np.flatnonzero(g.leaf_is_knot[i])
            own = post_blocks[m_leaf][i] if posterior else Bstack[i][:, S:]
            blk = own[:nrows][:, kcols]
            if times_kc:
                L = st["L_post"] if posterior else st["L_prior"]
                fac = np.linalg.inv(L[i]).T[np.ix_(kcols, kcols)]
                blk = blk @ fac
            mats[m_leaf][rows, start:start + width] = blk

    if order == "leaves":
        perm = _leaf_order(plan)
        mats = [mat[perm] for mat in mats]
    if group_by_resolution:
        return mats
    return np.hstack(mats)


def _leaf_order(plan) -> np.ndarray:
    """Row permutation by leaf traversal order (reference
    ``getOrderFromLeaves``)."""
    rows = []

    def visit(node):
        if node.is_leaf:
            rows.append(np.sort(node.loc_gidx))
        for ch in node.children:
            visit(ch)

    visit(plan.nodes[0][0])
    return np.concatenate(rows)
