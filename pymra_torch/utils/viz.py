"""Drawing the tree and its basis functions (counterpart of
``pymra_tpu/utils/viz.py``).

Equivalents of the reference plotting toolbox (``dispMat``, ``filterNNZ``,
``get_layout``) and of ``MRATree``'s drawing methods (``drawKnots``,
``drawBMatrix``, ``drawSparsityPat``, ``drawBasisFunctions``,
``drawGridAndObs``). Every function takes an optional ``fname`` and
``show`` and returns the figure, so it works headless: without a display
matplotlib draws with its Agg backend. matplotlib is imported when a
function draws, not with this module.
"""
from __future__ import annotations

import os
import sys

import numpy as np

__all__ = [
    "disp_mat",
    "filter_nnz",
    "get_layout",
    "draw_knots",
    "draw_b_matrix",
    "draw_sparsity_pattern",
    "draw_basis_functions",
    "draw_grid_and_obs",
]

_COLORS = ["#a6cee3", "#b2df8a", "#fb9a99", "#ff7f00", "#6a3d9a", "#b15928"]


def _plt():
    """``matplotlib.pyplot``, on the Agg backend where there is no display
    (no ``DISPLAY`` or ``WAYLAND_DISPLAY`` on Linux)."""
    import matplotlib

    headless = sys.platform.startswith("linux") and not (
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))
    if headless and "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, fname=None, show=False):
    if fname:
        fig.savefig(fname, dpi=200, bbox_inches="tight")
    if show:
        _plt().show()
    return fig


def filter_nnz(x, tol: float = 0.0):
    """0/1 pattern of entries with |x| > tol (reference ``filterNNZ``)."""
    x = np.asarray(x)
    out = np.zeros_like(x, dtype=float)
    out[np.abs(x) > tol] = 1.0
    return out


def get_layout(m: int, J: int, r: int):
    """Subplot grid for ``r * J^m`` basis functions (reference
    ``get_layout``)."""
    total = r * (J**m)
    table = [
        (2, (1, 2)), (3, (1, 3)), (4, (1, 4)), (6, (2, 3)), (8, (2, 4)),
        (9, (3, 3)), (12, (3, 4)), (15, (3, 5)), (16, (4, 4)), (18, (3, 6)),
        (20, (4, 5)), (24, (4, 6)), (25, (5, 5)), (28, (4, 7)), (30, (5, 6)),
        (35, (5, 7)), (36, (6, 6)),
    ]
    for bound, tup in table:
        if total <= bound:
            return tup
    raise ValueError("Too many functions to plot")


def disp_mat(mat, title="", cmap=None, fname=None, vmin=None, vmax=None,
             colorbar=True, pattern=False, show=False):
    """Matrix heatmap (reference ``dispMat``)."""
    plt = _plt()
    mat = np.asarray(mat)
    if pattern:
        mat = filter_nnz(mat)
    fig, ax = plt.subplots()
    im = ax.matshow(mat, cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_xticks([])
    ax.set_yticks([])
    if colorbar:
        fig.colorbar(im)
    if title:
        ax.set_title(title)
    return _finish(fig, fname, show)


def draw_knots(model, fname=None, show=False):
    """Per-resolution knot/grid maps (reference ``drawKnots``)."""
    plt = _plt()
    plan = model.plan
    d = plan.dim
    M = plan.M
    fig = plt.figure(figsize=(8, 2.2 * (M + 1)))
    for m in range(M + 1):
        nodes = plan.nodes[m]
        if d == 2:
            ax = fig.add_subplot(M // 2 + 1, 2, m + 1)
        else:
            ax = fig.add_subplot(M + 1, 1, m + 1)
            ax.set_ylim(-0.1, 2)
        for idx, nd in enumerate(nodes):
            col = _COLORS[(idx + m) % len(_COLORS)]
            pts = plan.locs[nd.loc_gidx]
            if d == 2:
                ax.plot(pts[:, 0], pts[:, 1], "s", color=col, markersize=4)
            else:
                ax.plot(pts[:, 0], np.zeros(len(pts)), "s", color=col,
                        markersize=4)
        knots = np.concatenate([nd.knot_gidx for nd in nodes]) if nodes else []
        if len(knots):
            kp = plan.locs[knots]
            if d == 2:
                ax.plot(kp[:, 0], kp[:, 1], "s", color="red", markersize=4)
            else:
                ax.plot(kp[:, 0], np.ones(len(kp)), "s", color="red",
                        markersize=4)
                ax.set_yticks([])
        ax.set_title(f"resolution: {m}")
    fig.tight_layout()
    return _finish(fig, fname, show)


def draw_b_matrix(model, cov, y=None, R=1.0, distr="prior", fname=None,
                  show=False):
    """Heatmap of the multi-resolution basis matrix (reference
    ``drawBMatrix``)."""
    from pymra_torch.tree.basis import basis_matrix

    B = basis_matrix(model, cov, y=y, R=R, distr=distr)
    fig = disp_mat(B, cmap="Spectral", title=f"{distr} basis functions")
    return _finish(fig, fname, show)


def draw_sparsity_pattern(model, cov, y=None, R=1.0, distr="prior",
                          tol=1e-10, fname=None, show=False):
    """0/1 sparsity pattern of the basis matrix (reference
    ``drawSparsityPat``)."""
    from pymra_torch.tree.basis import basis_matrix

    B = basis_matrix(model, cov, y=y, R=R, distr=distr)
    fig = disp_mat(filter_nnz(B, tol), cmap="binary", colorbar=False,
                   title=f"{distr} sparsity pattern")
    return _finish(fig, fname, show)


def draw_basis_functions(model, cov, y=None, R=1.0, distr="prior",
                         fname=None, show=False):
    """Plot the basis functions by resolution (reference
    ``drawBasisFunctions``). 1-D: line plots per level; 2-D: a heatmap per
    function, one figure (``fname.res{m}.png``) per resolution of at most
    36 functions."""
    from pymra_torch.tree.basis import basis_matrix

    plt = _plt()
    plan = model.plan
    Bs = basis_matrix(model, cov, y=y, R=R, distr=distr,
                      group_by_resolution=True)
    if plan.dim == 1:
        fig = plt.figure(figsize=(8, 2 * (plan.M + 1)))
        locs = plan.locs[:, 0]
        for m, Bm in enumerate(Bs):
            ax = fig.add_subplot(plan.M + 1, 1, m + 1)
            cmap = plt.cm.Blues
            ncol = Bm.shape[1]
            for col in range(ncol):
                ax.plot(locs, Bm[:, col],
                        color=cmap((0.3 * ncol + col) / (1.3 * ncol)))
            ax.set_title(f"resolution: {m}")
        fig.tight_layout()
        return _finish(fig, fname, show)

    nx = len(np.unique(plan.locs[:, 0]))
    ny = len(np.unique(plan.locs[:, 1]))
    figs = []
    for m, Bm in enumerate(Bs):
        if Bm.shape[1] > 36:
            continue
        nrows, ncols = get_layout(m, plan.J, plan.r)
        fig, axes = plt.subplots(nrows, ncols, squeeze=False)
        for func, ax in zip(Bm.T, axes.ravel()):
            ax.imshow(func.reshape(ny, nx), vmax=1, vmin=-0.1,
                      cmap="coolwarm")
            ax.set_xticks([])
            ax.set_yticks([])
        fig.suptitle(f"resolution: {m}")
        figs.append(_finish(fig, fname and f"{fname}.res{m}.png", show))
    return figs


def draw_grid_and_obs(model, y_obs, fname=None, show=False):
    """Grid and observation locations (reference ``drawGridAndObs``)."""
    plt = _plt()
    plan = model.plan
    obs = np.isfinite(np.asarray(y_obs).ravel())
    fig, ax = plt.subplots()
    if plan.dim == 1:
        ax.plot(plan.locs[:, 0], np.zeros(plan.n_locs), "o", color="black",
                markersize=3, label="grid locations")
        ax.plot(plan.locs[obs, 0], np.full(obs.sum(), 0.1), "o", color="red",
                markersize=4, label="observations")
        ax.set_ylim(-0.01, 0.2)
        ax.set_yticks([])
        ax.legend()
    else:
        ax.scatter(plan.locs[obs, 0], plan.locs[obs, 1], s=8)
        ax.set_title("observation locations")
    return _finish(fig, fname, show)
