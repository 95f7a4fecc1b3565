"""Maximum-likelihood estimation of kernel hyper-parameters
(counterpart of ``pymra_tpu/infer/mle.py``).

The reference does MLE by wrapping a full tree rebuild in
``scipy.optimize.minimize(..., method='nelder-mead')``. Here the tree plan
is static and the likelihood differentiable (:meth:`MRAModel.loglik_fn`),
so :func:`fit_mle` offers:

* ``method='nelder-mead'`` — derivative-free, scipy's simplex over one
  sweep per evaluation;
* ``method='adam'`` — ``torch.optim.Adam`` on autograd gradients;
* ``method='lbfgs'`` — ``torch.optim.LBFGS`` with a strong-Wolfe line
  search, one L-BFGS iteration per step. It is not optax's L-BFGS (the
  JAX package's), so the two reach the same optimum by different paths.

Positive parameters are optimized in log-space, in float64 on the CPU; a
0-dim CPU parameter enters a sweep on the card as a scalar and receives
its gradient there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["fit_mle", "nelder_mead"]


def nelder_mead(f: Callable, x0: np.ndarray, *, max_iter: int = 200,
                xatol: float = 1e-5, fatol: float = 1e-7):
    """Minimize ``f`` (a function of a float64 tensor) with scipy's
    Nelder-Mead."""
    import scipy.optimize as opt

    def value(x):
        with torch.no_grad():
            return float(f(torch.as_tensor(x, dtype=torch.float64)))

    return opt.minimize(
        value, np.asarray(x0, dtype=np.float64), method="nelder-mead",
        options={"maxiter": max_iter, "xatol": xatol, "fatol": fatol})


def fit_mle(
    loglik_fn: Callable,
    theta0: dict,
    *,
    method: str = "lbfgs",
    steps: int = 200,
    learning_rate: float = 5e-2,
    positive: tuple | None = None,
):
    """Maximize ``loglik_fn(theta)`` over a dict of scalar parameters.

    Args:
      loglik_fn: differentiable ``theta_dict -> loglik`` (e.g. from
        :meth:`pymra_torch.tree.model.MRAModel.loglik_fn` with a kernel
        builder); it receives a dict of 0-dim float64 tensors.
      theta0: initial parameter dict (e.g. ``{"l": 0.3, "sig": 1.0}``).
      method: ``'lbfgs'``, ``'adam'``, or ``'nelder-mead'``.
      steps: optimizer steps (Nelder-Mead: ``50 * steps`` iterations at
        most). The gradient methods stop early once the objective changes
        by less than ``1e-10 * max(1, |value|)`` between steps.
      positive: names optimized in log-space; default = all.

    Returns:
      dict with ``theta`` (optimum), ``loglik``, ``converged`` and
      ``history`` (the negated loglik at the start of each step;
      Nelder-Mead reports ``n_evals`` instead).
    """
    names = sorted(theta0)
    if positive is None:
        positive = tuple(names)
    if method not in ("lbfgs", "adam", "nelder-mead"):
        raise ValueError(f"unknown method {method!r}")

    def unpack(x: torch.Tensor) -> dict:
        return {k: torch.exp(x[i]) if k in positive else x[i]
                for i, k in enumerate(names)}

    def neg_obj(x):
        return -loglik_fn(unpack(x))

    x0 = torch.tensor([np.log(float(theta0[k])) if k in positive
                       else float(theta0[k]) for k in names],
                      dtype=torch.float64)

    def result(x, **extra):
        with torch.no_grad():
            value = -float(neg_obj(x))
            theta = {k: float(v) for k, v in unpack(x).items()}
        return {"theta": theta, "loglik": value, **extra}

    if method == "nelder-mead":
        res = nelder_mead(neg_obj, x0.numpy(), max_iter=50 * steps)
        return result(torch.as_tensor(res.x), converged=bool(res.success),
                      n_evals=int(res.nfev))

    x = x0.clone().requires_grad_(True)
    if method == "adam":
        opt = torch.optim.Adam([x], lr=learning_rate)
    else:
        opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1,
                                line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        value = neg_obj(x)
        value.backward()
        return value

    history = []
    prev = np.inf
    converged = False
    for _ in range(steps):
        v = float(opt.step(closure).detach())
        history.append(v)
        if np.isfinite(prev) and abs(prev - v) < 1e-10 * max(1.0, abs(v)):
            converged = True
            break
        prev = v
    return result(x.detach(), converged=converged, history=history)
