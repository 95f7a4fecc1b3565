"""Evaluation / scoring metrics (counterpart of
``pymra_tpu/utils/scoring.py``).

Equivalents of the reference scoring toolbox (pyMRA/MRATools.py:62-139):
``MSE`` -> :func:`rmse`, ``KLdiv`` -> :func:`kl_divergence`,
``logscore`` -> :func:`logscore`. Tensors in, 0-dim tensors out, through
Cholesky factors (no explicit inverses), differentiable. Arrays are
accepted too; they become float64 tensors on the CPU.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rmse", "mse", "kl_divergence", "logscore"]


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float64)


def rmse(x_pred, x_true=0.0) -> torch.Tensor:
    """Root-mean-square error (the reference's ``MSE``, MRATools.py:62-67,
    which despite its name returns the *root* MSE)."""
    x_pred = _t(x_pred)
    diff = (x_pred - _t(x_true, x_pred)).reshape(-1)
    return torch.sqrt(torch.mean(diff * diff))


# Alias kept for reference-API familiarity; see :func:`rmse` docstring.
mse = rmse


def _solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, b, upper=False)


def kl_divergence(mu0, mu1, sig0, sig1) -> torch.Tensor:
    """KL(N(mu0, sig0) || N(mu1, sig1)) between dense Gaussians.

    Same quantity as the reference ``KLdiv`` (MRATools.py:97-113) but computed
    through Cholesky factors: trace and log-det terms via triangular solves.
    """
    mu0 = _t(mu0).reshape(-1)
    mu1 = _t(mu1, mu0).reshape(-1)
    n = mu0.shape[0]
    l0 = torch.linalg.cholesky(_t(sig0, mu0))
    l1 = torch.linalg.cholesky(_t(sig1, mu0))
    m = _solve_lower(l1, l0)
    trace_term = torch.sum(m * m) - n
    logdet_term = 2.0 * (torch.log(torch.diagonal(l1)).sum()
                         - torch.log(torch.diagonal(l0)).sum())
    w = _solve_lower(l1, (mu1 - mu0)[:, None])
    mean_term = torch.sum(w * w)
    return 0.5 * (trace_term + logdet_term + mean_term)


def logscore(obs, mu_pred, sig_pred) -> torch.Tensor:
    """Gaussian log-density of the predictive at the observed entries.

    Equivalent of ``logscore`` (MRATools.py:121-139): restrict to the finite
    entries of ``obs`` and evaluate ``log N(y_obs; mu, Sig)`` there, through
    a Cholesky factor of the observed sub-matrix of the dense predictive
    covariance ``sig_pred``.
    """
    obs = _t(obs).reshape(-1)
    mu = _t(mu_pred, obs).reshape(-1)
    idx = torch.nonzero(torch.isfinite(obs)).reshape(-1)
    y = obs[idx]
    m = mu[idx]
    sig = _t(sig_pred, obs)[idx[:, None], idx[None, :]]
    n = y.shape[0]
    chol = torch.linalg.cholesky(sig)
    w = _solve_lower(chol, (y - m)[:, None])
    return (-0.5 * torch.sum(w * w)
            - torch.log(torch.diagonal(chol)).sum()
            - 0.5 * n * math.log(2.0 * math.pi))
