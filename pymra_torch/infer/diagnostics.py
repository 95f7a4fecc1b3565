"""MCMC convergence diagnostics: split R-hat and effective sample size
(counterpart of ``pymra_tpu/infer/diagnostics.py``).

Gelman et al. / Vehtari et al. (2021) split-R-hat and the bulk ESS from the
initial-positive-sequence autocorrelation estimator, vectorized over
parameters. ``ess`` takes every lag's autocovariance from one zero-padded
FFT, not a loop over lags. Inputs may be numpy arrays or tensors; results
are float64 CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_rhat", "ess"]


def _split(chains) -> torch.Tensor:
    """[c, n, ...] -> [2c, n//2, ...] (float64, on the host)"""
    x = torch.as_tensor(chains).detach().to("cpu", torch.float64)
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half: 2 * half]], dim=0)


def split_rhat(chains) -> torch.Tensor:
    """Split-R-hat. ``chains``: [n_chains, n_samples, ...] -> [...]."""
    x = _split(chains)
    n = x.shape[1]
    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, correction=1)
    between = n * chain_means.var(dim=0, correction=1)
    within = chain_vars.mean(dim=0)
    var_est = (n - 1) / n * within + between / n
    return torch.sqrt(var_est / within)


def ess(chains, max_lag: int | None = None) -> torch.Tensor:
    """Bulk effective sample size. ``chains``: [n_chains, n_samples, ...].

    ``acov[k] = irfft(|rfft(xc)|^2)[k] / n`` with ``xc`` zero-padded to a
    power of two of at least ``2 n`` (no circular wrap-around).
    """
    x = _split(chains)
    c, n = x.shape[:2]
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    max_lag = min(int(max_lag), n)
    xc = x - x.mean(dim=1, keepdim=True)
    size = 1 << int(np.ceil(np.log2(max(2 * n, 2))))
    f = torch.fft.rfft(xc, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :max_lag] / n
    rho_per_chain = torch.movedim(acov, 1, 0)  # [L, c, ...]
    var0 = rho_per_chain[0]
    # combine with the between-chain variance (Vehtari et al. 2021 eq. 10)
    chain_means = x.mean(dim=1)
    w = var0.mean(dim=0)
    between = chain_means.var(dim=0, correction=1)
    var_plus = w * (n - 1) / n + between
    rho = 1.0 - (w - rho_per_chain.mean(dim=1)) / var_plus  # [L, ...]
    # initial positive sequence: sum pairs until a pair goes negative
    even = rho[0::2][: max_lag // 2]
    odd = rho[1::2][: max_lag // 2]
    pair = even + odd
    pos = torch.cumprod((pair > 0).to(rho.dtype), dim=0)
    tau = -1.0 + 2.0 * torch.sum(pair * pos, dim=0)
    tau = torch.clamp(tau, min=1e-3)
    return c * n / tau
