"""Automatic Differentiation Variational Inference, mean-field Gaussian
(counterpart of ``pymra_tpu/infer/advi.py``).

Fits a diagonal-Gaussian approximation to ``exp(log_prob_fn)`` in the
unconstrained space by maximizing the reparameterized ELBO with
``torch.optim.Adam`` (optax's ``adam`` in the JAX package: the same
defaults, betas (0.9, 0.999) and eps 1e-8 outside the square root). The
``num_mc`` Monte-Carlo draws of a step are evaluated one after another, or
with ``batched=True`` in one call of a batched log density (the JAX
package vmaps them).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pymra_torch.infer._flat import F64, batch_values, ravel

__all__ = ["advi", "ADVIResult"]


class ADVIResult(NamedTuple):
    mean: dict  #: variational mean, in the structure of ``init_params``
    sd: dict  #: variational sd
    elbo_history: torch.Tensor  #: [steps]

    def sample(self, generator: torch.Generator, n: int):
        """``n`` draws of the fitted approximation, leaves ``[n, ...]``."""
        flat_mean, unravel = ravel(self.mean)
        flat_sd, _ = ravel(self.sd)
        z = torch.randn(n, flat_mean.shape[0], generator=generator,
                        dtype=F64)
        return unravel(flat_mean + z * flat_sd)


def advi(
    log_prob_fn: Callable,
    init_params,
    generator: torch.Generator,
    *,
    steps: int = 500,
    num_mc: int = 8,
    learning_rate: float = 5e-2,
    batched: bool = False,
) -> ADVIResult:
    """Mean-field ADVI.

    Args:
      log_prob_fn: ``theta_dict -> 0-dim tensor`` (unnormalized) log
        density in the unconstrained space.
      init_params: dict of initial mean values (no chain axis).
      generator: CPU ``torch.Generator`` for the Monte-Carlo draws.
      batched: ``log_prob_fn`` takes leaves with a leading ``[num_mc]``
        axis and returns ``[num_mc]``: a step's draws in one evaluation and
        one backward.

    Returns:
      :class:`ADVIResult`; ``result.sample(generator, n)`` draws from the
      fitted approximation.
    """
    mu0, unravel = ravel(init_params)
    dim = mu0.shape[0]
    mu = mu0.clone().requires_grad_(True)
    log_sd = torch.full((dim,), -2.0, dtype=F64, requires_grad=True)
    opt = torch.optim.Adam([mu, log_sd], lr=learning_rate)
    entropy_const = 0.5 * dim * (1.0 + math.log(2 * math.pi))
    history = []
    for _ in range(steps):
        z = torch.randn(num_mc, dim, generator=generator, dtype=F64)
        draws = mu + z * torch.exp(log_sd)
        if batched:
            lps = batch_values(log_prob_fn(unravel(draws)), num_mc)
        else:
            lps = torch.stack([log_prob_fn(unravel(d)).to("cpu", F64)
                               for d in draws])
        elbo = lps.mean() + log_sd.sum() + entropy_const
        opt.zero_grad()
        (-elbo).backward()
        opt.step()
        history.append(float(elbo.detach()))
    with torch.no_grad():
        return ADVIResult(mean=unravel(mu.detach().clone()),
                          sd=unravel(torch.exp(log_sd)),
                          elbo_history=torch.tensor(history, dtype=F64))
