"""Sequential Monte Carlo over tempered likelihoods (counterpart of
``pymra_tpu/infer/smc.py``).

Anneals particles from the prior to the posterior through
``prior * likelihood^beta`` with an adaptive temperature ladder (the next
beta keeps the effective sample size at ``ess_target`` of the particle
count, found by bisection), systematic resampling, and random-walk
Metropolis mutations scaled by the particle cloud's standard deviation.

The stage loop runs on the host, as the JAX package's ``host_loop=True``
does (documented there as giving the same results as its on-device loop;
the port has no other, so it takes no ``host_loop`` argument). Particles
are evaluated under ``torch.no_grad()``, one after another, or with
``batched=True`` all in one call of batched log densities per stage and
per mutation (the JAX package vmaps them). Each particle carries its
log-likelihood: a resampled or mutated particle's value is the one its
evaluation returned, so a stage costs ``n_mutations * n_particles``
evaluations (the JAX package evaluates the resampled cloud again).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pymra_torch.infer._flat import F64, batch_values, ravel

__all__ = ["smc", "SMCResult"]


class SMCResult(NamedTuple):
    particles: dict  #: leaves [n_particles, ...]
    log_weights: torch.Tensor  #: [n_particles] (uniform after resampling)
    log_evidence: torch.Tensor  #: marginal-likelihood estimate
    betas: torch.Tensor  #: realized temperature ladder
    acc_rates: torch.Tensor  #: mutation acceptance per stage


def _systematic_resample_u(u, log_w: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling indices of ``n`` particles for the uniform
    offset ``u`` in [0, 1)."""
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    return torch.searchsorted(cum, (u + torch.arange(n, dtype=cum.dtype)) / n)


def _systematic_resample(generator: torch.Generator, log_w: torch.Tensor,
                         n: int) -> torch.Tensor:
    u = torch.rand((), generator=generator, dtype=log_w.dtype)
    return _systematic_resample_u(u, log_w, n)


def _next_beta(log_like: torch.Tensor, beta: float, ess_target: float,
               n: int) -> float:
    """Largest beta' in (beta, 1] with ESS(beta' - beta weights) >= target,
    by bisection to a width of 1e-4."""

    def ess(b):
        lw = (b - beta) * log_like
        w = torch.exp(lw - torch.max(lw))
        return float(torch.sum(w) ** 2 / torch.sum(w * w))

    if ess(1.0) >= ess_target * n:
        return 1.0
    lo, hi = beta, 1.0
    while hi - lo > 1e-4:
        mid = 0.5 * (lo + hi)
        if ess(mid) >= ess_target * n:
            lo = mid
        else:
            hi = mid
    return lo


def smc(
    log_like_fn: Callable,
    log_prior_fn: Callable,
    prior_sample_fn: Callable,
    generator: torch.Generator,
    *,
    n_particles: int = 256,
    ess_target: float = 0.5,
    n_mutations: int = 5,
    max_stages: int = 50,
    rw_scale: float = 0.5,
    batched: bool = False,
) -> SMCResult:
    """Adaptive tempered SMC.

    Args:
      log_like_fn: ``theta_dict -> 0-dim tensor`` log-likelihood.
      log_prior_fn: ``theta_dict -> 0-dim tensor`` log-prior.
      prior_sample_fn: ``generator -> theta_dict``, one prior draw.
      generator: CPU ``torch.Generator``.
      batched: ``log_like_fn`` and ``log_prior_fn`` take leaves with a
        leading ``[n_particles]`` axis and return ``[n_particles]``: every
        particle in one evaluation. The same draws as the serial run, up to
        the rounding of batched evaluations.

    Returns:
      :class:`SMCResult` (posterior particles, log-evidence estimate).
    """
    draws = [prior_sample_fn(generator) for _ in range(n_particles)]
    _, unravel = ravel(draws[0])
    particles = torch.stack([ravel(d)[0] for d in draws])
    dim = particles.shape[1]

    def evaluate(fn, parts):
        if not batched:
            return torch.stack([fn(unravel(x)).to("cpu", F64)
                                for x in parts])
        return batch_values(fn(unravel(parts)), len(parts))

    beta, log_evidence = 0.0, 0.0
    betas, accs = [], []
    with torch.no_grad():
        ll = evaluate(log_like_fn, particles)
        while beta < 1.0 and len(betas) < max_stages:
            new_beta = _next_beta(ll, beta, ess_target, n_particles)
            lw = (new_beta - beta) * ll
            log_evidence += float(torch.logsumexp(lw, dim=0)
                                  - math.log(n_particles))
            # an index past the end (non-finite weights) takes the last
            # particle, as JAX's gather clamps it
            idx = _systematic_resample(generator, lw, n_particles).clamp(
                max=n_particles - 1)
            particles, ll = particles[idx], ll[idx]
            # random-walk Metropolis mutations targeting
            # prior * like^new_beta
            lprior = evaluate(log_prior_fn, particles)
            stage_acc = []
            for _ in range(n_mutations):
                scale = rw_scale * torch.std(particles, dim=0,
                                             correction=0) + 1e-8
                prop = particles + scale * torch.randn(
                    n_particles, dim, generator=generator, dtype=F64)
                ll_prop = evaluate(log_like_fn, prop)
                lprior_prop = evaluate(log_prior_fn, prop)
                log_u = torch.log(torch.rand(n_particles, generator=generator,
                                             dtype=F64))
                take = log_u < ((new_beta * ll_prop + lprior_prop)
                                - (new_beta * ll + lprior))
                particles = torch.where(take[:, None], prop, particles)
                ll = torch.where(take, ll_prop, ll)
                lprior = torch.where(take, lprior_prop, lprior)
                stage_acc.append(float(take.to(F64).mean()))
            beta = new_beta
            betas.append(new_beta)
            accs.append(sum(stage_acc) / len(stage_acc) if stage_acc
                        else math.nan)
    return SMCResult(
        particles=unravel(particles),
        log_weights=torch.zeros(n_particles, dtype=F64),
        log_evidence=torch.tensor(log_evidence, dtype=F64),
        betas=torch.tensor(betas, dtype=F64),
        acc_rates=torch.tensor(accs, dtype=F64),
    )
