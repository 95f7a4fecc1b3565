"""Hamiltonian Monte Carlo over the differentiable MRA marginal likelihood
(counterpart of ``pymra_tpu/infer/hmc.py``).

The static tree plan makes ``loglik(theta)`` a differentiable function
(:meth:`pymra_torch.tree.model.MRAModel.loglik_fn`), so kernel
hyper-parameters are sampled with gradients. HMC with:

  * dual-averaging step-size adaptation toward a target acceptance rate
    (Hoffman & Gelman 2014, Algorithm 5), phase by phase over
    :func:`pymra_torch.infer.adapt.warmup_schedule`;
  * a diagonal inverse metric from the slow windows' Welford variance;
  * jittered trajectory lengths against resonance.

The sampler's state is a flat float64 vector per chain on the host (keys
sorted, as ``ravel_pytree`` orders a dict). ``log_prob_fn`` receives a dict
of float64 CPU tensors; a model on the card moves them there itself, and
each leapfrog step reads the value and the gradient back, which the
accept decision needs anyway. Each chain has its own generator seeded from
the caller's and is one program (:mod:`pymra_torch.infer._flat`): the
chains run one after another, or, with ``batched=True``, in lockstep
through a batched log density, one evaluation of all chains a leapfrog
step. The port's kernels are launches inside autograd Functions with no
vmap rule, so the batch is an explicit leading axis (JAX vmaps the
chains). A chain whose jittered trajectory is shorter waits for the
others at the end of the transition. The value and gradient of the end of
a trajectory are carried into the next transition, so a trajectory of
``n`` steps costs ``n`` value-and-gradient evaluations.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pymra_torch.infer._flat import (
    F64,
    WAIT,
    chain_generators,
    ravel,
    run_chains,
    run_serial,
)
from pymra_torch.infer.adapt import (
    da_final,
    da_init,
    da_update,
    warmup_schedule,
    welford_init,
    welford_update,
    welford_var,
)

__all__ = ["hmc", "HMCResult"]


class HMCResult(NamedTuple):
    samples: dict | torch.Tensor  #: leaves [chains, n_samples, ...]
    log_prob: torch.Tensor  #: [chains, n_samples]
    accept_rate: torch.Tensor  #: [chains]
    step_size: torch.Tensor  #: [chains] adapted step sizes
    inv_mass: torch.Tensor  #: [chains, dim] adapted inverse metric diagonal


def _leapfrog(value_and_grad_fn: Callable, x, p, grad, eps, inv_mass,
              n_steps: int):
    """``n_steps`` leapfrog steps from ``(x, p)``, ``grad`` the gradient at
    ``x``, each point evaluated by ``value_and_grad_fn``. Returns ``(x, p,
    log_prob, grad)`` at the end."""
    return run_serial([_leapfrog_steps(x, p, grad, eps, inv_mass, n_steps)],
                      value_and_grad_fn)[0]


def _leapfrog_steps(x, p, grad, eps, inv_mass, n_steps: int):
    """:func:`_leapfrog` as a chain program's part: a generator that yields
    each point it needs evaluated and receives ``(log_prob, grad)``."""
    lp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad
        x = x + eps * inv_mass * p
        lp, grad = yield x
        p = p + 0.5 * eps * grad
    return x, p, lp, grad


def _kinetic(p, inv_mass) -> float:
    return 0.5 * float(torch.sum(p * p * inv_mass))


def _accept_prob(h_old: float, h_new: float) -> float:
    """``min(1, exp(h_old - h_new))``; a NaN energy, or a difference of
    ``-inf``, accepts with probability 0."""
    d = h_old - h_new
    if math.isnan(d):
        return 0.0
    log_accept = min(0.0, d)
    return math.exp(log_accept) if math.isfinite(log_accept) else 0.0


def hmc(
    log_prob_fn: Callable,
    init_params,
    generator: torch.Generator,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_leapfrog: int = 16,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    adapt_mass: bool = True,
    jitter_traj: bool = True,
    batched: bool = False,
) -> HMCResult:
    """Run HMC chains.

    Args:
      log_prob_fn: ``theta_dict -> 0-dim tensor`` log density; with
        ``batched``, ``theta_dict`` of leaves with a leading ``[k]`` axis
        (``k`` chains) ``-> [k]`` (for example
        ``MRAModel.loglik_fn(..., batched=True)``).
      init_params: dict of tensors with a leading ``[chains]`` axis (or one
        ``[chains, ...]`` tensor).
      generator: CPU ``torch.Generator``; the same seed gives the same
        draws. The global generator is never touched. Or a list of one
        generator per chain (the chains' own, as
        ``pymra_torch.parallel.chains.shard_generators`` hands a rank).
      batched: run the chains in lockstep, one evaluation of the batched
        ``log_prob_fn`` a leapfrog step for every chain still in its
        trajectory; the draws are those of the serial run with the same
        generator, up to the rounding of batched evaluations.

    Returns:
      :class:`HMCResult` of CPU tensors, samples in the structure of
      ``init_params``.
    """
    if num_leapfrog < 1:
        raise ValueError(f"num_leapfrog must be >= 1, got {num_leapfrog}")
    x0, unravel = ravel(init_params, batch_dims=1)
    chains, dim = x0.shape

    def transition(x, lp, grad, eps, inv_mass, gen):
        """One Metropolis-adjusted trajectory: ``(x, lp, grad, accept
        probability)``."""
        p = torch.randn(dim, generator=gen, dtype=F64) / torch.sqrt(inv_mass)
        n_steps = num_leapfrog
        if jitter_traj:
            n_steps = 1 + int(torch.randint(num_leapfrog // 2,
                                            num_leapfrog + 1, (),
                                            generator=gen))
        x_new, p_new, lp_new, g_new = yield from _leapfrog_steps(
            x, p, grad, eps, inv_mass, n_steps)
        prob = _accept_prob(-lp + _kinetic(p, inv_mass),
                            -lp_new + _kinetic(p_new, inv_mass))
        if float(torch.rand((), generator=gen, dtype=F64)) < prob:
            return x_new, lp_new, g_new, prob
        return x, lp, grad, prob

    def single_chain(x, gen):
        """One chain's program (:mod:`pymra_torch.infer._flat`)."""
        lp, grad = yield x
        eps = torch.tensor(init_step_size, dtype=F64)
        inv_mass = torch.ones(dim, dtype=F64)
        for kind, n in warmup_schedule(num_warmup):
            da = da_init(eps)
            wf = welford_init(dim)
            for _ in range(n):
                x, lp, grad, acc = yield from transition(
                    x, lp, grad, float(torch.exp(da.log_eps)), inv_mass, gen)
                yield WAIT
                da = da_update(da, acc, target_accept)
                if kind == "slow":
                    wf = welford_update(wf, x)
            eps = da_final(da)
            if kind == "slow" and adapt_mass:
                inv_mass = welford_var(wf)
        xs, lps, accs = [], [], []
        for _ in range(num_samples):
            x, lp, grad, acc = yield from transition(
                x, lp, grad, float(eps), inv_mass, gen)
            yield WAIT
            xs.append(x)
            lps.append(lp)
            accs.append(acc)
        xs = torch.stack(xs) if xs else torch.empty(0, dim, dtype=F64)
        return (xs, torch.tensor(lps, dtype=F64),
                torch.tensor(accs, dtype=F64).mean(), eps, inv_mass)

    out = run_chains(
        [single_chain(x0[c], gen)
         for c, gen in enumerate(chain_generators(generator, chains))],
        log_prob_fn, unravel, batched)
    xs, lps, acc, eps, inv_mass = (torch.stack(v) for v in zip(*out))
    return HMCResult(unravel(xs), lps, acc, eps, inv_mass)
