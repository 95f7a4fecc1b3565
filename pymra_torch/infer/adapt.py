"""Warmup adaptation shared by HMC and NUTS (counterpart of
``pymra_tpu/infer/adapt.py``).

Stan-style three-phase warmup:

  * an initial fast phase adapting only the step size (identity metric);
  * doubling "slow" windows; within each, dual averaging continues and a
    Welford accumulator estimates the posterior variance; at each window
    end the diagonal inverse metric is updated and dual averaging restarts
    around the current step size (a new metric invalidates the old
    step-size statistics);
  * a final fast phase polishing the step size under the final metric.

Plain functions on float64 tensors over two named tuples; the constants
(gamma 0.05, t0 10, kappa 0.75, Stan's shrinkage of the variance toward
1e-3) are the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DAState", "da_init", "da_update", "da_final", "WelfordState",
           "welford_init", "welford_update", "welford_var",
           "warmup_schedule"]

_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75


class DAState(NamedTuple):
    mu: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor


def da_init(eps, dtype=torch.float64) -> DAState:
    eps = torch.as_tensor(eps, dtype=dtype)
    return DAState(
        mu=torch.log(10.0 * eps),
        log_eps=torch.log(eps),
        log_eps_bar=torch.log(eps),
        h_bar=torch.zeros_like(eps),
        t=torch.zeros_like(eps),
    )


def da_update(state: DAState, accept_prob, target: float) -> DAState:
    t = state.t + 1.0
    h_bar = (1 - 1 / (t + _T0)) * state.h_bar + (
        (target - accept_prob) / (t + _T0))
    log_eps = state.mu - torch.sqrt(t) / _GAMMA * h_bar
    w = t ** (-_KAPPA)
    log_eps_bar = w * log_eps + (1 - w) * state.log_eps_bar
    return DAState(state.mu, log_eps, log_eps_bar, h_bar, t)


def da_final(state: DAState) -> torch.Tensor:
    """The averaged step size to freeze after a phase."""
    return torch.exp(state.log_eps_bar)


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim: int, dtype=torch.float64) -> WelfordState:
    return WelfordState(
        count=torch.zeros((), dtype=dtype),
        mean=torch.zeros(dim, dtype=dtype),
        m2=torch.zeros(dim, dtype=dtype),
    )


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_var(state: WelfordState, regularize: bool = True
                ) -> torch.Tensor:
    """Sample variance with Stan's shrinkage toward unit scale."""
    var = state.m2 / torch.clamp(state.count - 1, min=1)
    if regularize:
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return torch.where(state.count > 2, torch.clamp(var, 1e-10, 1e10),
                       torch.ones_like(var))


def warmup_schedule(num_warmup: int, init_buffer: int = 75,
                    term_buffer: int = 50, base_window: int = 25):
    """List of phases: ``("fast", n)`` adapts step size only; ``("slow", n)``
    additionally estimates the metric and applies it at the phase end."""
    if num_warmup <= 20:
        return [("fast", num_warmup)]
    if init_buffer + base_window + term_buffer > num_warmup:
        # scale Stan's defaults down proportionally
        scale = num_warmup / (init_buffer + base_window + term_buffer)
        init_buffer = max(int(init_buffer * scale), 1)
        term_buffer = max(int(term_buffer * scale), 1)
        base_window = num_warmup - init_buffer - term_buffer
    phases = [("fast", init_buffer)]
    t = init_buffer
    w = base_window
    while t + w + term_buffer <= num_warmup:
        last = t + 2 * w + term_buffer > num_warmup
        n = (num_warmup - term_buffer - t) if last else w
        phases.append(("slow", n))
        t += n
        w *= 2
    if num_warmup - t > 0:
        phases.append(("fast", num_warmup - t))
    return phases
