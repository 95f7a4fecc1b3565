"""Flat float64 parameter vectors for the samplers (the port's stand-in for
``jax.flatten_util.ravel_pytree``), per-chain generators and the
value-and-gradient call every gradient sampler makes."""
from __future__ import annotations

import math
from typing import Callable

import torch

F64 = torch.float64


def _leaves(theta) -> tuple[list | None, list[torch.Tensor]]:
    if isinstance(theta, dict):
        names = sorted(theta)  # the order ravel_pytree gives a dict
        return names, [_f64(theta[k]) for k in names]
    return None, [_f64(theta)]


def _f64(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", F64)


def ravel(theta, batch_dims: int = 0) -> tuple[torch.Tensor, Callable]:
    """Flatten a dict of tensors (keys sorted) or one tensor into a float64
    CPU vector ``[*batch, dim]``, the first ``batch_dims`` axes of every
    leaf kept (the chains axis of ``init_params``).

    Returns ``(flat, unravel)``; ``unravel`` maps ``[..., dim]`` back to the
    structure, any leading axes kept (``[chains, n, dim]`` -> leaves of
    ``[chains, n, ...]``).
    """
    names, leaves = _leaves(theta)
    batch = leaves[0].shape[:batch_dims]
    shapes = [leaf.shape[batch_dims:] for leaf in leaves]
    sizes = [s.numel() for s in shapes]
    flat = torch.cat([leaf.reshape(*batch, -1) for leaf in leaves], dim=-1)

    def unravel(x: torch.Tensor):
        parts = torch.split(x, sizes, dim=-1)
        vals = [p.reshape(x.shape[:-1] + s) for p, s in zip(parts, shapes)]
        return dict(zip(names, vals)) if names is not None else vals[0]

    return flat, unravel


def chain_generators(generator, n: int) -> list[torch.Generator]:
    """``n`` CPU generators, each seeded by one draw of ``generator``: one
    chain's stream does not depend on how far another chain has run. A
    sequence of ``n`` generators is taken as the chains' own (a rank's
    share of a larger run, ``pymra_torch.parallel.chains``)."""
    if not isinstance(generator, torch.Generator):
        gens = list(generator)
        if len(gens) != n:
            raise ValueError(f"{len(gens)} generators for {n} chains")
        return gens
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def value_and_grad(log_prob_fn: Callable, unravel: Callable) -> Callable:
    """``x -> (log_prob, gradient)``: the value a Python float, the
    gradient a float64 CPU vector. ``log_prob_fn`` receives the structure
    as float64 CPU tensors and may compute on any device."""

    def vg(x: torch.Tensor):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = log_prob_fn(unravel(x))
            (grad,) = torch.autograd.grad(lp, x)
        return float(lp.detach()), grad

    return vg


def log_uniform(gen: torch.Generator) -> float:
    """``log u`` of one uniform draw on [0, 1) (``-inf`` for an exact 0)."""
    u = float(torch.rand((), generator=gen, dtype=F64))
    return math.log(u) if u > 0.0 else -math.inf

