"""Flat float64 parameter vectors for the samplers (the port's stand-in for
``jax.flatten_util.ravel_pytree``), per-chain generators, the
value-and-gradient call every gradient sampler makes, and the runners that
run the chains' programs one after another or in lockstep.

A chain's program is a Python generator: it yields each point it needs
evaluated (a float64 vector ``[dim]``) and receives ``(value, gradient)``
for it, and yields :data:`WAIT` at the end of each transition. One copy of
the sampler's code thus serves both runners: :func:`run_serial` answers
every point of one chain at a time; :func:`run_lockstep` answers the points
of all chains that want one in one batched evaluation, and lets the chains
that reached the end of their transition wait until every chain has (the
port's counterpart of a ``jax.vmap`` of the sampler's loop: a transition
costs the largest evaluation count among its chains, not their sum).
Each chain draws from its own generator, so both runners make the same
decisions and draws, up to the rounding of a batched against a single
evaluation."""
from __future__ import annotations

import math
from typing import Callable, Generator

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


def batch_values(values: torch.Tensor, k: int) -> torch.Tensor:
    """A batched density's values at ``k`` points as float64 on the CPU
    (differentiably), refusing any shape but ``[k]``."""
    if tuple(values.shape) != (k,):
        raise ValueError(f"a batched density maps [k] points to [k] values; "
                         f"got {tuple(values.shape)} for k={k}")
    return values.to("cpu", F64)


def batched_value_and_grad(log_prob_fn: Callable,
                           unravel: Callable) -> Callable:
    """``x [k, dim] -> (log_prob [k], gradient [k, dim])``, both float64
    CPU tensors, from one evaluation of ``log_prob_fn`` on the structure
    with a leading ``[k]`` axis (it returns ``[k]``) and one backward of
    the sum: the ``k`` points are independent, so row ``i`` of the
    gradient is that of ``log_prob[i]``."""

    def vg(x: torch.Tensor):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = batch_values(log_prob_fn(unravel(x)), x.shape[0])
            (grad,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), grad

    return vg


#: what a chain's program yields at the end of a transition
WAIT = None


class _Chain:
    """A chain's program and the request it is stopped at."""

    def __init__(self, program: Generator):
        self.program, self.done, self.result = program, False, None
        self.send(None)  # starts it: runs to its first request

    def send(self, reply) -> None:
        try:
            self.request = self.program.send(reply)
        except StopIteration as stop:
            self.done, self.result = True, stop.value


def run_serial(programs, vg: Callable, chunk: int | None = None) -> list:
    """Run each program to its end in turn, answering each point with
    ``vg(x) -> (float, [dim])``; with ``chunk``, every program runs that
    many transitions before the next one does, round after round. Returns
    the programs' return values."""
    chains = [_Chain(p) for p in programs]
    while not all(ch.done for ch in chains):
        for ch in chains:
            passed = 0
            while not ch.done and (chunk is None or passed < chunk):
                if ch.request is WAIT:
                    passed += 1
                    ch.send(None)
                else:
                    ch.send(vg(ch.request))
    return [ch.result for ch in chains]


def run_lockstep(programs, vg_batched: Callable) -> list:
    """Run the programs together: each tick evaluates the points of every
    chain that wants one in one call of ``vg_batched(x [k, dim]) ->
    (log_prob [k], gradient [k, dim])``; when every live chain has reached
    the end of its transition, all go on to the next. Returns the
    programs' return values."""
    chains = [_Chain(p) for p in programs]
    while True:
        live = [ch for ch in chains if not ch.done]
        if not live:
            return [ch.result for ch in chains]
        want = [ch for ch in live if ch.request is not WAIT]
        if not want:
            for ch in live:
                ch.send(None)
            continue
        lp, grad = vg_batched(torch.stack([ch.request for ch in want]))
        for i, ch in enumerate(want):
            ch.send((float(lp[i]), grad[i]))


def run_chains(programs, log_prob_fn: Callable, unravel: Callable,
               batched: bool, chunk: int | None = None) -> list:
    """:func:`run_lockstep` over ``log_prob_fn`` as a batched log density
    (``batched``), else :func:`run_serial` over it as a single one."""
    if batched:
        return run_lockstep(programs,
                            batched_value_and_grad(log_prob_fn, unravel))
    return run_serial(programs, value_and_grad(log_prob_fn, unravel), chunk)


def log_uniform(gen: torch.Generator) -> float:
    """``log u`` of one uniform draw on [0, 1) (``-inf`` for an exact 0)."""
    u = float(torch.rand((), generator=gen, dtype=F64))
    return math.log(u) if u > 0.0 else -math.inf

