"""No-U-Turn Sampler, iterative and multinomial (counterpart of
``pymra_tpu/infer/nuts.py``).

Recursion-free, as in the JAX package: each doubling builds its subtree
leaf by leaf with a ``[max_depth + 1]`` stack of left edges for the
internal U-turn checks. For leaf ``n = 0 .. 2^depth - 1`` of a subtree:

  * even ``n``: push the state (the left edge of every dyadic range that
    starts at ``n``);
  * odd ``n`` with ``K`` trailing one-bits: check the U-turn criterion
    against the top ``K`` stack entries (the left edges of the ranges that
    end at ``n``), then pop ``K - 1``.

Proposals are drawn progressively with multinomial weights
``exp(log_prob - kinetic)`` (the gradient rides along, so the accepted
state's gradient is never recomputed); subtrees merge by the biased
progressive rule; an energy error above 1000, or a non-finite energy, is a
divergence. Warmup is the per-step Stan schedule of
:mod:`pymra_torch.infer.adapt` (step size by dual averaging, a diagonal
metric from the slow windows).

As in :mod:`pymra_torch.infer.hmc`, the state is float64 on the host and
each leapfrog step reads the value and gradient back (the U-turn and accept
decisions need them). Each chain is one program
(:mod:`pymra_torch.infer._flat`) with its own generator: one after another,
or with ``batched=True`` in lockstep, as the JAX package vmaps its chains'
``while_loop``: at each leapfrog tick the chains whose transition still
needs a point are evaluated in one call of the batched log density, and a
chain whose transition is over waits for the others.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pymra_torch.infer._flat import (
    F64,
    WAIT,
    chain_generators,
    log_uniform,
    ravel,
    run_chains,
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

__all__ = ["nuts", "NUTSResult"]

_DIVERGENCE = 1000.0


class NUTSResult(NamedTuple):
    samples: dict | torch.Tensor  #: leaves [chains, n_samples, ...]
    log_prob: torch.Tensor  #: [chains, n_samples]
    accept_rate: torch.Tensor  #: [chains] mean acceptance statistic
    step_size: torch.Tensor  #: [chains]
    inv_mass: torch.Tensor  #: [chains, dim]
    num_divergent: torch.Tensor  #: [chains]
    tree_depth: torch.Tensor  #: [chains, n_samples] realized doublings


def _uturn(q_first, v_first, q_last, v_last) -> bool:
    dq = q_last - q_first
    return bool(torch.dot(dq, v_first) < 0.0) or bool(
        torch.dot(dq, v_last) < 0.0)


def _logaddexp(a: float, b: float) -> float:
    if a == b:  # both infinite included
        return a + math.log(2.0)
    if a < b:
        a, b = b, a
    if b == -math.inf:
        return a
    return a + math.log1p(math.exp(b - a))


def _trailing_ones(n: int) -> int:
    """Number of trailing one-bits of ``n``: ``(n + 1) & ~n`` isolates the
    lowest zero bit, one less is a mask of the ones below it."""
    return bin(((n + 1) & ~n) - 1).count("1")


def _schedule(num_warmup: int, num_samples: int):
    """Per-step ``(warm, slow, at_end)`` flags of the whole run."""
    slow, end = [], []
    for kind, n in warmup_schedule(num_warmup):
        slow += [kind == "slow"] * n
        end += [False] * (n - 1) + [True]
    slow = slow[:num_warmup] + [False] * num_samples
    end = end[:num_warmup] + [False] * num_samples
    warm = [t < num_warmup for t in range(num_warmup + num_samples)]
    return list(zip(warm, slow, end))


def nuts(
    log_prob_fn: Callable,
    init_params,
    generator: torch.Generator,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    adapt_mass: bool = True,
    steps_per_call: int | None = None,
    batched: bool = False,
) -> NUTSResult:
    """Run NUTS chains (same contract as :func:`pymra_torch.infer.hmc.hmc`,
    ``batched`` included: the chains in lockstep through one evaluation of
    a batched ``log_prob_fn`` a leapfrog tick).

    ``steps_per_call`` is accepted for the JAX package's signature and
    changes nothing but the loop order: when set, the run goes in chunks
    of at most this many transitions, every chain advancing one chunk
    before the next starts, with the sampler state (positions, gradients,
    dual-averaging and metric accumulators) carried between chunks. In JAX
    a chunk bounds one compiled dispatch; here there is none to bound, and
    each chain draws from its own generator, so the draws, step sizes,
    metrics, divergence counts, cost and memory are those of one call.
    ``None``: each chain runs its whole schedule in turn. With ``batched``
    the chains advance together and the chunks change nothing.
    """
    if steps_per_call is not None and steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    x0, unravel = ravel(init_params, batch_dims=1)
    chains, dim = x0.shape

    # generators: each ``yield q`` asks for the value and gradient at q
    def leapfrog(q, p, grad, eps, inv_mass):
        p = p + 0.5 * eps * grad
        q = q + eps * inv_mass * p
        lp, grad = yield q
        p = p + 0.5 * eps * grad
        return q, p, lp, grad

    def kinetic(p, inv_mass) -> float:
        return 0.5 * float(torch.sum(p * p * inv_mass))

    def build_subtree(gen, depth, z_edge, eps, inv_mass, lw0):
        """Extend the trajectory from ``z_edge = (q, p, lp, grad)`` by up
        to ``2^depth`` leapfrog steps of signed size ``eps``. ``lw0`` is
        -H of the initial state (the divergence reference). Returns the new
        edge, the subtree's proposal ``(q, lp, grad)``, its log weight, the
        turning and diverging flags, the acceptance sum and the number of
        leaves built."""
        q_stack = [None] * (max_depth + 1)
        p_stack = [None] * (max_depth + 1)
        sp = 0
        q, p, lp, grad = z_edge
        prop = (q, lp, grad)
        lse, acc_sum = -math.inf, 0.0
        turning = diverging = False
        n = 0
        while n < (1 << depth) and not turning and not diverging:
            q, p, lp, grad = yield from leapfrog(q, p, grad, eps, inv_mass)
            lw = lp - kinetic(p, inv_mass)
            # a non-finite energy (a NaN loglik at an extreme parameter,
            # an infinite momentum) is a divergence, as in Stan
            if not math.isfinite(lw):
                lw = -math.inf
            diverging = (lw0 - lw) > _DIVERGENCE
            d = lw - lw0
            acc_sum += 1.0 if d >= 0.0 else math.exp(d)
            lse_new = _logaddexp(lse, lw)
            if log_uniform(gen) < lw - lse_new:
                prop = (q, lp, grad)
            lse = lse_new
            if n % 2 == 0:
                q_stack[sp], p_stack[sp] = q, p
                sp += 1
            else:
                k = _trailing_ones(n)
                v = inv_mass * p
                for i in range(k):
                    slot = sp - 1 - i
                    if _uturn(q_stack[slot], inv_mass * p_stack[slot], q, v):
                        turning = True
                        break
                sp -= max(k - 1, 0)
            n += 1
        return (q, p, lp, grad), prop, lse, turning, diverging, acc_sum, n

    def transition(q, lp, grad, eps, inv_mass, gen):
        p = torch.randn(dim, generator=gen, dtype=F64) * torch.rsqrt(inv_mass)
        lw0 = lp - kinetic(p, inv_mass)
        z_left = z_right = (q, p, lp, grad)
        prop, lse = (q, lp, grad), lw0
        depth, turning, diverging = 0, False, False
        acc_sum, n_total = 0.0, 1
        while depth < max_depth and not turning and not diverging:
            go_right = float(torch.rand((), generator=gen, dtype=F64)) < 0.5
            (z_new, sub_prop, sub_lse, sub_turn, sub_div, sub_acc,
             sub_n) = yield from build_subtree(
                 gen, depth, z_right if go_right else z_left,
                 eps if go_right else -eps, inv_mass, lw0)
            acc_sum += sub_acc
            n_total += sub_n
            ok = not (sub_turn or sub_div)
            # biased progressive merge
            if log_uniform(gen) < sub_lse - lse and ok:
                prop = sub_prop
            if ok:
                lse = _logaddexp(lse, sub_lse)
                if go_right:
                    z_right = z_new
                else:
                    z_left = z_new
            # the U-turn across the whole trajectory
            full_turn = _uturn(z_left[0], inv_mass * z_left[1],
                               z_right[0], inv_mass * z_right[1])
            depth += 1
            turning = turning or sub_turn or full_turn
            diverging = diverging or sub_div
        q, lp, grad = prop
        return q, lp, grad, acc_sum / max(n_total - 1, 1), diverging, depth

    wf0 = welford_init(dim)

    def step(st, gen, warm, slow, at_end):
        """One transition of one chain's state ``st = [x, lp, grad, da, wf,
        inv_mass]`` (updated in place); returns the draw's record."""
        x, lp, grad, da, wf, inv_mass = st
        # warmup: the current dual-averaging iterate; sampling: the frozen
        # average (da restarted at the last window boundary, so
        # da_final(da) is the adapted step size)
        eps = float(torch.exp(da.log_eps) if warm else da_final(da))
        x, lp, grad, acc, div, depth = yield from transition(
            x, lp, grad, eps, inv_mass, gen)
        if warm:
            da = da_update(da, acc, target_accept)
        if slow:
            wf = welford_update(wf, x)
        # window boundary: apply the metric (slow windows only), restart
        # dual averaging around the frozen step size, reset Welford
        if at_end:
            if slow and adapt_mass:
                inv_mass = welford_var(wf)
            da = da_init(da_final(da))
            wf = wf0
        st[:] = [x, lp, grad, da, wf, inv_mass]
        return x, lp, acc, depth, div

    schedule = _schedule(num_warmup, num_samples)

    def chain(x, gen):
        """One chain's program: its whole schedule, then ``(state,
        records)``."""
        lp, grad = yield x
        st = [x, lp, grad, da_init(init_step_size), wf0,
              torch.ones(dim, dtype=F64)]
        recs = []
        for t, flags in enumerate(schedule):
            rec = yield from step(st, gen, *flags)
            if t >= num_warmup:
                recs.append(rec)
            yield WAIT
        return st, recs

    gens = chain_generators(generator, chains)
    out = run_chains([chain(x0[c], gens[c]) for c in range(chains)],
                     log_prob_fn, unravel, batched, steps_per_call)
    states = [st for st, _ in out]
    records = [recs for _, recs in out]

    def stacked(i, dtype):
        return torch.tensor([[r[i] for r in recs] for recs in records],
                            dtype=dtype).reshape(chains, num_samples)

    xs = torch.stack([torch.stack([r[0] for r in recs]) if recs else
                      torch.empty(0, dim, dtype=F64) for recs in records])
    return NUTSResult(
        samples=unravel(xs),
        log_prob=stacked(1, F64),
        accept_rate=stacked(2, F64).mean(dim=1),
        step_size=torch.stack([da_final(st[3]) for st in states]),
        inv_mass=torch.stack([st[5] for st in states]),
        num_divergent=stacked(4, torch.int64).sum(dim=1),
        tree_depth=stacked(3, torch.int64),
    )
