"""Failure detection and recovery (counterpart of
``pymra_tpu/utils/health.py``).

  * in-sweep: numerical failure is handled inside the kernels by the
    per-matrix jitter escalation; NaNs that survive it propagate to the
    outputs instead of crashing mid-pipeline;
  * in-sampler: NUTS counts a non-finite energy as a divergence and HMC
    rejects it (``infer/nuts.py``, ``infer/hmc.py``), so a pathological
    theta poisons one transition, not the chain;
  * post-hoc: :func:`check_result` / :func:`check_samples` turn surviving
    problems into a :class:`HealthReport` (and optionally a
    :class:`SweepHealthError`) instead of silent NaNs downstream;
  * recovery: :func:`resume_state` makes a sampler restart point from the
    last retained draws.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["HealthReport", "SweepHealthError", "check_result",
           "check_samples", "resume_state"]


class SweepHealthError(RuntimeError):
    """Raised by :func:`check_result`/:func:`check_samples` on demand when
    a result fails its health checks; carries the :class:`HealthReport`."""

    def __init__(self, report: "HealthReport"):
        super().__init__(str(report))
        self.report = report


class HealthReport(NamedTuple):
    ok: bool
    #: number of non-finite entries per field ({} when all finite)
    nonfinite: dict
    #: count of (numerically) negative posterior variances below -tol
    negative_var: int
    #: most negative variance observed (0.0 if none)
    min_var: float
    #: sampler divergence rate (divergent transitions / retained draws);
    #: 0.0 when not applicable
    divergence_rate: float = 0.0

    def __str__(self):
        if self.ok:
            return "healthy"
        parts = []
        if self.nonfinite:
            parts.append(f"non-finite entries: {self.nonfinite}")
        if self.negative_var:
            parts.append(
                f"{self.negative_var} negative posterior variances "
                f"(min {self.min_var:.3e})")
        if self.divergence_rate:
            parts.append(f"divergence rate {self.divergence_rate:.3f}")
        return "; ".join(parts)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves_with_path(tree, path=""):
    """``(path, leaf)`` pairs in the order and with the key strings of
    ``jax.tree_util.tree_leaves_with_path`` / ``keystr`` (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_result(result, var_tol: float = 1e-6,
                 raise_on_failure: bool = False) -> HealthReport:
    """Validate a :class:`pymra_torch.tree.sweep.SweepResult`.

    Checks: objective/loglik finite; posterior mean finite; posterior
    variance finite and >= -var_tol (tiny negatives are float round-off of
    the rank-downdate chain; material negatives indicate a broken plan or
    insufficient jitter). Reads the outputs back to the host; call it on
    results you are about to consume, not inside hot loops.
    """
    nonfinite = {}
    for name in ("objective", "loglik", "mean", "var"):
        val = getattr(result, name, None)
        if val is None:
            continue
        bad = int(np.sum(~np.isfinite(_np(val))))
        if bad:
            nonfinite[name] = bad
    neg = 0
    min_var = 0.0
    if getattr(result, "var", None) is not None:
        v = _np(result.var)
        finite = v[np.isfinite(v)]
        if finite.size:
            min_var = float(min(finite.min(), 0.0))
            neg = int(np.sum(finite < -var_tol))
    report = HealthReport(ok=not nonfinite and neg == 0,
                          nonfinite=nonfinite, negative_var=neg,
                          min_var=min_var)
    if raise_on_failure and not report.ok:
        raise SweepHealthError(report)
    return report


def check_samples(samples, divergences=None, max_divergence_rate=0.05,
                  raise_on_failure: bool = False) -> HealthReport:
    """Validate sampler output (a dict of [chains, draws, ...] tensors).

    Non-finite draws indicate an escaped NaN (the samplers' divergence
    handling should make this impossible — treat any hit as a bug); a
    divergence *rate* above ``max_divergence_rate`` flags a mis-adapted
    step size or a pathological posterior.
    """
    nonfinite = {}
    total_bad = 0
    leaves = list(_leaves_with_path(samples))
    for path, leaf in leaves:
        bad = int(np.sum(~np.isfinite(_np(leaf))))
        if bad:
            nonfinite[path] = bad
            total_bad += bad
    div_ok = True
    div_rate = 0.0
    if divergences is not None:
        n_draws = max(int(np.prod(_np(leaves[0][1]).shape[:2])), 1)
        div_rate = float(np.sum(_np(divergences))) / n_draws
        div_ok = div_rate <= max_divergence_rate
    report = HealthReport(ok=not total_bad and div_ok,
                          nonfinite=nonfinite, negative_var=0, min_var=0.0,
                          divergence_rate=div_rate)
    if raise_on_failure and not report.ok:
        raise SweepHealthError(report)
    return report


def resume_state(samples):
    """A restart point from retained draws: the last draw of each chain,
    as ``init_params`` for :func:`pymra_torch.infer.nuts` / ``hmc``.

    The recovery recipe: keep the sampler output; after a failure, rerun
    from ``resume_state(samples)`` with a fresh generator — statistically a
    valid continuation of the chains.
    """
    if isinstance(samples, dict):
        return {k: resume_state(v) for k, v in samples.items()}
    if isinstance(samples, (list, tuple)):
        return type(samples)(resume_state(v) for v in samples)
    return torch.as_tensor(samples)[:, -1, ...]
