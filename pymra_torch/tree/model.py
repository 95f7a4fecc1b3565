"""User-facing model API (counterpart of ``pymra_tpu/tree/model.py``).

:class:`MRAModel` plans once, then evaluates the likelihood / posterior for
any kernel hyper-parameters without re-planning. :class:`MRATree` mirrors
the reference pyMRA constructor and accessors (``MRATree(locs, r, cov, obs,
R, M, J, critDepth)``, ``getLikelihood()``, ``predict()``); ``critDepth`` is
accepted and ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from pymra_torch.tree.plan import PlanConfig, TreePlan, build_plan
from pymra_torch.tree.sweep import (
    DevicePlan,
    SweepResult,
    make_device_plan,
    mra_sweep,
)

__all__ = ["MRAModel", "MRATree"]


class MRAModel:
    """A planned MRA model over a fixed set of locations.

    Args:
      locs: ``[N, d]`` locations (1-D inputs may be ``[N]``).
      r: knots per interior node.
      M, J: resolutions / branching factor; defaults derived as in the
        reference.
      dtype: tensor dtype; ``None`` takes ``torch.get_default_dtype()``.
      jitter: Cholesky diagonal regularization; ``None`` selects 0 for
        float64 and 1e-6 for float32.
      seed / config: planner determinism and thresholds (:class:`PlanConfig`).
      device: where the plan's tensors live and the sweep runs. A CUDA
        device needs float32 with jitter > 0.
    """

    def __init__(self, locs, r: int, *, M: int = -1, J: int = -1,
                 seed: int = 0, dtype=None, jitter: float | None = None,
                 config: PlanConfig | None = None,
                 plan: TreePlan | None = None, device="cpu"):
        if plan is None:
            plan = build_plan(locs, r, M=M, J=J, seed=seed, config=config)
        self.plan = plan
        self.dtype = dtype if dtype is not None else torch.get_default_dtype()
        if jitter is None:
            jitter = 0.0 if self.dtype == torch.float64 else 1e-6
        self.jitter = float(jitter)
        self.device = torch.device(device)
        self.dplan: DevicePlan = make_device_plan(plan, dtype=self.dtype,
                                                  device=self.device)

    def sweep(self, cov, y, R, compute_posterior: bool = True) -> SweepResult:
        """Run the full batched sweep (likelihood + posterior moments).
        ``R`` is a scalar or an ``[N]`` diagonal measurement-error
        variance."""
        if torch.as_tensor(R).ndim == 2:
            raise NotImplementedError(
                "dense measurement error R is a sweep side path still to be "
                "ported (ROADMAP queue 1)")
        return mra_sweep(self.dplan, cov, y, R,
                         compute_posterior=compute_posterior,
                         jitter=self.jitter)

    def objective(self, cov, y, R) -> torch.Tensor:
        """The reference's ``getLikelihood()`` value: ``logdet + quadratic``
        minimization objective (= -2 loglik - n_obs log 2pi)."""
        return self.sweep(cov, y, R, compute_posterior=False).objective

    def loglik(self, cov, y, R) -> torch.Tensor:
        """Proper marginal log-density of the observed data."""
        return self.sweep(cov, y, R, compute_posterior=False).loglik

    def posterior(self, cov, y, R):
        """Posterior mean and pointwise sd at every location."""
        res = self.sweep(cov, y, R, compute_posterior=True)
        return res.mean, torch.sqrt(torch.clamp(res.var, min=0.0))

    def leaf_sizes(self) -> np.ndarray:
        return self.plan.leaf_sizes()

    def describe(self) -> str:
        return self.plan.describe()


class MRATree:
    """Facade over :class:`MRAModel` mirroring the reference ``MRATree``.

    ``predict`` returns ``(mean [N, 1], sd [N])`` as numpy arrays, the
    reference's shape asymmetry minus ``np.matrix``.
    """

    def __init__(self, locs, r, cov, obs, R, M=-1, J=-1, critDepth=-1,
                 verbose: bool = False, seed: int = 0, dtype=None,
                 device="cpu"):
        del critDepth, verbose
        if isinstance(cov, (np.ndarray, torch.Tensor)) and np.ndim(cov) == 2:
            raise NotImplementedError(
                "dense-matrix covariances (MatrixKernel) are a sweep side "
                "path still to be ported (ROADMAP queue 1)")
        self.model = MRAModel(locs, r, M=M, J=J, seed=seed, dtype=dtype,
                              device=device)
        self.cov = cov
        self.obs = np.asarray(obs, dtype=np.float64).ravel()
        self.R = R
        self._result: SweepResult | None = None

    @property
    def M(self):
        return self.model.plan.M

    @property
    def J(self):
        return self.model.plan.J

    @property
    def r(self):
        return self.model.plan.r

    def _compute(self) -> SweepResult:
        if self._result is None:
            self._result = self.model.sweep(self.cov, self.obs, self.R)
        return self._result

    def getLikelihood(self) -> float:
        """Reference semantics: ``logdet(Sigma_y) + y^T Sigma_y^{-1} y`` —
        a minimization objective, not a log-pdf."""
        return float(self._compute().objective)

    def getLogLik(self) -> float:
        """The actual marginal log-likelihood."""
        return float(self._compute().loglik)

    def predict(self):
        res = self._compute()
        mean = res.mean.detach().cpu().numpy().reshape(-1, 1)
        sd = np.sqrt(np.maximum(res.var.detach().cpu().numpy(), 0.0))
        return mean, sd

    # -- leaf telemetry (reference MRATree.py:136-157) ----------------------

    def avgLeafSize(self) -> float:
        return float(self.model.leaf_sizes().mean())

    def minLeaf(self) -> int:
        return int(self.model.leaf_sizes().min())

    def maxLeaf(self) -> int:
        return int(self.model.leaf_sizes().max())
