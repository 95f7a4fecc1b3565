"""User-facing model API (counterpart of ``pymra_tpu/tree/model.py``).

:class:`MRAModel` plans once, then evaluates the likelihood / posterior for
any kernel hyper-parameters without re-planning. :class:`MRATree` mirrors
the reference pyMRA constructor and accessors (``MRATree(locs, r, cov, obs,
R, M, J, critDepth)``, ``getLikelihood()``, ``predict()``, ``setPrior``, the
node traversals, the ancestor-basis diagnostics, the basis matrices and the
drawings); ``critDepth`` is accepted and ignored.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pymra_torch.kernels import MatrixKernel
from pymra_torch.tree.plan import PlanConfig, TreePlan, build_plan
from pymra_torch.tree.sweep import (
    DevicePlan,
    SweepResult,
    make_device_plan,
    mra_sweep,
    prepare_obs,
)
from pymra_torch.utils import profiling as _tr

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
      device: where the plan's tensors live and the sweep runs: the card
        unless the caller asks for ``"cpu"``. A CUDA device needs float32
        with jitter > 0; without a GPU it raises.
      index_mode: plan location indices instead of coordinates, for a
        covariance given as a dense matrix
        (:class:`pymra_torch.kernels.MatrixKernel`, the reference's
        matrix-covariance path).
    """

    def __init__(self, locs, r: int, *, M: int = -1, J: int = -1,
                 seed: int = 0, dtype=None, jitter: float | None = None,
                 config: PlanConfig | None = None,
                 plan: TreePlan | None = None, device="cuda",
                 index_mode: bool = False):
        self.device = _device(device)
        if plan is None:
            with _tr.setup_span("pymra.setup.plan"):
                plan = build_plan(locs, r, M=M, J=J, seed=seed,
                                  config=config)
        self.plan = plan
        self.dtype = dtype if dtype is not None else torch.get_default_dtype()
        if jitter is None:
            jitter = 0.0 if self.dtype == torch.float64 else 1e-6
        self.jitter = float(jitter)
        self.index_mode = bool(index_mode)
        with _tr.setup_span("pymra.setup.upload"):
            self.dplan: DevicePlan = make_device_plan(
                plan, dtype=self.dtype, device=self.device,
                index_points=self.index_mode)

    def sweep(self, cov, y, R, compute_posterior: bool = True) -> SweepResult:
        """Run the full batched sweep (likelihood + posterior moments).

        ``R`` is a scalar, an ``[N]`` diagonal or an ``[N, N]`` dense
        measurement-error covariance (a numpy array or a tensor, moved to
        the model's device), honored within each leaf block: the
        reference's slicing of a matrix R to children. The result is
        differentiable: with a kernel whose parameters require gradients,
        ``sweep(...).loglik.backward()`` is the gradient path for a dense
        R (``loglik_fn`` takes a diagonal R only).

        While a ``torch.profiler`` records (or inside
        :func:`pymra_torch.utils.profiling.tracing`) the call is traced:
        the span ``pymra.call`` and the sweep's spans inside it.
        """
        with _tr.facade(self.device):
            if _ndim(R) == 2:
                return mra_sweep(self.dplan, cov, y, None,
                                 compute_posterior=compute_posterior,
                                 jitter=self.jitter, r_dense=R)
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

    def loglik_fn(self, y, R, kernel_builder: Callable | None = None,
                  batched: bool = False) -> Callable:
        """Return ``theta -> loglik`` for gradient-based inference.

        ``kernel_builder(theta)`` maps the parameters (for example a dict
        of 0-dim tensors with ``requires_grad``) to a covariance callable;
        without one ``theta`` is itself the covariance (a :class:`Kernel`,
        whose tensor buffers then receive the gradient). The per-leaf
        observation tensors are prepared once, here
        (:func:`pymra_torch.tree.sweep.prepare_obs`), not per evaluation.

        The tensor values of a dict ``theta`` are copied to the model's
        device (differentiably) before the builder sees them: a 0-dim CPU
        parameter would otherwise send each covariance call's gradient back
        to the host in the backward pass, one synchronization each.

        ``R`` is a scalar or an ``[N]`` diagonal, as the JAX package's
        ``loglik_fn`` takes it; for a dense R differentiate
        ``sweep(...).loglik``.

        ``batched``: ``theta`` holds ``C`` parameter sets (leaves with a
        leading ``[C]`` axis) and the function returns ``[C]``, all sets in
        one sweep (each level's kernels launch once for all of them): the
        port's form of ``jax.vmap(model.loglik_fn(y, R, kernel_builder))``.
        The builder must carry the axis into the covariance (a
        :class:`pymra_torch.kernels.Kernel` built from ``[C]`` leaves); one
        without it (a ``MatrixKernel``) raises.

        Each call is a facade call, traced as :meth:`sweep` is; its
        backward then records ``pymra.bwd``, closed by a marker on the
        parameters of a dict ``theta``.
        """
        if _ndim(R) == 2:
            raise NotImplementedError(
                "loglik_fn takes a scalar or [N] diagonal R (its per-leaf "
                "observation tensors are diagonal, as in the JAX package); "
                "for a dense R differentiate MRAModel.sweep(...).loglik")
        prep = prepare_obs(self.dplan, y, R)

        def fn(theta):
            with _tr.facade(self.device):
                if isinstance(theta, dict):
                    if _tr.ON:
                        # traced: the backward's last boundary, closing it
                        theta = dict(zip(theta, _tr.mark(None,
                                                         *theta.values())))
                    theta = {k: v.to(self.device) if torch.is_tensor(v)
                             else v for k, v in theta.items()}
                cov = kernel_builder(theta) if kernel_builder else theta
                if batched and not getattr(cov, "batch_shape", ()):
                    raise NotImplementedError(
                        f"a batched loglik_fn needs a covariance with a [C] "
                        f"batch of hyper-parameters; {type(cov).__name__} "
                        "has none (a MatrixKernel has no hyper-parameter "
                        "to batch)")
                out = mra_sweep(self.dplan, cov, None, None,
                                compute_posterior=False, jitter=self.jitter,
                                prep=prep).loglik
                if not batched and out.dim():
                    raise ValueError(
                        f"loglik_fn: the covariance carries a batch "
                        f"{tuple(out.shape)} of parameter sets; pass "
                        "batched=True")
                return out

        return fn

    def leaf_sizes(self) -> np.ndarray:
        return self.plan.leaf_sizes()

    def describe(self) -> str:
        return self.plan.describe()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is False (no GPU, or a CPU-only PyTorch); pass device='cpu' to "
            "run on the CPU")
    return dev


def _ndim(R) -> int:
    return R.ndim if isinstance(R, torch.Tensor) else np.ndim(R)


class MRATree:
    """Facade over :class:`MRAModel` mirroring the reference ``MRATree``.

    ``cov`` is a covariance callable or a dense ``[N, N]`` matrix (a numpy
    array or a tensor, moved to the model's device and dtype; the model then
    plans in index mode). ``predict`` returns ``(mean [N, 1], sd [N])`` as
    numpy arrays, the reference's shape asymmetry minus ``np.matrix``.
    """

    def __init__(self, locs, r, cov, obs, R, M=-1, J=-1, critDepth=-1,
                 verbose: bool = False, seed: int = 0, dtype=None,
                 device="cuda"):
        del critDepth, verbose
        matrix_cov = (isinstance(cov, (np.ndarray, torch.Tensor))
                      and cov.ndim == 2)
        self.model = MRAModel(locs, r, M=M, J=J, seed=seed, dtype=dtype,
                              device=device, index_mode=matrix_cov)
        if matrix_cov:
            cov = self._matrix_kernel(cov)
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

    def _matrix_kernel(self, matrix) -> MatrixKernel:
        return MatrixKernel(torch.as_tensor(
            matrix, dtype=self.model.dtype, device=self.model.device))

    def setPrior(self, xF=None, Sigma=None):
        """Replace the covariance with a dense matrix and drop the cached
        result (reference ``setPrior``, whose ``xF`` it ignores too). A
        coordinate model is re-planned in index mode on the same plan."""
        del xF
        if not self.model.index_mode:
            m = self.model
            self.model = MRAModel(m.plan.locs, self.r, plan=m.plan,
                                  dtype=m.dtype, jitter=m.jitter,
                                  device=m.device, index_mode=True)
        self.cov = self._matrix_kernel(Sigma)
        self._result = None

    # -- tree traversal (reference MRATree.py:101-132) ----------------------

    def getNodesBFS(self, groupByResolution: bool = False):
        """Host node records in BFS order (the whole tree: unlike the
        reference's, it is not destroyed while it is built)."""
        per_level = self.model.plan.nodes
        if groupByResolution:
            return [list(nodes) for nodes in per_level if nodes]
        return [nd for nodes in per_level for nd in nodes]

    def getNodesDFS(self):
        out = []

        def visit(nd):
            out.append(nd)
            for ch in nd.children:
                visit(ch)

        visit(self.model.plan.nodes[0][0])
        return out

    # -- ancestor-basis diagnostics (reference MRATree.py:359-430) ----------

    def _node_by_id(self, node_id: str):
        if not node_id or node_id[0] != "r":
            raise ValueError(f"node IDs start with 'r', got {node_id!r}")
        node = self.model.plan.nodes[0][0]
        for ch in node_id[1:]:
            j = int(ch) - 1
            if j < 0 or j >= len(node.children):
                raise KeyError(f"no child {ch} under node {node.node_id!r}")
            node = node.children[j]
        return node

    def getKNode(self, callerID: str, k: int):
        """The resolution-``k`` ancestor on the path to ``callerID``
        (reference ``getKNode``)."""
        return self._node_by_id(callerID[: k + 1])

    def getB_lk(self, callerID: str, k: int, l: int | None = None):
        """Rows of ancestor ``k``'s prior basis matrix restricted to the
        resolution-``l`` node on the caller's path (reference ``getB_lk``),
        as a numpy array.

        The conditional cross-covariance ``Sigma_k(X_l, Q_k)`` between the
        l-node's locations and the k-ancestor's knots given the knots of
        the resolutions below ``k``: sequential conditioning on nested knot
        sets is joint conditioning, so this is one dense solve against the
        joint ancestor-knot covariance, on the model's device.
        """
        model = self.model
        node_l = self._node_by_id(callerID if l is None
                                  else callerID[: l + 1])
        node_k = self.getKNode(callerID, k)

        def pts(gidx):
            if model.index_mode:
                return torch.as_tensor(np.asarray(gidx), dtype=torch.long,
                                       device=model.device)[:, None]
            return torch.as_tensor(model.plan.locs[gidx], dtype=model.dtype,
                                   device=model.device)

        X = pts(node_l.loc_gidx)
        Qk = pts(node_k.knot_gidx)
        B = self.cov(X, Qk)
        anc_gidx = []
        cur = node_k.parent
        while cur is not None:
            anc_gidx.append(cur.knot_gidx)
            cur = cur.parent
        if anc_gidx:
            Qa = pts(np.concatenate(anc_gidx[::-1]))
            Kaa = self.cov(Qa, Qa)
            eye = torch.eye(Kaa.shape[0], dtype=Kaa.dtype, device=Kaa.device)
            B = B - self.cov(X, Qa) @ torch.linalg.solve(
                Kaa + 1e-12 * eye, self.cov(Qa, Qk))
        return B.detach().cpu().numpy()

    # -- basis matrix and drawings (reference MRATree.py:161-352, 445-511) --

    def getBasisFunctionsMatrix(self, distr: str = "prior",
                                groupByResolution: bool = False,
                                order: str = "root", timesKC: bool = False):
        from pymra_torch.tree.basis import basis_matrix

        y = self.obs if distr == "posterior" else None
        return basis_matrix(
            self.model, self.cov, y=y, R=self.R, distr=distr,
            group_by_resolution=groupByResolution, order=order,
            times_kc=timesKC)

    def drawKnots(self, fname=None, show=False):
        from pymra_torch.utils import viz

        return viz.draw_knots(self.model, fname=fname, show=show)

    def drawBMatrix(self, distr="prior", fname=None, show=False):
        from pymra_torch.utils import viz

        return viz.draw_b_matrix(self.model, self.cov, y=self.obs, R=self.R,
                                 distr=distr, fname=fname, show=show)

    def drawSparsityPat(self, distr="prior", fname=None, show=False):
        from pymra_torch.utils import viz

        return viz.draw_sparsity_pattern(self.model, self.cov, y=self.obs,
                                         R=self.R, distr=distr, fname=fname,
                                         show=show)

    def drawBasisFunctions(self, distr="prior", fname=None, show=False):
        from pymra_torch.utils import viz

        return viz.draw_basis_functions(self.model, self.cov, y=self.obs,
                                        R=self.R, distr=distr, fname=fname,
                                        show=show)

    def drawGridAndObs(self, fname=None, show=False):
        from pymra_torch.utils import viz

        return viz.draw_grid_and_obs(self.model, self.obs, fname=fname,
                                     show=show)
