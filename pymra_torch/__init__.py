"""pymra-torch: the MRA framework on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

The port of ``pymra_tpu`` (JAX/Pallas on TPU), which stays in the repository
as the reference. This package imports ``torch`` and numpy only — never JAX
or ``pymra_tpu``. Module names mirror the JAX package's::

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data

    locs, y_obs = load_data("large")
    model = MRAModel(locs, r=4, M=4, dtype=torch.float32, device="cuda",
                     config=PlanConfig(r=4, kmeans_impl="native"))
    res = model.sweep(Kernel("exponential", l=2.0), y_obs, 1e-4)

    # maximum likelihood through the gradient path
    f = model.loglik_fn(y_obs, 1e-4, kernel_builder=lambda th: Kernel(
        "exponential", l=th["l"], sig=th["sig"]))
    fit_mle(f, {"l": 2.0, "sig": 1.0}, method="lbfgs", steps=20)

    # posterior draws of the log-parameters, 4 chains (flat prior)
    def logp(th):
        return f({"l": th["log_l"].exp(), "sig": th["log_sig"].exp()})

    nuts(logp, {"log_l": torch.zeros(4), "log_sig": torch.zeros(4)},
         torch.Generator().manual_seed(0), num_warmup=100, num_samples=100)

    # a dense covariance matrix, the reference's matrix path
    tree = MRATree(locs, 4, Sigma, y_obs, 1e-4)   # Sigma: [N, N]
    tree.getLikelihood(); tree.getBasisFunctionsMatrix("posterior")

    # the leaves (and the fine interior levels) split over the ranks of a
    # mesh axis, one process per rank (torchrun, or spawned)
    from pymra_torch.parallel import make_mesh, sharded_loglik_fn
    mesh = make_mesh({"data": 4})          # NCCL on CUDA
    f = sharded_loglik_fn(model.dplan, y_obs, 1e-4, mesh, jitter=1e-6,
                          kernel_builder=...)

Entry points run on the card unless the caller passes ``device="cpu"``
(``device_type="cpu"`` for a mesh).
"""
from pymra_torch import parallel, utils
from pymra_torch.data.loader import load_data
from pymra_torch.infer import advi, ess, fit_mle, hmc, nuts, smc, split_rhat
from pymra_torch.kernels import Kernel, MatrixKernel
from pymra_torch.ops.special import kv_frac, matern_general
from pymra_torch.tree.basis import basis_matrix
from pymra_torch.tree.model import MRAModel, MRATree
from pymra_torch.tree.plan import PlanConfig, build_plan

__all__ = ["Kernel", "MatrixKernel", "MRAModel", "MRATree", "load_data",
           "build_plan", "PlanConfig", "basis_matrix", "kv_frac",
           "matern_general", "fit_mle", "hmc", "nuts", "advi", "smc",
           "split_rhat", "ess", "parallel", "utils"]
