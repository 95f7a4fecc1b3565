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
"""
from pymra_torch.data.loader import load_data
from pymra_torch.kernels import Kernel
from pymra_torch.tree.model import MRAModel, MRATree
from pymra_torch.tree.plan import PlanConfig, build_plan

__all__ = ["Kernel", "MRAModel", "MRATree", "load_data", "build_plan",
           "PlanConfig"]
