#!/usr/bin/env python3
"""Float64 golden objective and gradient of the N=10^4 tree under a
general-smoothness Matern covariance, from the JAX package.

The recipe behind ``chip_smoke.py``'s ``GOLDEN_MATERN_N10K``: bundled
``large`` data, r=4, M=4 (native k-means planner), the Matern kernel at
nu=0.8, l=2, sig=1 (its Bessel K by ``pymra_tpu/ops/special.py``), float64
on the CPU with jitter 0; ``jax.value_and_grad`` of ``MRAModel.loglik_fn``
with respect to ``l`` and ``sig``, at each measurement error R given
(default 1e-4 and 1e-2). Run from the repository root (a few minutes)::

    JAX_PLATFORMS=cpu python3 tools/golden_matern_n10k.py [R ...]

It prints, per R, the loglik, its objective and both partial derivatives
with full precision.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pymra_tpu.data.loader import load_data  # noqa: E402
from pymra_tpu.kernels import Kernel  # noqa: E402
from pymra_tpu.tree.model import MRAModel  # noqa: E402
from pymra_tpu.tree.plan import PlanConfig  # noqa: E402

NU = 0.8


def main(rs):
    locs, y_obs = load_data("large")
    locs = np.asarray(locs, dtype=np.float64)
    model = MRAModel(locs, r=4, M=4, dtype=jnp.float64,
                     config=PlanConfig(r=4, kmeans_impl="native"))
    assert model.jitter == 0.0
    y = np.asarray(y_obs, dtype=np.float64)
    n_obs = int(np.isfinite(y).sum())
    for R in rs:
        f = model.loglik_fn(y, R, kernel_builder=lambda th: Kernel(
            "matern", l=th["l"], sig=th["sig"], nu=NU))
        value, grad = jax.jit(jax.value_and_grad(f))(
            {"l": jnp.float64(2.0), "sig": jnp.float64(1.0)})
        objective = -2.0 * float(value) - n_obs * float(np.log(2.0 * np.pi))
        print(f"R={R!r} nu={NU}")
        print(f"  loglik {float(value)!r}")
        print(f"  objective {objective!r}")
        print(f"  dloglik/dl {float(grad['l'])!r}")
        print(f"  dloglik/dsig {float(grad['sig'])!r}")


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or [1e-4, 1e-2])
