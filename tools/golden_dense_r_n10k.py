#!/usr/bin/env python3
"""Float64 golden objective and gradient of the N=10^4 tree under a
correlated (dense) measurement-error covariance, from the JAX package.

The recipe behind ``chip_smoke.py``'s ``GOLDEN_DENSE_R_N10K``: bundled
``large`` data, r=4, M=4 (native k-means planner), exponential kernel at
l=2, sig=1, and ``R_ij = 1e-4 exp(-|s_i - s_j| / rho)`` with ``rho`` one
grid spacing of ``large`` (1/99), float64 on the CPU with jitter 0;
``jax.value_and_grad`` of ``MRAModel.sweep(...).loglik`` with respect to
``l`` and ``sig``. Run from the repository root (about a minute, 2 GB)::

    JAX_PLATFORMS=cpu python3 tools/golden_dense_r_n10k.py

It prints the loglik, its objective and both partial derivatives with
full precision.
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

#: measurement-error scale and correlation length (one grid spacing)
R_SCALE, RHO = 1e-4, 1.0 / 99.0


def correlated_r(locs):
    d = np.sqrt(((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1))
    return R_SCALE * np.exp(-d / RHO)


def main():
    locs, y_obs = load_data("large")
    locs = np.asarray(locs, dtype=np.float64)
    model = MRAModel(locs, r=4, M=4, dtype=jnp.float64,
                     config=PlanConfig(r=4, kmeans_impl="native"))
    assert model.jitter == 0.0
    y = np.asarray(y_obs, dtype=np.float64)
    R = jnp.asarray(correlated_r(locs))

    def loglik(th):
        return model.sweep(Kernel("exponential", l=th["l"], sig=th["sig"]),
                           y, R, compute_posterior=False).loglik

    value, grad = jax.value_and_grad(loglik)({"l": jnp.float64(2.0),
                                              "sig": jnp.float64(1.0)})
    n_obs = int(np.isfinite(y).sum())
    objective = -2.0 * float(value) - n_obs * np.log(2.0 * np.pi)
    print(f"loglik {float(value)!r}")
    print(f"objective {objective!r}")
    print(f"dloglik/dl {float(grad['l'])!r}")
    print(f"dloglik/dsig {float(grad['sig'])!r}")


if __name__ == "__main__":
    main()
