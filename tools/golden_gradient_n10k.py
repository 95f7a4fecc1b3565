#!/usr/bin/env python3
"""Float64 golden gradient of the N=10^4 bench tree, from the JAX package.

The recipe behind ``chip_smoke.py``'s ``GOLDEN_GRAD_N10K``: bundled
``large`` data, r=4, M=4 (native k-means planner), exponential kernel at
l=2, sig=1, R=1e-4, float64 on the CPU with jitter 0 — the configuration
of ``bench.py``'s ``GOLDEN_N10K_OBJECTIVE`` — and ``jax.grad`` of
``MRAModel.loglik_fn`` with respect to ``l`` and ``sig``. Run from the
repository root::

    JAX_PLATFORMS=cpu python3 tools/golden_gradient_n10k.py

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


def main():
    locs, y_obs = load_data("large")
    model = MRAModel(locs, r=4, M=4, dtype=jnp.float64,
                     config=PlanConfig(r=4, kmeans_impl="native"))
    assert model.jitter == 0.0
    f = model.loglik_fn(np.asarray(y_obs, dtype=np.float64), 1e-4,
                        kernel_builder=lambda th: Kernel(
                            "exponential", l=th["l"], sig=th["sig"]))
    value, grad = jax.value_and_grad(f)({"l": jnp.float64(2.0),
                                         "sig": jnp.float64(1.0)})
    n_obs = int(np.isfinite(y_obs).sum())
    objective = -2.0 * float(value) - n_obs * np.log(2.0 * np.pi)
    print(f"loglik {float(value)!r}")
    print(f"objective {objective!r}")
    print(f"dloglik/dl {float(grad['l'])!r}")
    print(f"dloglik/dsig {float(grad['sig'])!r}")


if __name__ == "__main__":
    main()
