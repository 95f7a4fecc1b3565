#!/usr/bin/env python3
"""Float64 golden objective and gradient of the N=10^4 tree cut at M=3,
whose 64 leaves hold 169 locations each (wider than one 64-wide kernel
block), from the JAX package.

The recipe behind ``chip_smoke.py``'s ``GOLDEN_WIDE_N10K``: bundled
``large`` data, r=4, M=3 (native k-means planner), exponential kernel at
l=2, sig=1, R=1e-2, float64 on the CPU with jitter 0, and ``jax.grad`` of
``MRAModel.loglik_fn`` with respect to ``l`` and ``sig``. R is 1e-2, not
the bench tree's 1e-4: at 1e-4 the leaves' float32 posterior blocks
(``K_leaf + A_oo``, A ~ 1/R) fail every jitter factor in the JAX package
and the port alike, and at 1e-3 the escalated jitter biases the float32
objective well past the 2e-3 the check allows. Run from the repository
root::

    JAX_PLATFORMS=cpu python3 tools/golden_wide_leaves_n10k.py

It prints the widest leaf, the loglik, its objective and both partial
derivatives with full precision.
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
    model = MRAModel(locs, r=4, M=3, dtype=jnp.float64,
                     config=PlanConfig(r=4, kmeans_impl="native"))
    assert model.jitter == 0.0
    print("leaf widths", sorted({lvl.leaf_locs.shape[1]
                                 for lvl in model.dplan.levels
                                 if lvl.leaf_locs.shape[0]}))
    f = model.loglik_fn(np.asarray(y_obs, dtype=np.float64), 1e-2,
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
