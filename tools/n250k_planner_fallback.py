#!/usr/bin/env python3
"""The N=250k golden tree's objective with and without the JAX package's
native planner.

``tests/test_golden_anchors.py::test_250k_objective_and_posterior`` plans a
500^2 grid with ``kmeans_impl="native"``. When the JAX package's binding
to ``csrc/planner.cpp`` fails to load (its build writes the library in
place, so a parallel test worker can load a half-written file), the binding
gives up for the rest of the process and the planner silently falls back to
the numpy Lloyd, which plans another tree with another objective. This
prints both objectives (float64, the JAX package on the CPU)::

    python3 tools/n250k_planner_fallback.py

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

from pymra_tpu import Kernel  # noqa: E402
from pymra_tpu.ops import native  # noqa: E402
from pymra_tpu.tree.model import MRAModel  # noqa: E402
from pymra_tpu.tree.plan import PlanConfig  # noqa: E402
from pymra_tpu.utils.locations import gen_locations_2d  # noqa: E402


def objective() -> float:
    locs = gen_locations_2d(500)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > 0.9] = np.nan
    model = MRAModel(locs, r=8, dtype=jnp.float64,
                     config=PlanConfig(r=8, kmeans_impl="native"))
    return float(model.sweep(Kernel("exponential", l=0.05), y, 1e-2,
                             compute_posterior=False).objective)


def main():
    print(f"native planner loaded: {native.available()}; objective "
          f"{objective():.6f}")
    # what the binding does after one failed load: no library, no retry
    native._LIB, native._TRIED = None, True
    print(f"native planner loaded: {native.available()}; objective "
          f"{objective():.6f} (the numpy Lloyd)")


if __name__ == "__main__":
    main()
