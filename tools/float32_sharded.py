#!/usr/bin/env python3
"""The float32 rehearsal of ``chip_smoke.py``'s sharded phases on the CPU:
how far the sharded float32 sweep moves from the serial one when only the
order of the cross-rank sums (and the ranks' batch sizes) differ. It sets
the tolerances written beside ``SHARD_OBJ_RTOL``, ``SHARD_POST_RTOL``,
``SHARD_GRAD_RTOL`` and ``CHAIN_REEVAL_RTOL``.

Phase 20 on a ``side``^2 grid (r=8, the flagship tree's shape; the serial
objective, posterior and gradient from the same float32 kernel structure
on the CPU) over 2 gloo ranks, and phase 20b on the bundled ``--chains``
data over a 2 x 2 chain x data mesh. The phases print the measured
differences beside their limits. Run from the repository root::

    python3 tools/float32_sharded.py --side 128 --chains large

Takes a few minutes on two CPU cores; these are CPU numbers, not device
measurements.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pymra_torch import Kernel, MRAModel, PlanConfig  # noqa: E402
from pymra_torch.tree.plan import tpu_shaped_M  # noqa: E402
from pymra_torch.utils import gen_locations_2d  # noqa: E402


def float64_objective(side: int) -> float:
    """The float64 objective of phase 5's tree at ``side``^2 (phase 20's
    golden at this size)."""
    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    return float(MRAModel(
        locs, r=8, M=tpu_shaped_M(len(locs), 8), dtype=torch.float64,
        config=PlanConfig(r=8, kmeans_impl="native"), device="cpu").objective(
            Kernel("exponential", l=0.05), y.astype(np.float64), 1e-2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--chains", default="large",
                    help="bundled dataset of phase 20b ('' skips it)")
    args = ap.parse_args()

    def no_timer(fn, reps=1):
        fn()
        return float("nan")

    golden = float64_objective(args.side)
    n1m = chip_smoke.phase_n1m("cpu", timer=no_timer, side=args.side,
                               golden=golden, n_evals=1)
    f = n1m["model"].loglik_fn(n1m["y"], 1e-2,
                               kernel_builder=chip_smoke.exponential_builder)
    _, g = chip_smoke.value_and_grad(f, 0.05, 1.0)
    serial = {"ad": {"l": 0.05 * g["l"], "sig": g["sig"]}}
    chip_smoke.phase_sharded(n1m, serial, "cpu", golden=golden, n_evals=1)
    if args.chains:
        chip_smoke.phase_chains({"l": 2.0, "sig": 1.0}, "cpu",
                                data=args.chains,
                                M=4 if args.chains == "large" else -1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
