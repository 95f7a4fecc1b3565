"""How far a batch of parameter sets moves each set's float32 objective on
the card, against the same set alone, against itself repeated, and against
float64: the evidence for the limits of ``chip_smoke.py`` phase 13f.

On phase 4's N=10^4 tree (bundled ``large``, r=4, M=4) at each ``--R``,
for the sets of ``chip_smoke.POST_BATCH_N10K``, it prints each set's
float64 objective (the port's plain structure on the host's CPU, jitter
0: the goldens' arithmetic) and, in float32 on ``--device``:

* the set alone, twice (is one evaluation repeatable?);
* the C sets batched through one sweep;
* C copies of the set batched (does the batch's size alone move it?);
* members of the jittered factorizations that escalated (K2's and K1's
  factor above 1) in the single and the batched sweep;
* the posterior mean and var, batched against alone and each against
  float64, max |diff| relative to the set's largest magnitude;
* with ``--dense``, phase 10's correlated R: loglik and gradient in (l,
  sig) of each set alone, batched and in float64.

::

    python3 tools/batch_rounding.py --R 1e-4 1e-2 --dense   # on the card
    python3 tools/batch_rounding.py --device cpu --data small --M -1

The posterior runs too (the sweep's default), as in phase 13f.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pymra_torch import Kernel, MRAModel, PlanConfig, load_data  # noqa: E402
from pymra_torch.tree import sweep  # noqa: E402


def escalation_counter():
    """Wrap the sweep's K2 and K1 calls to count members whose factor
    escalated above 1; returns the running count (a one-entry list)."""
    count = [0]
    real_chol, real_leaf = sweep.cholesky_jittered, sweep.leaf_factor

    def chol(*a, **k):
        out = real_chol(*a, **k)
        count[0] += int((out[2] > 1).sum())
        return out

    def leaf(*a, **k):
        out = real_leaf(*a, **k)
        count[0] += int((out[3] > 1).sum()) + int((out[4] > 1).sum())
        return out

    sweep.cholesky_jittered, sweep.leaf_factor = chol, leaf
    return count


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--R", type=float, nargs="+", default=[1e-4, 1e-2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default="large")
    ap.add_argument("--M", type=int, default=4)
    ap.add_argument("--dense", action="store_true",
                    help="also phase 10's correlated R (value and gradient)")
    args = ap.parse_args()
    if args.device == "cuda":
        chip_smoke.phase_device()
    sets = chip_smoke.POST_BATCH_N10K
    C = len(sets["l"])
    locs, y_obs = load_data(args.data)
    model = MRAModel(locs, r=4, M=args.M, dtype=torch.float32,
                     config=PlanConfig(r=4, kmeans_impl="native"),
                     device=args.device)
    exact = MRAModel(locs, r=4, plan=model.plan, dtype=torch.float64,
                     device="cpu")
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=args.device)
    escalated = escalation_counter()

    def objective(cov, R):
        before = escalated[0]
        res = model.sweep(cov, y, R)
        out = res.objective.detach().cpu().double()
        objective.last = chip_smoke._host(res)
        return out.numpy(), escalated[0] - before

    def off(a, b):
        """max |a - b| over the largest |b|, per moment."""
        return {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                for k in ("mean", "var")}

    for R in args.R:
        exact_res = [exact.sweep(Kernel("exponential", l=sets["l"][c],
                                        sig=sets["sig"][c]), y_obs, R)
                     for c in range(C)]
        f64 = [float(r.objective) for r in exact_res]
        batch, esc_batch = objective(chip_smoke.batched_kernel(sets), R)
        batch_post = objective.last
        print(f"R={R}: {C} sets batched, {esc_batch} escalated members")
        for c in range(C):
            one = Kernel("exponential", l=sets["l"][c], sig=sets["sig"][c])
            (a, esc_one) = objective(one, R)
            post = objective.last
            b, _ = objective(one, R)
            mine = {k: v[c] for k, v in batch_post.items()}
            f64_post = chip_smoke._host(exact_res[c])
            copies, _ = objective(chip_smoke.batched_kernel(
                {k: (v[c],) * C for k, v in sets.items()}), R)

            def rel(x):
                return abs(float(x) - f64[c]) / abs(f64[c])

            print(f"R={R} set {c} (l={sets['l'][c]}, sig={sets['sig'][c]}):"
                  f" float64 {f64[c]!r}; alone {float(a)!r} ({rel(a):.3g} "
                  f"from float64, {esc_one} escalated), again {float(b)!r} "
                  f"(alone twice equal: {float(a) == float(b)}); batched "
                  f"{float(batch[c])!r} ({rel(batch[c]):.3g} from float64, "
                  f"{abs(float(batch[c]) - float(a)) / abs(float(a)):.3g} "
                  f"from alone); {C} copies batched "
                  f"{[float(v) for v in copies]} (max "
                  f"{max(abs(float(v) - float(a)) for v in copies) / abs(float(a)):.3g}"
                  f" from alone); posterior batched against alone "
                  f"{off(mine, post)}, alone against float64 "
                  f"{off(post, f64_post)}, batched against float64 "
                  f"{off(mine, f64_post)}")
    if args.dense:
        dense(model, exact, locs, y, y_obs, sets)
    return 0


def dense(model, exact, locs, y, y_obs, sets):
    """Phase 10's correlated R: each set's loglik and gradient alone,
    batched and in float64 (the same float32-rounded R)."""
    C = len(sets["l"])
    R = chip_smoke.correlated_r(locs, model.device)
    R64 = R.detach().to("cpu", torch.float64)
    batch = chip_smoke.sweep_value_and_grad(model, y, R, list(sets["l"]),
                                            list(sets["sig"]))
    for c in range(C):
        l, sig = sets["l"][c], sets["sig"][c]
        one = chip_smoke.sweep_value_and_grad(model, y, R, l, sig)
        again = chip_smoke.sweep_value_and_grad(model, y, R, l, sig)
        f64 = chip_smoke.sweep_value_and_grad(exact, y_obs, R64, l, sig)

        def rel(x, k):
            return abs(x - f64[k]) / abs(f64[k])

        for k in ("loglik", "l", "sig"):
            print(f"dense R set {c} (l={l}, sig={sig}) {k}: float64 "
                  f"{f64[k]!r}; alone {one[k]!r} ({rel(one[k], k):.3g} from "
                  f"float64; again equal: {one[k] == again[k]}); batched "
                  f"{batch[k][c]!r} ({rel(batch[k][c], k):.3g} from float64, "
                  f"{abs(batch[k][c] - one[k]) / abs(one[k]):.3g} from alone)")


if __name__ == "__main__":
    sys.exit(main())
