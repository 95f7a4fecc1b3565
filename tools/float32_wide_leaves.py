#!/usr/bin/env python3
"""How rough the float32 loglik of wide leaves is: the port's float32
kernel structure against its float64 plain structure (same jitter) on a
``side``^2 grid cut to the corner ``[0, frac)^2``, exponential kernel,
R=1e-2, 10% missing (the data of ``chip_smoke.py``'s N=10^6 phases).

For float64, float32 as shipped, and float32 with the blocked Cholesky's
panel and trailing products kept in float32 (the JAX package's arithmetic;
the port carries them in float64) it prints the loglik and, for each of
``l`` and ``sig``, the autograd partial (in log-parameter) and the
five-point difference of the loglik at step 0.1, with their relative
errors against the float64 autograd partials. Run on the CPU from the
repository root, for example (62500 points at the N=10^6 grid's spacing,
M=4: 256 leaves of 256)::

    python3 tools/float32_wide_leaves.py --side 1000 --frac 0.25 --M 4

Takes a minute or two at that size.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pymra_torch import MRAModel, PlanConfig  # noqa: E402
from pymra_torch.ops import linalg as tl  # noqa: E402
from pymra_torch.utils import gen_locations_2d  # noqa: E402


def blocked_float32(mat, block, chol, tri_inv):
    """``ops.linalg._blocked`` with its products in the input's dtype."""
    p = mat.shape[-1]
    if p <= block:
        return chol(mat.contiguous())
    a, cols = mat, []
    for j0 in range(0, p, block):
        b = min(block, p - j0)
        l11 = chol(a[..., :b, :b].contiguous())
        if j0 + b < p:
            l21 = a[..., b:, :b] @ tri_inv(l11).transpose(-1, -2)
            a = a[..., b:, b:] - l21 @ l21.transpose(-1, -2)
            l11 = torch.cat([l11, l21], dim=-2)
        cols.append(torch.cat([l11.new_zeros(mat.shape[:-2] + (j0, b)),
                               l11], dim=-2))
    return torch.cat(cols, dim=-1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=1000)
    ap.add_argument("--frac", type=float, default=0.25)
    ap.add_argument("--M", type=int, default=4)
    ap.add_argument("--l", type=float, default=0.05)
    args = ap.parse_args()
    locs = gen_locations_2d(args.side)
    locs = locs[(locs[:, 0] < args.frac) & (locs[:, 1] < args.frac)]
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    shipped = tl._blocked
    ref = None
    for tag, dt, blocked in (("float64", torch.float64, shipped),
                             ("float32", torch.float32, shipped),
                             ("float32, float32 blocked products",
                              torch.float32, blocked_float32)):
        tl._blocked = blocked
        model = MRAModel(locs, r=8, M=args.M, dtype=dt, jitter=1e-6,
                         device="cpu",
                         config=PlanConfig(r=8, kmeans_impl="native"))
        widths = {tuple(lvl.leaf_locs.shape[:2]) for lvl in
                  model.dplan.levels if lvl.leaf_locs.shape[0]}
        f = model.loglik_fn(torch.as_tensor(y, dtype=dt), 1e-2,
                            kernel_builder=chip_smoke.exponential_builder)
        value, grad = chip_smoke.value_and_grad(f, args.l, 1.0)
        ad = {"l": args.l * grad["l"], "sig": grad["sig"]}

        def loglik(l, sig):
            with torch.no_grad():
                return float(f({"l": torch.tensor(l, dtype=torch.float64),
                                "sig": torch.tensor(sig,
                                                    dtype=torch.float64)}))

        fd = {"l": chip_smoke.five_point(
                  lambda t: loglik(args.l * np.exp(t), 1.0), 0.1),
              "sig": chip_smoke.five_point(
                  lambda t: loglik(args.l, np.exp(t)), 0.1)}
        if ref is None:
            ref = value, ad
        print(f"{tag}: N={len(locs)} leaves {sorted(widths)} loglik "
              f"{value!r} (rel err {(value - ref[0]) / abs(ref[0]):.3e})")
        for k in ("l", "sig"):
            want = ref[1][k]
            print(f"  dlog {k}: autograd {ad[k]!r} (rel err "
                  f"{(ad[k] - want) / abs(want):.3e}), five-point "
                  f"{fd[k]!r} (rel err {(fd[k] - want) / abs(want):.3e}); "
                  f"autograd vs five-point {(ad[k] - fd[k]) / abs(fd[k]):.3e}")
    tl._blocked = shipped


if __name__ == "__main__":
    main()
