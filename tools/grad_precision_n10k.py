#!/usr/bin/env python3
"""Where the float32 gradient of the N=10^4 bench tree loses precision.

Evaluates ``MRAModel.loglik_fn``'s value and gradient (exponential l=2,
sig=1, R=1e-4, bundled ``large``, r=4, M=4) with stages of the kernel
structure swapped between float32 and float64, and prints each variant's
relative error against the float64 golden gradient
(``tools/golden_gradient_n10k.py``) and against the same sweep in float64
with the float32 path's jitter (1e-6):

* ``f32 kernels``: the main path (float32, CUDA kernels on the card);
* ``f32 twins``: the same with every kernel replaced by its plain twin;
* ``f64 twins``: the kernel structure in float64 (twins), jitter 1e-6;
* ``f64, leaf f32`` / ``f64, chol f32``: the float64 sweep with only the
  leaf stage (K1 forward, K3/K4 backward) or only the jittered interior
  factorizations (K2 forward, K5 backward) in float32;
* ``f32, leaf f64``: the float32 sweep with the leaf stage in float64;
* ``f32, cov f64``: the float32 sweep with the covariance evaluated in
  float64 and rounded once to float32, so that its backward (and the
  reduction of every entry's cotangent into the 0-dim ``l`` and ``sig``)
  runs in float64;
* ``f64, leaf fwd f32 bwd f64`` / ``f64, leaf fwd f64 bwd f32``: the
  float64 sweep with the leaf stage's forward and backward in different
  types (what one saves for the other is rounded to its type);
* ``..., posterior f32``: those with the leaf backward's posterior
  pullback (``_leaf_posterior_pullback``) computed in float32 instead of
  float64, as it was before it was found to lose the gradient.

Run from the repository root (``--device cpu`` without a GPU)::

    python3 tools/grad_precision_n10k.py [--device cuda]

This is a diagnostic: on the card its float64 and twin variants run the
plain twins on CUDA tensors, which the main path never does.
"""
import argparse
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from chip_smoke import GOLDEN_GRAD_N10K, exponential_builder  # noqa: E402
from pymra_torch import MRAModel, PlanConfig, load_data  # noqa: E402
from pymra_torch.ops import linalg as tl  # noqa: E402
from pymra_torch.tree import sweep  # noqa: E402

F32, F64 = torch.float32, torch.float64
#: kernel launch of every wrapper and the twin that replaces it
TWINS = {"_cholesky_fwd": "cholesky_ref",
         "_tri_inv_fwd": "triangular_inverse_lower_ref",
         "_tri_solve_fwd": "solve_triangular_batched_ref",
         "_cholesky_jittered_fwd": "cholesky_jittered_ref",
         "_leaf_factor_fwd": "leaf_factor_ref"}


def cast_stage(fn, dtype):
    """``fn`` run in ``dtype``: inputs cast in, outputs cast back to the
    caller's type (autograd flows through both casts)."""
    def run(*args):
        back = args[0].dtype
        cast = [a.to(dtype) if torch.is_tensor(a) else a for a in args]
        return tuple(o.to(back) for o in fn(*cast))
    return run


class SplitLeaf(torch.autograd.Function):
    """The leaf stage with its forward in ``fwd_dtype`` (``fwd`` launches
    it) and its backward, ``_LeafFactor``'s, in ``bwd_dtype``."""

    @staticmethod
    def forward(ctx, c, k, a, jitter, fwd, fwd_dtype, bwd_dtype):
        out = fwd(c.to(fwd_dtype), k.to(fwd_dtype), a.to(fwd_dtype), jitter,
                  tl.FACTORS)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(c, k, out[0], out[3], out[4])
        ctx.jitter, ctx.bwd_dtype = jitter, bwd_dtype
        return tuple(o.to(c.dtype) for o in out)

    @staticmethod
    def backward(ctx, libar, ldpbar, ldqbar, _fp, _fq):
        dt = ctx.bwd_dtype
        back = ctx.saved_tensors[0].dtype
        saved = types.SimpleNamespace(
            jitter=ctx.jitter,
            saved_tensors=[t.to(dt) for t in ctx.saved_tensors])
        dc, _, da, _, _ = tl._LeafFactor.backward(
            saved, *[None if g is None else g.to(dt)
                     for g in (libar, ldpbar, ldqbar)], None, None)
        return dc.to(back), None, da.to(back), None, None, None, None


def split_leaf(fwd_dtype, bwd_dtype):
    kernel = tl._leaf_factor_fwd

    def leaf(c, k, a, jitter):
        fwd = kernel if fwd_dtype == F32 else tl.leaf_factor_ref
        return SplitLeaf.apply(c, k, a, jitter, fwd, fwd_dtype, bwd_dtype)
    return leaf


def posterior_f32(x, libar, ldqbar):
    """``tl._leaf_posterior_pullback`` with its products in ``x``'s type
    (float32 here) instead of float64."""
    xt = tl._mt(x)
    kbar = torch.zeros_like(x)
    if ldqbar is not None:
        kbar = 0.5 * ldqbar[:, None, None] * (xt @ x)
    if libar is not None:
        raw = xt @ (tl._phi(-(libar @ xt)) @ x)
        kbar = kbar + 0.5 * (raw + tl._mt(raw))
    return kbar


POSTERIOR = tl._leaf_posterior_pullback


def float64_covariance(theta):
    """The exponential kernel evaluated in float64, rounded to the
    locations' type."""
    kern = exponential_builder(theta)

    def cov(x1, x2=None):
        return kern(x1.double(), None if x2 is None else x2.double()).to(
            x1.dtype)
    return cov


def evaluate(locs, y, device, dtype, twins=False, leaf=None, chol=None,
             builder=exponential_builder, split=None, posterior32=False):
    saved = {name: getattr(tl, name) for name in TWINS}
    kernels = dict(saved)
    saved_sweep = (sweep._kernel_structure, sweep.leaf_factor,
                   sweep.cholesky_jittered)
    try:
        if twins or dtype == F64 or leaf == F64 or chol == F64:
            for name, twin in TWINS.items():
                setattr(tl, name, getattr(tl, twin))
        # the kernel structure at either type
        sweep._kernel_structure = lambda dt, jitter: bool(jitter)
        if leaf is not None:
            sweep.leaf_factor = cast_stage(tl.leaf_factor, leaf)
        if chol is not None:
            sweep.cholesky_jittered = cast_stage(tl.cholesky_jittered, chol)
        if split is not None:
            sweep.leaf_factor = split_leaf(*split)
            if split[1] == F32:  # the float32 backward runs K3/K4
                tl._tri_inv_fwd = kernels["_tri_inv_fwd"]
                tl._cholesky_fwd = kernels["_cholesky_fwd"]
        if posterior32:
            tl._leaf_posterior_pullback = posterior_f32
        model = MRAModel(locs, r=4, M=4, dtype=dtype, jitter=1e-6,
                         config=PlanConfig(r=4, kmeans_impl="native"),
                         device=device)
        f = model.loglik_fn(torch.as_tensor(y, dtype=dtype, device=device),
                            1e-4, kernel_builder=builder)
        theta = {k: torch.tensor(v, dtype=F64, requires_grad=True)
                 for k, v in (("l", 2.0), ("sig", 1.0))}
        value = f(theta)
        value.backward()
        return float(value.detach()), float(theta["l"].grad), float(
            theta["sig"].grad)
    finally:
        for name, fn in saved.items():
            setattr(tl, name, fn)
        tl._leaf_posterior_pullback = POSTERIOR
        (sweep._kernel_structure, sweep.leaf_factor,
         sweep.cholesky_jittered) = saved_sweep


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda":
        sweep.set_matmul_precision()
    locs, y = load_data("large")
    variants = [
        ("f64 twins", dict(dtype=F64)),
        ("f32 kernels", dict(dtype=F32)),
        ("f32 twins", dict(dtype=F32, twins=True)),
        ("f64, leaf f32", dict(dtype=F64, leaf=F32)),
        ("f64, chol f32", dict(dtype=F64, chol=F32)),
        ("f32, leaf f64", dict(dtype=F32, leaf=F64)),
        ("f32, cov f64", dict(dtype=F32, builder=float64_covariance)),
        ("f64, leaf fwd f32 bwd f64", dict(dtype=F64, split=(F32, F64))),
        ("f64, leaf fwd f64 bwd f32", dict(dtype=F64, split=(F64, F32))),
        ("..., posterior f32", dict(dtype=F64, split=(F64, F32),
                                    posterior32=True)),
        ("f32 kernels, posterior f32", dict(dtype=F32, posterior32=True)),
    ]
    ref = None
    for name, kw in variants:
        value, gl, gs = evaluate(locs, y, args.device, **kw)
        ref = ref or (value, gl, gs)
        rel_g = [(gl - GOLDEN_GRAD_N10K["l"]) / abs(GOLDEN_GRAD_N10K["l"]),
                 (gs - GOLDEN_GRAD_N10K["sig"]) / abs(GOLDEN_GRAD_N10K["sig"])]
        rel_r = [(a - b) / abs(b) for a, b in zip((value, gl, gs), ref)]
        print(f"{name:>14}: loglik {value!r} dl {gl!r} dsig {gs!r}; "
              f"vs golden dl {rel_g[0]:+.3e} dsig {rel_g[1]:+.3e}; vs f64 "
              f"jitter 1e-6 loglik {rel_r[0]:+.3e} dl {rel_r[1]:+.3e} "
              f"dsig {rel_r[2]:+.3e}")


if __name__ == "__main__":
    main()
