"""Batched small-matrix factorizations of the MRA sweep
(counterpart of ``pymra_tpu/ops/pallas/linalg.py``).

Entry points, each a wrapper that chooses by the device of its input and
is differentiable (a ``torch.autograd.Function`` with the JAX package's
custom VJP, or a composition of such):

* :func:`cholesky` — plain lower Cholesky factor, NaN on an indefinite
  pivot (replaces K4, ``_chol_kernel``); ``ops/cuda/csrc/cholesky.cu``,
  on the register-tiled core ``chol_tile.cuh`` it shares with K1 (width
  tier from :func:`tile_tier`).
* :func:`triangular_inverse_lower` — explicit inverse of a lower triangle
  (replaces K3, ``_tri_inv_kernel``): up to 64 wide
  ``ops/cuda/csrc/tri_inv.cu`` on the register-tiled core ``chol_tile.cuh``
  (width tier from :func:`tile_tier`); for 64 < P <= 256 one launch of
  ``ops/cuda/csrc/tri_inv_wide.cu`` (the core on the 64-wide diagonal
  blocks, float32 block products for the rest); wider the blocked
  composition (the JAX package's ``_tri_inv_recursive``: the first kernel
  on 64-wide diagonal blocks, ``torch.matmul`` for the off-diagonal ones).
* :func:`solve_triangular_batched` — ``L x = b`` or ``L^T x = b``
  (replaces K5, ``_tri_solve_kernel``); ``ops/cuda/csrc/tri_solve.cu``, on
  the register-tiled core's solve mode (width tier from :func:`tile_tier`,
  slabs of ``b``'s columns from :func:`solve_cols`).
* :func:`cholesky_pullback` — the Cholesky pullback of K2 and K4 (and KC
  up to P = 64) in one launch: product, both K5 substitutions and the
  symmetrization of the JAX package's ``_cholesky_bwd``;
  ``ops/cuda/csrc/tri_solve.cu``: one entry a lane up to P = 8, the
  register-tiled core's pullback mode for 9 <= P <= 64 (route from
  :func:`jittered_tier`).
* :func:`cholesky_jittered` — lower Cholesky factor of ``A + f*jit*I``
  with per-member jitter escalation (replaces K2,
  ``_chol_jittered_kernel``); ``ops/cuda/csrc/cholesky_jittered.cu``:
  sub-warp groups up to P = 8, the register-tiled core ``chol_tile.cuh``
  for 9 <= P <= 64 (route from :func:`jittered_tier`).
* :func:`leaf_factor` — the fused leaf stage: prior log-determinant and
  posterior inverse factor + log-determinant (replaces K1,
  ``_kleaf_logdet_kernel`` + ``_kleaf_inv_logdet_kernel``);
  ``ops/cuda/csrc/leaf_factor.cu``, on ``chol_tile.cuh``. Its backward,
  :func:`leaf_pullback` (the JAX package's ``_leaf_factor_bwd``, which has
  no Pallas kernel), is one launch of ``ops/cuda/csrc/leaf_pullback.cu``:
  the posterior pullback's float64 products on the triangles and the
  prior block refactored and inverted on ``chol_tile.cuh``.
* :func:`cholesky_logdet` — jittered log-determinant with escalation, no
  factor formed (replaces K6, ``_chol_logdet_kernel``);
  ``ops/cuda/csrc/chol_logdet.cu``, on ``chol_tile.cuh`` (K1's prior half
  on a plain input; width tier from :func:`tile_tier`).
* :func:`cholesky_inv_logdet` — jittered inverse factor and log-determinant
  with escalation (replaces K7, ``_chol_inv_logdet_kernel``);
  ``ops/cuda/csrc/chol_inv_logdet.cu``, on ``chol_tile.cuh`` (K1's
  posterior half on a plain input; width tier from :func:`tile_tier`).
* :func:`cholesky_blocked` — blocked Cholesky for P > 64 (K8) and
  :func:`cholesky_cascade` — its jitter escalation (KC, the counterpart of
  ``cholesky_cascade_lanes`` and the sweep's ``_chol_cascade``): for
  64 < P <= 256 one kernel for both, ``ops/cuda/csrc/chol_wide.cu``
  (float32 64-wide diagonal blocks, float64 panels and downdates,
  escalation in the kernel); other widths compose K4, K3 and
  ``torch.matmul`` (float64 for a float32 input), KC over K4 up to 64.

Every entry point takes any leading batch shape and runs it as one flat
batch of members: ``[C, n, P, P]`` (``C`` parameter sets of the sweep's
``n`` nodes) is one launch over ``C*n`` members, equal member for member to
the same call on ``[C*n, P, P]``. The kernels index members (a lane kernel
its lanes) in 32-bit ints; a batch that would pass them is refused
(:func:`_fits_int32`), never wrapped around.

A CPU tensor runs the plain PyTorch twin (``*_ref``), an explicit batched
column loop with the kernel's arithmetic (K8 and KC: the same composition
over the twins). A CUDA tensor launches the hand written kernel or raises;
there is no fallback. Each wrapper counts its kernel launches in
``.launches`` (K3's wide kernel in ``.wide_launches``, KP's pullback mode
in ``.tile_launches``; K8 and KC count their calls at other widths, which
compose other kernels, in ``.composed``); each twin counts the calls it gets with
CUDA tensors in ``.cuda_calls`` (only kernel-versus-twin comparisons make
any). The twins update in place, so the Functions run them (and the
kernels) without autograd and differentiate by their own backward, which
calls the other wrappers: on the card every backward factorization,
inverse, solve and Cholesky pullback is a kernel (the K8 and KC pullbacks
above P = 64 solve with ``torch.linalg.solve_triangular``, as the JAX
package's XLA solve there), and the other products are full-float32
``torch.matmul`` (TF32 off, :func:`set_matmul_precision`).

Escalation contract (K1, K2, K6, K7, KC): a member is retried at the next
factor of ``factors`` while its log-pivot sum (KC: its factor) is
non-finite — NaN for a negative pivot, -inf for an exact zero. Members that
succeed keep their first result; a member that fails every factor keeps its
last, NaN, result and reports the last factor. The backward linearizes each
member at its selected factor, so a discarded attempt never reaches a
gradient, and an all-fail member's NaN stays in that member. The jitter
scale is structural: no gradient flows into it through ``jit`` of K1.
While a traced call is open (:mod:`pymra_torch.utils.profiling`) these
five hand their selected factors to its innermost span, which counts the
escalated members when read; :func:`launch_count`
(:mod:`pymra_torch.ops.cuda.launch`) sums every wrapper's launch counters
for its spans.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from pymra_torch.ops.cuda import build
from pymra_torch.ops.cuda.launch import counter as _counter
from pymra_torch.ops.cuda.launch import launch_count
from pymra_torch.ops.cuda.launch import launched as _launched
from pymra_torch.ops.cuda.launch import ptr as _ptr
from pymra_torch.ops.cuda.launch import where as _where
from pymra_torch.utils import profiling as _prof

__all__ = ["FACTORS", "MAX_P", "set_matmul_precision", "tile_tier",
           "jittered_tier", "solve_cols",
           "cholesky", "cholesky_ref", "triangular_inverse_lower",
           "triangular_inverse_lower_ref", "solve_triangular_batched",
           "solve_triangular_batched_ref", "cholesky_pullback",
           "cholesky_pullback_ref",
           "cholesky_jittered", "cholesky_jittered_ref", "leaf_factor",
           "leaf_factor_ref", "leaf_pullback", "leaf_pullback_ref",
           "cholesky_logdet", "cholesky_logdet_ref",
           "cholesky_inv_logdet", "cholesky_inv_logdet_ref",
           "WIDE_MAX_P", "cholesky_blocked", "cholesky_blocked_ref",
           "cholesky_cascade", "cholesky_cascade_ref", "launch_count"]

FACTORS = (1.0, 1e2, 1e4)
#: widest block the single-block kernels take; wider goes through the wide
#: kernels (``chol_wide.cu``, ``tri_inv_wide.cu``) or the blocked
#: compositions (K8 ``cholesky_blocked``, the blocked
#: ``triangular_inverse_lower``, KC ``cholesky_cascade``)
MAX_P = 64


def set_matmul_precision() -> None:
    """Full float32 in every matmul: no TF32 in cuBLAS or cuDNN.

    The N=10^4 bench tree's tiny measurement error (R = 1e-4) conditions
    its posterior blocks at ~1e4 and amplifies reduced-precision matmul
    residue through the log-determinants; on the JAX package's reference
    runs a 3-pass bf16 matmul put that objective 4e-2 off its golden value.
    TF32 keeps about three decimal digits, the same hazard. Called by the
    sweep before its forward and by every backward here.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _escalate(base: torch.Tensor, jit: torch.Tensor, factors,
              attempt: Callable) -> tuple[list[torch.Tensor], torch.Tensor,
                                          torch.Tensor]:
    """Run ``attempt(base + f*jit*I)`` per member until its log-pivot sum
    is finite. ``attempt`` returns ``(outputs, acc)``; returns the selected
    ``(outputs, acc, f)``. Only still-bad members are recomputed."""
    n, p = base.shape[0], base.shape[-1]
    eye = torch.eye(p, dtype=base.dtype, device=base.device)
    todo = torch.arange(n, device=base.device)
    outs = acc = f = None
    for fac in factors:
        if outs is None:  # every member: no gather
            sub = base + eye * (jit * fac)[:, None, None]
        else:
            sub = base[todo] + eye * (jit[todo] * fac)[:, None, None]
        o, a = attempt(sub)
        if outs is None:
            outs, acc = list(o), a
            f = torch.full((n,), fac, dtype=base.dtype, device=base.device)
        else:
            for dst, src in zip(outs, o):
                dst[todo] = src
            acc[todo] = a
            f[todo] = fac
        todo = todo[~torch.isfinite(a)]
        if todo.numel() == 0:
            break
    return outs, acc, f


def _chol_attempt(a: torch.Tensor):
    """Right-looking Cholesky of ``[n, P, P]``: (factor, sum log pivots).
    Column j is ``a[j:, j] / sqrt(a[j, j])``, the diagonal included, so an
    indefinite or zero pivot turns its column and the trailing block NaN."""
    a = a.clone()
    n, p = a.shape[0], a.shape[-1]
    out = torch.zeros_like(a)
    acc = torch.zeros(n, dtype=a.dtype, device=a.device)
    for j in range(p):
        piv = torch.sqrt(a[:, j, j])
        acc = acc + torch.log(piv)
        col = a[:, j:, j] / piv[:, None]
        out[:, j:, j] = col
        a[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    return (out,), acc


def _logdet_attempt(a: torch.Tensor):
    """Half the log-pivot sum of ``[n, P, P]``, factor never formed."""
    a = a.clone()
    n, p = a.shape[0], a.shape[-1]
    acc = torch.zeros(n, dtype=a.dtype, device=a.device)
    for j in range(p):
        d = a[:, j, j]
        acc = acc + torch.log(d)
        a[:, j + 1:, j + 1:] -= ((a[:, j + 1:, j] / d[:, None])[:, :, None]
                                 * a[:, None, j, j + 1:])
    return (), 0.5 * acc


def _inv_attempt(a: torch.Tensor):
    """``chol(a)^-1`` with the inverse formed alongside the factorization,
    and the log-pivot sum."""
    a = a.clone()
    n, p = a.shape[0], a.shape[-1]
    x = torch.eye(p, dtype=a.dtype, device=a.device).expand(n, p, p).clone()
    acc = torch.zeros(n, dtype=a.dtype, device=a.device)
    for j in range(p):
        piv = torch.sqrt(a[:, j, j])
        acc = acc + torch.log(piv)
        col = a[:, j + 1:, j] / piv[:, None]
        x[:, j, :j + 1] = x[:, j, :j + 1] / piv[:, None]
        x[:, j + 1:, :j + 1] -= col[:, :, None] * x[:, None, j, :j + 1]
        a[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    return (x,), acc


def _forward_subst(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Solve ``l x = b`` in place of ``x = b`` (``[n, P, Q]``), one row of
    the solution per step, in order."""
    p = l.shape[-1]
    for j in range(p):
        x[:, j, :] = x[:, j, :] / l[:, j, j, None]
        x[:, j + 1:, :] -= l[:, j + 1:, j, None] * x[:, j, None, :]
    return x


def cholesky_ref(mat: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`cholesky`; any dtype, any width."""
    if mat.is_cuda:
        cholesky_ref.cuda_calls += 1
    p = mat.shape[-1]
    (l,), _ = _chol_attempt(mat.reshape(-1, p, p))
    return l.reshape(mat.shape)


cholesky_ref.cuda_calls = 0


def triangular_inverse_lower_ref(l: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`triangular_inverse_lower`: forward substitution
    against the identity (entries above the diagonal stay exact zeros)."""
    if l.is_cuda:
        triangular_inverse_lower_ref.cuda_calls += 1
    p = l.shape[-1]
    lf = l.reshape(-1, p, p)
    eye = torch.eye(p, dtype=l.dtype, device=l.device)
    return _forward_subst(lf, eye.expand_as(lf).clone()).reshape(l.shape)


triangular_inverse_lower_ref.cuda_calls = 0


def solve_triangular_batched_ref(l: torch.Tensor, b: torch.Tensor,
                                 transpose: bool = False) -> torch.Tensor:
    """Plain twin of :func:`solve_triangular_batched`: forward (``L x =
    b``) or back (``L^T x = b``, reading ``L[j, i]`` for ``L^T[i, j]``)
    substitution, one row of the solution per step."""
    if l.is_cuda:
        solve_triangular_batched_ref.cuda_calls += 1
    p, q = l.shape[-1], b.shape[-1]
    lf = l.reshape(-1, p, p)
    x = b.reshape(-1, p, q).clone()
    if not transpose:
        return _forward_subst(lf, x).reshape(b.shape)
    for j in range(p - 1, -1, -1):
        x[:, j, :] = x[:, j, :] / lf[:, j, j, None]
        x[:, :j, :] -= lf[:, j, :j, None] * x[:, j, None, :]
    return x.reshape(b.shape)


solve_triangular_batched_ref.cuda_calls = 0


def _pullback(l, lbar, ldbar, f, solve):
    """The Cholesky pullback as a composition (the JAX package's
    ``_cholesky_bwd``, with the log-determinant cotangent and the jitter
    gradient of ``_cholesky_jittered_bwd``): ``Lbar' = Lbar + diag(ldbar /
    diag L)``, ``raw = L^-T phi(L^T Lbar') L^-1`` by two ``solve(L, B,
    True)`` (``L^T X = B``), ``Abar = (raw + raw^T) / 2`` and ``jbar = f
    trace(Abar)`` (None without ``f``)."""
    if ldbar is not None:
        # ld = sum_j log L_jj
        lbar = lbar + torch.diag_embed(
            ldbar[..., None] / torch.diagonal(l, dim1=-2, dim2=-1))
    w = _phi(_mt(l) @ lbar)
    x = solve(l, w, True)  # L^-T w
    raw = _mt(solve(l, _mt(x), True))  # x L^-1
    abar = 0.5 * (raw + _mt(raw))
    return abar, (None if f is None else f * _trace(abar))


def cholesky_pullback_ref(l: torch.Tensor, lbar: torch.Tensor,
                          ldbar: torch.Tensor | None = None,
                          f: torch.Tensor | None = None,
                          solve: Callable | None = None):
    """Plain twin of :func:`cholesky_pullback`: the composition over
    :func:`solve_triangular_batched_ref` (or ``solve(L, B, trans)``, any
    solve of ``L X = B`` / ``L^T X = B``); any dtype, any width."""
    if l.is_cuda:
        cholesky_pullback_ref.cuda_calls += 1
    return _pullback(l, lbar, ldbar, f,
                     solve or solve_triangular_batched_ref)


cholesky_pullback_ref.cuda_calls = 0


def cholesky_jittered_ref(mat: torch.Tensor, jit: torch.Tensor,
                          factors=FACTORS):
    """Plain twin of :func:`cholesky_jittered`; any dtype, any width."""
    if mat.is_cuda:
        cholesky_jittered_ref.cuda_calls += 1
    batch, p = mat.shape[:-2], mat.shape[-1]
    jit = torch.as_tensor(jit, dtype=mat.dtype, device=mat.device)
    (l,), ld, f = _escalate(mat.reshape(-1, p, p),
                            jit.expand(batch).reshape(-1), factors,
                            _chol_attempt)
    return l.reshape(mat.shape), ld.reshape(batch), f.reshape(batch)


cholesky_jittered_ref.cuda_calls = 0


def _leaf_parts(c_own, kmask):
    """``(K_leaf, knot pair mask, diag(1-k), s)`` of a flat leaf batch, with
    ``s = mean|diag K_leaf| + 1`` the jitter scale."""
    p = c_own.shape[-1]
    eye = torch.eye(p, dtype=c_own.dtype, device=c_own.device)
    pair = kmask[:, :, None] * kmask[:, None, :]
    unk = eye * (1.0 - kmask)[:, :, None]
    diag_kl = torch.diagonal(c_own, dim1=-2, dim2=-1) * kmask + (1.0 - kmask)
    s = diag_kl.abs().mean(-1) + 1.0
    return c_own * pair + unk, pair, unk, s


def leaf_factor_ref(c_own: torch.Tensor, kmask: torch.Tensor,
                    a_oo: torch.Tensor, jitter: float, factors=FACTORS):
    """Plain twin of :func:`leaf_factor`; any dtype, any width."""
    if c_own.is_cuda:
        leaf_factor_ref.cuda_calls += 1
    batch, p = c_own.shape[:-2], c_own.shape[-1]
    c = c_own.reshape(-1, p, p)
    k = kmask.reshape(-1, p).to(c.dtype)
    k_leaf, pair, unk, s = _leaf_parts(c, k)
    jit_eff = jitter * s
    _, ldp, fp = _escalate(k_leaf, jit_eff, factors, _logdet_attempt)
    q = (c + a_oo.reshape(-1, p, p)) * pair + unk
    (li,), ldq, fq = _escalate(q, jit_eff, factors, _inv_attempt)
    return (li.reshape(c_own.shape), ldp.reshape(batch), ldq.reshape(batch),
            fp.reshape(batch), fq.reshape(batch))


leaf_factor_ref.cuda_calls = 0


def leaf_pullback_ref(c_own, kmask, li, fp, libar, ldpbar, ldqbar,
                      jitter: float):
    """Plain twin of :func:`leaf_pullback`: the composition of
    :func:`_leaf_posterior_pullback` (float64 products, rounded once) and
    :func:`_leaf_prior_pullback` (the prior block refactored at ``fp`` by
    :func:`cholesky` and inverted by :func:`triangular_inverse_lower`);
    any width. On a CUDA tensor those two wrappers launch K4 and K3."""
    if c_own.is_cuda:
        leaf_pullback_ref.cuda_calls += 1
    shape, p = c_own.shape, c_own.shape[-1]
    c = c_own.reshape(-1, p, p)
    k_leaf, pair, _, s = _leaf_parts(c, kmask.reshape(-1, p).to(c.dtype))
    kbar_q = _leaf_posterior_pullback(
        li.reshape(-1, p, p),
        None if libar is None else libar.reshape(-1, p, p),
        None if ldqbar is None else ldqbar.reshape(-1))
    kbar = kbar_q
    if ldpbar is not None:
        kbar = kbar + _leaf_prior_pullback(
            k_leaf, fp.reshape(-1) * (jitter * s), ldpbar.reshape(-1))
    # A_oo enters only through the pair-masked posterior assembly
    return (kbar * pair).reshape(shape), (kbar_q * pair).reshape(shape)


leaf_pullback_ref.cuda_calls = 0


def _flat_jit(mat: torch.Tensor, jit) -> torch.Tensor:
    """One jitter per member, ``[n]``, from a scalar or a batch-shaped
    ``jit``."""
    jit = torch.as_tensor(jit, dtype=mat.dtype, device=mat.device)
    return jit.expand(mat.shape[:-2]).reshape(-1)


def cholesky_logdet_ref(mat: torch.Tensor, jit: torch.Tensor,
                        factors=FACTORS):
    """Plain twin of :func:`cholesky_logdet`; any dtype, any width."""
    if mat.is_cuda:
        cholesky_logdet_ref.cuda_calls += 1
    batch, p = mat.shape[:-2], mat.shape[-1]
    _, ld, f = _escalate(mat.reshape(-1, p, p), _flat_jit(mat, jit),
                         factors, _logdet_attempt)
    return ld.reshape(batch), f.reshape(batch)


cholesky_logdet_ref.cuda_calls = 0


def cholesky_inv_logdet_ref(mat: torch.Tensor, jit: torch.Tensor,
                            factors=FACTORS):
    """Plain twin of :func:`cholesky_inv_logdet`; any dtype, any width."""
    if mat.is_cuda:
        cholesky_inv_logdet_ref.cuda_calls += 1
    batch, p = mat.shape[:-2], mat.shape[-1]
    (x,), ld, f = _escalate(mat.reshape(-1, p, p), _flat_jit(mat, jit),
                            factors, _inv_attempt)
    return x.reshape(mat.shape), ld.reshape(batch), f.reshape(batch)


cholesky_inv_logdet_ref.cuda_calls = 0


def _blocked(mat: torch.Tensor, block: int, chol: Callable,
             tri_inv: Callable) -> torch.Tensor:
    """Right-looking blocked Cholesky (the JAX package's
    ``cholesky_blocked``): ``chol`` factors each ``block``-wide diagonal
    block, ``tri_inv`` inverts it, the panel ``A21 L11^-T`` and the
    trailing downdate are matmuls. An indefinite block leaves NaN from its
    failing column on, in its own member only.

    A float32 input has its panels and trailing blocks carried in float64
    and rounded once, where they leave the composition: the JAX package
    keeps them in float32. The wide leaves' posterior blocks (cond ~1e5)
    lose most of their float32 accuracy there: on 62500 points of the
    1000^2 grid at 256-wide leaves (exponential l=0.05, R=1e-2) the float32
    gradient fell from 2.3e-3 to 1.4e-3 off the float64 sweep's, the
    loglik from 5.9e-4 to 3.6e-4 (``tools/float32_wide_leaves.py``, CPU
    twins); on an NVIDIA H100 (700 W) the N=10^6 grid's 4096 leaves of 256
    went from 2.03e-3 to 1.29e-3 between autograd and a five-point
    difference (``chip_smoke.py``)."""
    p = mat.shape[-1]
    if p <= block:
        return chol(mat.contiguous())
    wide = torch.float64 if mat.dtype == torch.float32 else mat.dtype
    a = mat
    cols = []  # per block column: its [..., p - j0, b] lower part
    for j0 in range(0, p, block):
        b = min(block, p - j0)
        l11 = chol(a[..., :b, :b].to(mat.dtype).contiguous())
        if j0 + b < p:
            l21 = a[..., b:, :b].to(wide) @ _mt(tri_inv(l11)).to(wide)
            a = a[..., b:, b:].to(wide) - l21 @ _mt(l21)
            l11 = torch.cat([l11, l21.to(mat.dtype)], dim=-2)
        cols.append(torch.cat([l11.new_zeros(mat.shape[:-2] + (j0, b)),
                               l11], dim=-2))
    return torch.cat(cols, dim=-1)


def cholesky_blocked_ref(mat: torch.Tensor, block: int = MAX_P
                         ) -> torch.Tensor:
    """Plain twin of :func:`cholesky_blocked`: the same composition over
    the twins of K4 and K3."""
    if mat.is_cuda:
        cholesky_blocked_ref.cuda_calls += 1
    return _blocked(mat, block, cholesky_ref, triangular_inverse_lower_ref)


cholesky_blocked_ref.cuda_calls = 0


def _cascade_attempt(factor: Callable) -> Callable:
    """An :func:`_escalate` attempt of the cascade: the factor, and its
    log-diagonal sum where every entry is finite (NaN elsewhere, so that a
    member with any non-finite entry is retried, as the JAX cascade's
    all-finite select does)."""
    def attempt(a):
        l = factor(a)
        ok = torch.isfinite(l).flatten(-2).all(-1)
        ld = torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
        return (l,), torch.where(ok, ld, torch.full_like(ld, float("nan")))
    return attempt


def cholesky_cascade_ref(mat: torch.Tensor, jit: torch.Tensor,
                         factors=FACTORS):
    """Plain twin of :func:`cholesky_cascade`; any dtype, any width."""
    if mat.is_cuda:
        cholesky_cascade_ref.cuda_calls += 1
    batch, p = mat.shape[:-2], mat.shape[-1]
    factor = cholesky_ref if p <= MAX_P else cholesky_blocked_ref
    (l,), ld, f = _escalate(mat.reshape(-1, p, p), _flat_jit(mat, jit),
                            factors, _cascade_attempt(factor))
    return l.reshape(mat.shape), ld.reshape(batch), f.reshape(batch)


cholesky_cascade_ref.cuda_calls = 0


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_square(name: str, t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    if t.ndim < 2 or t.shape[-1] != t.shape[-2] or t.shape[-1] < 1:
        raise ValueError(f"{name}: expected [..., P, P], got "
                         f"{tuple(t.shape)}")
    p = t.shape[-1]
    if p > MAX_P:
        raise ValueError(
            f"{name}: P={p} > {MAX_P}, wider than one block of the kernel; "
            "wider matrices go through cholesky_blocked / cholesky_cascade "
            "and triangular_inverse_lower")
    return p


def _factors(factors) -> tuple[float, float, float]:
    if len(factors) != 3:
        raise ValueError(f"the CUDA kernels take exactly 3 escalation "
                         f"factors, got {factors}")
    return tuple(float(f) for f in factors)


#: members (and lanes) past this overflow the kernels' 32-bit indices
_INT32_LIMIT = 2 ** 31
#: threads of one block of the lane kernels (``subwarp::kThreads``): the
#: last block's indices run this far past the batch
_BLOCK_SLACK = 128
#: most threads a member of the lane kernels takes (K2's sub-warp groups
#: and KP's lane kernel at P <= 8: a warp at most)
_LANES = 32


def _fits_int32(name: str, n: int, per_member: int = 1) -> None:
    """Refuse a launch of ``n`` members of ``per_member`` blocks or lanes
    each whose indices would pass a 32-bit int (a flat batch of ``C``
    parameter sets is ``C`` times the sweep's own)."""
    if (n + _BLOCK_SLACK) * per_member >= _INT32_LIMIT:
        raise ValueError(
            f"{name}: {n} members of {per_member} blocks or lanes each "
            "pass the kernel's 32-bit indices; split the batch")


def tile_tier(p: int) -> int:
    """Width tier of the kernels on the register-tiled core
    (``ops/cuda/csrc/chol_tile.cuh``: K1, K2 above P = 8, K3 up to 64,
    K4, K5, K6 and K7) for a ``P x P`` member: the least of 16, 32, 48 and
    64 that holds ``p``. The kernel pads the member to it with the
    identity."""
    if not 1 <= p <= MAX_P:
        raise ValueError(f"tile_tier: P={p} outside 1..{MAX_P}")
    return 16 * -(-p // 16)


#: widest member of K2's sub-warp groups (``ops/cuda/csrc/subwarp.cuh``)
SUBWARP_MAX_P = 8


def jittered_tier(p: int) -> int:
    """K2's route for a ``P x P`` member: 0, the sub-warp groups of
    ``cholesky_jittered.cu`` (P <= 8, the interior blocks), else the
    register-tiled core at the width tier :func:`tile_tier`."""
    return 0 if 1 <= p <= SUBWARP_MAX_P else tile_tier(p)


def solve_cols(q: int) -> int:
    """Columns of ``b`` one block of K5 takes (``chol_tile.cuh``'s solve
    mode, its thread grid (64 / C) x C): 1, 2, 4 or 8, the least that holds
    ``q`` up to 8; a wider ``b`` is split into ``ceil(q / 8)`` slabs of 8
    columns, one block each."""
    if q < 1:
        raise ValueError(f"solve_cols: Q={q} < 1")
    return 1 if q == 1 else 2 if q == 2 else 4 if q <= 4 else 8


def _cholesky_fwd(mat: torch.Tensor) -> torch.Tensor:
    if mat.device.type == "cpu":
        return cholesky_ref(mat)
    lib = build.load_library()
    p = _check_square("cholesky: mat", mat)
    _check("cholesky: mat", mat, mat.shape, mat.device)
    out = torch.empty_like(mat)
    n = out.numel() // (p * p)
    _fits_int32("cholesky", n)
    if n:
        _launched("cholesky", lib.pymra_cholesky(
            mat.data_ptr(), out.data_ptr(), n, p, tile_tier(p),
            *_where(mat)))
        cholesky.launches += 1
    return out


def _tri_inv_blocked(l: torch.Tensor, inv: Callable) -> torch.Tensor:
    """``L^-1`` by ``inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1,
    C^-1]]`` (the JAX package's ``_tri_inv_recursive``), split at a
    multiple of 64 so that every diagonal block ``inv`` inverts is 64 wide
    but the last; the off-diagonal blocks are matmuls. Up to 64 wide,
    ``inv`` alone."""
    p = l.shape[-1]
    if p <= MAX_P:
        return inv(l.contiguous())
    nb = -(-p // MAX_P)
    k = MAX_P * ((nb + 1) // 2)
    ai = _tri_inv_blocked(l[..., :k, :k], inv)
    ci = _tri_inv_blocked(l[..., k:, k:], inv)
    x = -(ci @ (l[..., k:, :k] @ ai))
    top = torch.cat([ai, ai.new_zeros(l.shape[:-2] + (k, p - k))], dim=-1)
    return torch.cat([top, torch.cat([x, ci], dim=-1)], dim=-2)


def _tri_inv_launch(l: torch.Tensor) -> torch.Tensor:
    """One kernel launch on the card: ``tri_inv.cu`` for P <= 64 (counted
    in ``triangular_inverse_lower.launches``), ``tri_inv_wide.cu`` for 64
    < P <= 256 (in ``.wide_launches``)."""
    p = l.shape[-1]
    if not 1 <= p <= WIDE_MAX_P:
        raise ValueError(f"triangular_inverse_lower: P={p} outside "
                         f"1..{WIDE_MAX_P}, the kernels' widths")
    _check("triangular_inverse_lower: l", l, l.shape, l.device)
    lib = build.load_library()
    out = torch.empty_like(l)
    n = out.numel() // (p * p)
    _fits_int32("triangular_inverse_lower", n)
    if n:
        if p <= MAX_P:
            _launched("triangular_inverse_lower", lib.pymra_tri_inv(
                l.data_ptr(), out.data_ptr(), n, p, tile_tier(p),
                *_where(l)))
            triangular_inverse_lower.launches += 1
        else:
            _launched("triangular_inverse_lower (wide)",
                      lib.pymra_tri_inv_wide(l.data_ptr(), out.data_ptr(),
                                             n, p, *_where(l)))
            triangular_inverse_lower.wide_launches += 1
    return out


def _tri_inv_fwd(l: torch.Tensor) -> torch.Tensor:
    if l.device.type == "cpu":
        return _tri_inv_blocked(l, triangular_inverse_lower_ref)
    build.load_library()
    _on_card("triangular_inverse_lower: l", l)
    if l.shape[-1] <= WIDE_MAX_P:
        return _tri_inv_launch(l)
    triangular_inverse_lower.composed += 1
    return _tri_inv_blocked(l, _tri_inv_launch)


def _tri_solve_fwd(l: torch.Tensor, b: torch.Tensor,
                   transpose: bool) -> torch.Tensor:
    if l.device.type == "cpu":
        return solve_triangular_batched_ref(l, b, transpose)
    lib = build.load_library()
    p = _check_square("solve_triangular_batched: l", l)
    batch = l.shape[:-2]
    if b.ndim != l.ndim or b.shape[-2] != p or b.shape[-1] < 1:
        raise ValueError(f"solve_triangular_batched: b {tuple(b.shape)} "
                         f"does not match l {tuple(l.shape)}")
    q = b.shape[-1]
    _check("solve_triangular_batched: l", l, l.shape, l.device)
    _check("solve_triangular_batched: b", b, batch + (p, q), l.device)
    cols = solve_cols(q)
    out = torch.empty_like(b)
    n = out.numel() // (p * q)
    _fits_int32("solve_triangular_batched", n, -(-q // cols))
    if n:
        _launched("solve_triangular_batched", lib.pymra_tri_solve(
            l.data_ptr(), b.data_ptr(), out.data_ptr(), n, p, q,
            int(bool(transpose)), tile_tier(p), cols, *_where(l)))
        solve_triangular_batched.launches += 1
    return out


def _cholesky_jittered_fwd(mat: torch.Tensor, jit: torch.Tensor, factors):
    if mat.device.type == "cpu":
        return cholesky_jittered_ref(mat, jit, factors)
    lib = build.load_library()
    p = _check_square("cholesky_jittered: mat", mat)
    batch = mat.shape[:-2]
    _check("cholesky_jittered: mat", mat, mat.shape, mat.device)
    _check("cholesky_jittered: jit", jit, batch, mat.device)
    f0, f1, f2 = _factors(factors)
    out = torch.empty_like(mat)
    ld, f = torch.empty_like(jit), torch.empty_like(jit)
    n = out.numel() // (p * p)
    _fits_int32("cholesky_jittered", n, 1 if jittered_tier(p) else _LANES)
    if n:
        _launched("cholesky_jittered", lib.pymra_cholesky_jittered(
            mat.data_ptr(), jit.data_ptr(), out.data_ptr(), ld.data_ptr(),
            f.data_ptr(), n, p, jittered_tier(p), f0, f1, f2, *_where(mat)))
        cholesky_jittered.launches += 1
    return out, ld, f


def cholesky_pullback(l: torch.Tensor, lbar: torch.Tensor,
                      ldbar: torch.Tensor | None = None,
                      f: torch.Tensor | None = None):
    """The Cholesky pullback at the factor ``l [..., P, P]`` with the
    factor's cotangent ``lbar``, and optionally the cotangent ``ldbar
    [...]`` of its log-diagonal sum and the selected escalation factors
    ``f [...]``: returns ``(Abar, jbar)``, ``Abar = (raw + raw^T) / 2``
    with ``raw = L^-T phi(L^T Lbar') L^-1``, ``Lbar' = Lbar + diag(ldbar /
    diag L)``, and ``jbar = f trace(Abar)`` (None without ``f``) — the
    JAX package's ``_cholesky_bwd`` and ``_cholesky_jittered_bwd``.

    On the card one launch for P <= 64 (the backward passes call it under
    ``once_differentiable``; it is not differentiable itself): up to P = 8
    the lane kernel (counted in ``cholesky_pullback.launches``), for 9 <= P
    <= 64 the register-tiled core's pullback mode at :func:`tile_tier`
    (in ``.tile_launches``; route from :func:`jittered_tier`); on the CPU
    the twin :func:`cholesky_pullback_ref`."""
    if l.device.type == "cpu":
        return cholesky_pullback_ref(l, lbar, ldbar, f)
    lib = build.load_library()
    p = _check_square("cholesky_pullback: l", l)
    batch = l.shape[:-2]
    _check("cholesky_pullback: l", l, l.shape, l.device)
    _check("cholesky_pullback: lbar", lbar, l.shape, l.device)
    for name, t in (("ldbar", ldbar), ("f", f)):
        if t is not None:
            _check(f"cholesky_pullback: {name}", t, batch, l.device)
    abar = torch.empty_like(l)
    jbar = None if f is None else torch.empty_like(f)
    n = abar.numel() // (p * p)
    tier = jittered_tier(p)
    _fits_int32("cholesky_pullback", n, 1 if tier else _LANES)
    if n:
        _launched("cholesky_pullback", lib.pymra_chol_pullback(
            l.data_ptr(), lbar.data_ptr(), _ptr(ldbar), _ptr(f),
            abar.data_ptr(), _ptr(jbar), n, p, tier, *_where(l)))
        if tier:
            cholesky_pullback.tile_launches += 1
        else:
            cholesky_pullback.launches += 1
    return abar, jbar


_counter(cholesky_pullback, "launches", "tile_launches")


def _leaf_factor_fwd(c_own, kmask, a_oo, jitter, factors):
    if c_own.device.type == "cpu":
        return leaf_factor_ref(c_own, kmask, a_oo, jitter, factors)
    lib = build.load_library()
    p = _check_square("leaf_factor: c_own", c_own)
    batch = c_own.shape[:-2]
    _check("leaf_factor: c_own", c_own, c_own.shape, c_own.device)
    _check("leaf_factor: kmask", kmask, batch + (p,), c_own.device)
    _check("leaf_factor: a_oo", a_oo, c_own.shape, c_own.device)
    f0, f1, f2 = _factors(factors)
    li = torch.empty_like(c_own)
    vec = dict(dtype=c_own.dtype, device=c_own.device)
    ldp, ldq = torch.empty(batch, **vec), torch.empty(batch, **vec)
    fp, fq = torch.empty(batch, **vec), torch.empty(batch, **vec)
    n = li.numel() // (p * p)
    _fits_int32("leaf_factor", n)
    if n:
        _launched("leaf_factor", lib.pymra_leaf_factor(
            c_own.data_ptr(), kmask.data_ptr(), a_oo.data_ptr(),
            float(jitter), li.data_ptr(), ldp.data_ptr(), ldq.data_ptr(),
            fp.data_ptr(), fq.data_ptr(), n, p, tile_tier(p), f0, f1, f2,
            *_where(c_own)))
        leaf_factor.launches += 1
    return li, ldp, ldq, fp, fq


def leaf_pullback(c_own: torch.Tensor, kmask: torch.Tensor, li: torch.Tensor,
                  fp: torch.Tensor, libar: torch.Tensor | None,
                  ldpbar: torch.Tensor | None, ldqbar: torch.Tensor | None,
                  jitter: float):
    """K1's backward: ``(Cbar, Abar)``, the cotangents of
    :func:`leaf_factor`'s ``c_own`` and ``a_oo`` from its saved ``c_own``,
    ``kmask`` (broadcast to ``c_own``'s batch), inverse factor ``li`` and
    selected prior factor ``fp``, and the cotangents ``libar`` of ``li``,
    ``ldpbar`` of the prior and ``ldqbar`` of the posterior
    log-determinant (each None where absent). With ``X = li``, ``Kbar_q =
    sym(X^T (1/2 ldqbar I + phi(-libar X^T)) X)`` in float64 products
    rounded once, ``Abar = Kbar_q * kk^T`` and ``Cbar = (Kbar_q + 1/2
    ldpbar K_p^-1) * kk^T``, ``K_p`` the prior block at ``fp``.

    On the card one launch of ``ops/cuda/csrc/leaf_pullback.cu`` (counted
    in ``.launches``; it refactors and inverts the prior block itself, so
    K4 and K3 do not run); on the CPU the twin :func:`leaf_pullback_ref`.
    Not differentiable itself."""
    if c_own.device.type == "cpu":
        return leaf_pullback_ref(c_own, kmask, li, fp, libar, ldpbar,
                                 ldqbar, jitter)
    lib = build.load_library()
    p = _check_square("leaf_pullback: c_own", c_own)
    batch = c_own.shape[:-2]
    _check("leaf_pullback: c_own", c_own, c_own.shape, c_own.device)
    _check("leaf_pullback: kmask", kmask, batch + (p,), c_own.device)
    _check("leaf_pullback: li", li, c_own.shape, c_own.device)
    _check("leaf_pullback: fp", fp, batch, c_own.device)
    if libar is not None:
        _check("leaf_pullback: libar", libar, c_own.shape, c_own.device)
    for name, t in (("ldpbar", ldpbar), ("ldqbar", ldqbar)):
        if t is not None:
            _check(f"leaf_pullback: {name}", t, batch, c_own.device)
    cbar, abar = torch.empty_like(c_own), torch.empty_like(c_own)
    n = cbar.numel() // (p * p)
    _fits_int32("leaf_pullback", n)
    if n:
        _launched("leaf_pullback", lib.pymra_leaf_pullback(
            c_own.data_ptr(), kmask.data_ptr(), li.data_ptr(), _ptr(libar),
            _ptr(ldpbar), _ptr(ldqbar), fp.data_ptr(), float(jitter),
            cbar.data_ptr(), abar.data_ptr(), n, p, tile_tier(p),
            *_where(c_own)))
        leaf_pullback.launches += 1
    return cbar, abar


_counter(leaf_pullback, "launches")


def _jittered_args(name: str, mat: torch.Tensor, jit: torch.Tensor,
                   factors) -> tuple:
    """Checks of a jittered kernel's inputs on the card: ``(P, batch
    shape, f0, f1, f2)``."""
    p = _check_square(f"{name}: mat", mat)
    batch = mat.shape[:-2]
    _check(f"{name}: mat", mat, mat.shape, mat.device)
    _check(f"{name}: jit", jit, batch, mat.device)
    return (p, batch) + _factors(factors)


def _cholesky_logdet_fwd(mat: torch.Tensor, jit: torch.Tensor, factors):
    if mat.device.type == "cpu":
        return cholesky_logdet_ref(mat, jit, factors)
    lib = build.load_library()
    p, batch, f0, f1, f2 = _jittered_args("cholesky_logdet", mat, jit,
                                          factors)
    ld = torch.empty(batch, dtype=mat.dtype, device=mat.device)
    f = torch.empty_like(ld)
    _fits_int32("cholesky_logdet", ld.numel())
    if ld.numel():
        _launched("cholesky_logdet", lib.pymra_chol_logdet(
            mat.data_ptr(), jit.data_ptr(), ld.data_ptr(), f.data_ptr(),
            ld.numel(), p, tile_tier(p), f0, f1, f2, *_where(mat)))
        cholesky_logdet.launches += 1
    return ld, f


def _cholesky_inv_logdet_fwd(mat: torch.Tensor, jit: torch.Tensor,
                             factors):
    if mat.device.type == "cpu":
        return cholesky_inv_logdet_ref(mat, jit, factors)
    lib = build.load_library()
    p, batch, f0, f1, f2 = _jittered_args("cholesky_inv_logdet", mat, jit,
                                          factors)
    x = torch.empty_like(mat)
    ld = torch.empty(batch, dtype=mat.dtype, device=mat.device)
    f = torch.empty_like(ld)
    _fits_int32("cholesky_inv_logdet", ld.numel())
    if ld.numel():
        _launched("cholesky_inv_logdet", lib.pymra_chol_inv_logdet(
            mat.data_ptr(), jit.data_ptr(), x.data_ptr(), ld.data_ptr(),
            f.data_ptr(), ld.numel(), p, tile_tier(p), f0, f1, f2,
            *_where(mat)))
        cholesky_inv_logdet.launches += 1
    return x, ld, f


def _on_card(name: str, mat: torch.Tensor) -> None:
    """The checks of a composition's input on the card (any width)."""
    if mat.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{mat.device}")
    if mat.ndim < 2 or mat.shape[-1] != mat.shape[-2]:
        raise ValueError(f"{name}: expected [..., P, P], got "
                         f"{tuple(mat.shape)}")
    _check(name, mat, mat.shape, mat.device)


#: widest member of the wide kernel (``ops/cuda/csrc/chol_wide.cu``): four
#: 64-wide block columns
WIDE_MAX_P = 256
_WIDE_GRID: dict[int, int] = {}


def _wide_kernel(p: int, block: int = MAX_P) -> bool:
    """Whether the wide kernel takes a ``P x P`` member: 64 < P <= 256 in
    64-wide block columns. Other widths (and blocks) go through the
    compositions, by this width dispatch and not as a fallback."""
    return block == MAX_P and MAX_P < p <= WIDE_MAX_P


def _chol_wide(mat: torch.Tensor, jit: torch.Tensor | None, factors):
    """One launch of the wide kernel: ``(L, ld, f)`` of the cascade with
    ``jit`` (KC), or ``L`` alone with no jitter and one factor (K8)."""
    p, batch = mat.shape[-1], mat.shape[:-2]
    _check("chol_wide: mat", mat, mat.shape, mat.device)
    if jit is not None:
        _check("chol_wide: jit", jit, batch, mat.device)
    lib = build.load_library()
    out = torch.empty_like(mat)
    n = out.numel() // (p * p)
    _fits_int32("chol_wide", n)
    ld = f = None
    if jit is not None:
        ld, f = torch.empty((2,) + batch, dtype=mat.dtype, device=mat.device)
    if n:
        dev, stream = _where(mat)
        if dev not in _WIDE_GRID:
            grid = lib.pymra_chol_wide_grid(dev)
            if grid < 1:
                raise RuntimeError(f"chol_wide: no grid on device {dev}: "
                                   f"CUDA error {-grid}")
            _WIDE_GRID[dev] = grid
        grid = min(n, _WIDE_GRID[dev])
        # each persistent block's float64 panels
        slabs = torch.empty((grid, p, p), dtype=torch.float64,
                            device=mat.device)
        fs = _factors(factors) if jit is not None else (1.0, 1.0, 1.0)
        _launched("chol_wide", lib.pymra_chol_wide(
            mat.data_ptr(), _ptr(jit), out.data_ptr(), _ptr(ld), _ptr(f),
            slabs.data_ptr(), n, p, 3 if jit is not None else 1, *fs, grid,
            dev, stream))
    return out, ld, f


def _cholesky_blocked_fwd(mat: torch.Tensor, block: int) -> torch.Tensor:
    if mat.device.type == "cpu":
        return cholesky_blocked_ref(mat, block)
    _on_card("cholesky_blocked: mat", mat)
    if _wide_kernel(mat.shape[-1], block):
        cholesky_blocked.launches += 1
        return _chol_wide(mat, None, None)[0]
    cholesky_blocked.composed += 1
    return _blocked(mat, block, cholesky, triangular_inverse_lower)


def _cholesky_cascade_fwd(mat: torch.Tensor, jit: torch.Tensor, factors):
    if mat.device.type == "cpu":
        return cholesky_cascade_ref(mat, jit, factors)
    _on_card("cholesky_cascade: mat", mat)
    batch, p = mat.shape[:-2], mat.shape[-1]
    _check("cholesky_cascade: jit", jit, batch, mat.device)
    if _wide_kernel(p):
        cholesky_cascade.launches += 1
        return _chol_wide(mat, jit, factors)
    factor = cholesky if p <= MAX_P else cholesky_blocked
    (l,), ld, f = _escalate(mat.reshape(-1, p, p), jit.reshape(-1),
                            _factors(factors), _cascade_attempt(factor))
    cholesky_cascade.composed += 1
    return l.reshape(mat.shape), ld.reshape(batch), f.reshape(batch)


# ---------------------------------------------------------------------------
# backward passes (the JAX package's custom VJPs)
# ---------------------------------------------------------------------------

def _mt(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular projection with halved diagonal (Cholesky
    pullback)."""
    return torch.tril(x) - 0.5 * torch.diag_embed(
        torch.diagonal(x, dim1=-2, dim2=-1))


def _kernel_solve(l, b, trans):
    return solve_triangular_batched(l, b.contiguous(), trans)


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat):
        l = _cholesky_fwd(mat)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    @once_differentiable
    def backward(ctx, lbar):
        l, = ctx.saved_tensors
        return cholesky_pullback(l, lbar.contiguous())[0]


class _TriInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        y = _tri_inv_fwd(l)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar):
        set_matmul_precision()
        y, = ctx.saved_tensors
        yt = _mt(y)
        return -torch.tril(yt @ (ybar @ yt))


class _TriSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, b, transpose):
        x = _tri_solve_fwd(l, b, transpose)
        ctx.transpose = transpose
        ctx.save_for_backward(l, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar):
        # x = op(L)^-1 b:  bbar = op(L)^-T xbar,  Lbar = -tril(op'(bbar x^T))
        set_matmul_precision()
        l, x = ctx.saved_tensors
        bbar = _kernel_solve(l, xbar, not ctx.transpose)
        g = x @ _mt(bbar) if ctx.transpose else bbar @ _mt(x)
        return -torch.tril(g), bbar, None


def _trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def _torch_solve(l, b, trans):
    if trans:
        return torch.linalg.solve_triangular(_mt(l), b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def _chol_pullback(l, lbar, ldbar, f):
    """The Cholesky pullback of a factor ``l``: one :func:`cholesky_pullback`
    up to P = 64; wider the composition with torch's solve (cuBLAS on the
    card), as the JAX cascade's JVP solves with XLA there."""
    if l.shape[-1] <= MAX_P:
        return cholesky_pullback(l, lbar, ldbar, f)
    set_matmul_precision()
    return _pullback(l, lbar, ldbar, f, _torch_solve)


def _jittered_cholesky_backward(ctx, lbar, ldbar):
    """Backward of a jittered factorization ``(L, ld, f)`` of ``mat + f jit
    I``, linearized at the selected factor (K2, KC)."""
    l, f = ctx.saved_tensors
    lbar = torch.zeros_like(l) if lbar is None else lbar.contiguous()
    ldbar = None if ldbar is None else ldbar.contiguous()
    f = f if ctx.needs_input_grad[1] else None
    abar, jbar = _chol_pullback(l, lbar, ldbar, f)
    return abar, jbar, None


class _CholeskyJittered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, jit, factors):
        l, ld, f = _cholesky_jittered_fwd(mat, jit, factors)
        ctx.mark_non_differentiable(f)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(l, f)
        return l, ld, f

    @staticmethod
    @once_differentiable
    def backward(ctx, lbar, ldbar, _fbar):
        return _jittered_cholesky_backward(ctx, lbar, ldbar)


class _CholeskyCascade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, jit, factors):
        l, ld, f = _cholesky_cascade_fwd(mat, jit, factors)
        ctx.mark_non_differentiable(f)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(l, f)
        return l, ld, f

    @staticmethod
    @once_differentiable
    def backward(ctx, lbar, ldbar, _fbar):
        return _jittered_cholesky_backward(ctx, lbar, ldbar)


class _CholeskyBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, block):
        l = _cholesky_blocked_fwd(mat, block)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    @once_differentiable
    def backward(ctx, lbar):
        l, = ctx.saved_tensors
        return _chol_pullback(l, lbar.contiguous(), None, None)[0], None


def _leaf_posterior_pullback(x, libar, ldqbar):
    """``Kbar`` of ``K_q = K_leaf + A_oo + fq jeff I`` from the saved
    inverse factor ``X = chol(K_q)^-1`` (flat ``[n, P, P]``).

    ``ld_post = 1/2 logdet K_q`` gives ``1/2 ldqbar X^T X``; ``X = L^-1``
    gives ``Lbar = -X^T Xbar X^T``, mapped by the Cholesky pullback
    ``phi(L^T Lbar)`` at ``L = X^-1``. ``L^T Lbar = -(X L)^T Xbar X^T =
    -Xbar X^T`` exactly, so ``L`` is never formed (the JAX package inverts
    ``X`` back, K3, and multiplies).

    The products are taken in float64 and rounded once: ``X`` carries
    ``1/sqrt(lambda_min(K_q))``, and in float32 these products put the
    N=10^4 bench tree's gradient 1.7e-3 off the same sweep in float64 on an
    NVIDIA H100 (700 W), against 3e-4 with them in float64
    (``tools/grad_precision_n10k.py``)."""
    xd = x.double()
    xt = _mt(xd)
    kbar = torch.zeros_like(xd)
    if ldqbar is not None:
        kbar = 0.5 * ldqbar.double()[:, None, None] * (xt @ xd)
    if libar is not None:
        raw = xt @ (_phi(-(libar.double() @ xt)) @ xd)
        kbar = kbar + 0.5 * (raw + _mt(raw))
    return kbar.to(x.dtype)


def _leaf_prior_pullback(k_leaf, jeff_sel, ldpbar):
    """``Kbar`` of the prior block: ``1/2 ldpbar K_p^-1`` with ``K_p =
    K_leaf + jeff_sel I`` at the selected factor, inverted through its
    Cholesky factor (K4, then K3)."""
    eye = torch.eye(k_leaf.shape[-1], dtype=k_leaf.dtype,
                    device=k_leaf.device)
    li_p = triangular_inverse_lower(
        cholesky(k_leaf + jeff_sel[:, None, None] * eye))
    return 0.5 * ldpbar[:, None, None] * (_mt(li_p) @ li_p)


class _LeafFactor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c_own, kmask, a_oo, jitter, factors):
        li, ldp, ldq, fp, fq = _leaf_factor_fwd(c_own, kmask, a_oo, jitter,
                                                factors)
        ctx.mark_non_differentiable(fp, fq)
        ctx.set_materialize_grads(False)
        ctx.jitter = float(jitter)
        ctx.save_for_backward(c_own, kmask, li, fp, fq)
        return li, ldp, ldq, fp, fq

    @staticmethod
    @once_differentiable
    def backward(ctx, libar, ldpbar, ldqbar, _fpbar, _fqbar):
        set_matmul_precision()
        c_own, kmask, li, fp, _ = ctx.saved_tensors
        cbar, abar = leaf_pullback(
            c_own, kmask, li, fp,
            None if libar is None else libar.contiguous(),
            None if ldpbar is None else ldpbar.contiguous(),
            None if ldqbar is None else ldqbar.contiguous(), ctx.jitter)
        # no gradient to the mask or the structural jitter scale
        return cbar, None, abar, None, None


class _CholeskyLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, jit, factors):
        ld, f = _cholesky_logdet_fwd(mat, jit, factors)
        ctx.mark_non_differentiable(f)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mat, jit, f)
        return ld, f

    @staticmethod
    @once_differentiable
    def backward(ctx, ldbar, _fbar):
        # Kbar = 1/2 ldbar K_sel^-1, refactored at the selected factor
        if ldbar is None:
            return None, None, None
        set_matmul_precision()
        mat, jit, f = ctx.saved_tensors
        p = mat.shape[-1]
        kbar = _leaf_prior_pullback(
            mat.reshape(-1, p, p), (f * jit).reshape(-1),
            ldbar.reshape(-1)).reshape(mat.shape)
        jbar = f * _trace(kbar) if ctx.needs_input_grad[1] else None
        return kbar, jbar, None


class _CholeskyInvLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, jit, factors):
        x, ld, f = _cholesky_inv_logdet_fwd(mat, jit, factors)
        ctx.mark_non_differentiable(f)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, f)
        return x, ld, f

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar, ldbar, _fbar):
        if xbar is None and ldbar is None:
            return None, None, None
        set_matmul_precision()
        x, f = ctx.saved_tensors
        p = x.shape[-1]
        kbar = _leaf_posterior_pullback(
            x.reshape(-1, p, p),
            None if xbar is None else xbar.reshape(-1, p, p),
            None if ldbar is None else ldbar.reshape(-1)).reshape(x.shape)
        jbar = f * _trace(kbar) if ctx.needs_input_grad[1] else None
        return kbar, jbar, None


# ---------------------------------------------------------------------------
# public, differentiable entry points
# ---------------------------------------------------------------------------

def _apply(function, forward: Callable, *args):
    """``function.apply(*args)`` where a gradient can flow into a tensor
    argument; else ``forward(*args)`` alone: the same outputs without the
    autograd Function's host cost (a forward-only sweep's every call)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return function.apply(*args)
    return forward(*args)


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky ``[..., P, P] -> [..., P, P]``; an indefinite
    or zero pivot leaves NaN in its column and the trailing block, as the
    JAX kernel does (the upper triangle stays 0)."""
    return _apply(_Cholesky, _cholesky_fwd, mat)


_counter(cholesky, "launches")


def triangular_inverse_lower(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batch of lower triangles ``[..., P, P]`` (only
    the lower triangle is read; exact zeros above the diagonal, but where
    a zero diagonal entry or a non-finite entry spreads inf and NaN over
    whole rows, as the twin's division and whole-row updates do);
    differentiable with ``Lbar = -tril(Y^T Ybar Y^T)``, ``Y = L^-1``.

    On the card, by width: P <= 64 is one launch of
    ``ops/cuda/csrc/tri_inv.cu`` (counted in ``.launches``), 64 < P <= 256
    one launch of ``ops/cuda/csrc/tri_inv_wide.cu`` (in
    ``.wide_launches``; no host synchronization), wider the composition
    :func:`_tri_inv_blocked` over the first kernel and ``torch.matmul``
    (in ``.composed``). On the CPU the same composition over the twin,
    which is the twin itself up to 64."""
    return _apply(_TriInv, _tri_inv_fwd, l)


_counter(triangular_inverse_lower, "launches", "wide_launches")
triangular_inverse_lower.composed = 0


def solve_triangular_batched(l: torch.Tensor, b: torch.Tensor,
                             transpose: bool = False) -> torch.Tensor:
    """Batched triangular solve with a lower factor: ``L x = b`` (or
    ``L^T x = b`` with ``transpose=True``); ``b`` is ``[..., P, Q]``, only
    ``L``'s lower triangle is read.

    On the card one launch of ``ops/cuda/csrc/tri_solve.cu`` for P <= 64
    and any Q (a block a member and slab of :func:`solve_cols` columns, at
    the width tier :func:`tile_tier`); on the CPU the twin."""
    return _apply(_TriSolve, _tri_solve_fwd, l, b, bool(transpose))


_counter(solve_triangular_batched, "launches")


def cholesky_jittered(mat: torch.Tensor, jit: torch.Tensor, factors=FACTORS):
    """Lower Cholesky factor of ``mat + f*jit*I`` with escalation.

    ``mat [..., P, P]``, ``jit [...]`` one jitter magnitude per matrix.
    Returns ``(L [..., P, P], ld [...], f [...])``: the factor, its
    log-pivot sum and the selected escalation factor. Differentiable in
    ``mat`` and ``jit`` (``jitbar = f trace(matbar)``) at the selected
    factor; ``f`` is not differentiable.
    """
    out = _apply(_CholeskyJittered, _cholesky_jittered_fwd, mat, jit,
                 tuple(factors))
    if _prof.ON:
        _prof.escalations("K2", out[2])
    return out


_counter(cholesky_jittered, "launches")


def leaf_factor(c_own: torch.Tensor, kmask: torch.Tensor, a_oo: torch.Tensor,
                jitter: float, factors=FACTORS):
    """Fused MRA leaf factorization stage.

    Args: ``c_own [..., P, P]`` conditional covariance, ``kmask [..., P]``
    own-knot mask (float 0/1; broadcast to ``c_own``'s batch, so one mask
    of the nodes serves ``C`` parameter sets), ``a_oo [..., P, P]`` data
    Gram block —
    required to vanish outside the knot rows/columns, which the sweep's
    ``B_own``-based Gram guarantees — and ``jitter``, the raw
    scale-relative jitter.

    With ``K_leaf = c_own ⊙ kk^T + diag(1-k)`` and ``s = mean|diag K_leaf|
    + 1``, returns ``(Li, ld_prior, ld_post, fp, fq)``: ``Li = chol(K_leaf
    + A_oo + fq*jitter*s*I)^-1``, the prior and posterior Cholesky
    log-diagonal sums and the selected prior/posterior factors.
    Differentiable in ``c_own`` and ``a_oo`` by :func:`leaf_pullback`,
    which refactors the prior block at ``fp`` and inverts that factor, and
    takes the posterior pullback from ``Li`` in float64 products.
    """
    kmask = kmask.expand(c_own.shape[:-1]).contiguous()
    out = _apply(_LeafFactor, _leaf_factor_fwd, c_own, kmask, a_oo,
                 float(jitter), tuple(factors))
    if _prof.ON:
        _prof.escalations("K1", out[3], out[4])
    return out


_counter(leaf_factor, "launches")


def cholesky_logdet(mat: torch.Tensor, jit: torch.Tensor, factors=FACTORS):
    """Log-determinant half ``sum_j log L_jj`` of ``chol(mat + f*jit*I)``
    with escalation, the factor never formed (``1/2 sum_j log d_j`` over
    the downdated pivots, no square root).

    ``mat [..., P, P]`` (P <= 64 on the card), ``jit [...]``. Returns
    ``(ld [...], f [...])``, ``f`` the selected factor (not
    differentiable). The backward is the JAX VJP: ``matbar = 1/2 ldbar
    K_sel^-1`` with ``K_sel`` refactored at ``f`` (K4) and inverted (K3),
    ``jitbar = f trace(matbar)``.
    """
    out = _apply(_CholeskyLogdet, _cholesky_logdet_fwd, mat, jit,
                 tuple(factors))
    if _prof.ON:
        _prof.escalations("K6", out[1])
    return out


_counter(cholesky_logdet, "launches")


def cholesky_inv_logdet(mat: torch.Tensor, jit: torch.Tensor,
                        factors=FACTORS):
    """``(X, ld, f)``: ``X = chol(mat + f*jit*I)^-1``, its log-diagonal sum
    and the selected factor, with escalation; the inverse is formed
    alongside the factorization and the factor itself never is.

    ``mat [..., P, P]`` (P <= 64 on the card), ``jit [...]``.
    Differentiable in ``mat`` and ``jit`` (``jitbar = f trace(matbar)``).

    The backward departs from the JAX VJP in two ways, both found on the
    N=10^4 gradient (R = 1e-4, where ``X`` carries ``1/sqrt(lambda_min)``):
    it takes the products ``X^T X`` and ``X^T phi(.) X`` in float64 and
    rounds once, and it uses the exact identity ``L^T Lbar = -Xbar X^T``
    instead of re-inverting ``X`` to ``L`` (K3) and multiplying — the
    pullback K1's posterior half already uses
    (:func:`_leaf_posterior_pullback`). In float32 those products put that
    gradient 2.1e-3 off its float64 golden, over the 2e-3 budget.
    """
    out = _apply(_CholeskyInvLogdet, _cholesky_inv_logdet_fwd, mat, jit,
                 tuple(factors))
    if _prof.ON:
        _prof.escalations("K7", out[2])
    return out


_counter(cholesky_inv_logdet, "launches")


def cholesky_blocked(mat: torch.Tensor, block: int = MAX_P) -> torch.Tensor:
    """Batched lower Cholesky for any width (K8), with the NaN semantics of
    :func:`cholesky`: an indefinite block leaves NaN from its failing
    column on, in its own member only. A float32 input has its panels and
    trailing downdates carried in float64 (see :func:`_blocked`).

    On the card, by width: 64 < P <= 256 with ``block = 64`` is one launch
    of ``ops/cuda/csrc/chol_wide.cu`` (counted in ``.launches``); any other
    width or block runs the composition :func:`_blocked` — K4 on the
    ``block``-wide diagonal blocks, K3 to invert them, ``torch.matmul`` for
    the panel and the downdate — counted in ``.composed``. On the CPU the
    twin. Differentiable by the Cholesky pullback of the factor
    (symmetric in ``mat``), as :func:`cholesky_cascade`."""
    return _apply(_CholeskyBlocked, _cholesky_blocked_fwd, mat, int(block))


_counter(cholesky_blocked, "launches")
cholesky_blocked.composed = 0


def cholesky_cascade(mat: torch.Tensor, jit: torch.Tensor, factors=FACTORS):
    """Jittered lower Cholesky factor of ``mat + f*jit*I`` for any width,
    escalated per member while its factor has a non-finite entry (KC, the
    counterpart of the JAX package's ``_chol_cascade`` and
    ``cholesky_cascade_lanes``).

    On the card, by width: 64 < P <= 256 is one launch of
    ``ops/cuda/csrc/chol_wide.cu``, which escalates each member in the
    kernel (no host synchronization; counted in ``.launches``); other
    widths run :func:`_escalate` over K4 (P <= 64) or
    :func:`cholesky_blocked` attempts, refactoring only the members that
    failed (counted in ``.composed``). The JAX package's three
    unconditional attempts exist only for TPU compile safety.

    Returns ``(L, ld, f)`` as :func:`cholesky_jittered` does; differentiable
    in ``mat`` and ``jit`` at the selected factor.
    """
    out = _apply(_CholeskyCascade, _cholesky_cascade_fwd, mat, jit,
                 tuple(factors))
    if _prof.ON:
        _prof.escalations("KC", out[2])
    return out


_counter(cholesky_cascade, "launches")
cholesky_cascade.composed = 0
