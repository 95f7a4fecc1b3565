"""Batched small-matrix factorizations of the MRA sweep
(counterpart of ``pymra_tpu/ops/pallas/linalg.py``).

Two entry points, each a wrapper that chooses by the device of its input:

* :func:`cholesky_jittered` — lower Cholesky factor of ``A + f*jit*I`` with
  per-member jitter escalation (replaces the TPU kernel K2,
  ``_chol_jittered_kernel``); CUDA kernel in
  ``ops/cuda/csrc/cholesky_jittered.cu``.
* :func:`leaf_factor` — the fused leaf stage: prior log-determinant and
  posterior inverse factor + log-determinant (replaces K1,
  ``_kleaf_logdet_kernel`` + ``_kleaf_inv_logdet_kernel``); CUDA kernel in
  ``ops/cuda/csrc/leaf_factor.cu``.

A CPU tensor runs the plain PyTorch twin (``*_ref``), an explicit batched
column loop with the kernel's arithmetic. A CUDA tensor launches the hand
written kernel or raises; there is no fallback. Each wrapper counts its
launches in ``.launches``; each twin counts the calls it gets with CUDA
tensors in ``.cuda_calls`` (only kernel-versus-twin comparisons make any).

Escalation contract (both): a member is retried at the next factor of
``factors`` while its log-pivot sum is non-finite — NaN for a negative
pivot, -inf for an exact zero. Members that succeed keep their first
result; a member that fails every factor keeps its last, NaN, result and
reports the last factor.
"""
from __future__ import annotations

from typing import Callable

import torch

from pymra_torch.ops.cuda import build

__all__ = ["FACTORS", "cholesky_jittered", "cholesky_jittered_ref",
           "leaf_factor", "leaf_factor_ref"]

FACTORS = (1.0, 1e2, 1e4)
#: widest block the single-block kernels take; wider needs K8
#: ``cholesky_blocked``, which is not ported yet
MAX_P = 64


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
    """Right-looking Cholesky of ``[n, P, P]``: (factor, sum log pivots)."""
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


# ---------------------------------------------------------------------------
# CUDA wrappers
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
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{name}: the CUDA kernels are forward-only; their gradient is "
            "still to be ported (ROADMAP queue 2)")


def _check_square(name: str, t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    if t.ndim < 2 or t.shape[-1] != t.shape[-2] or t.shape[-1] < 1:
        raise ValueError(f"{name}: expected [..., P, P], got "
                         f"{tuple(t.shape)}")
    p = t.shape[-1]
    if p > MAX_P:
        raise NotImplementedError(
            f"{name}: P={p} > {MAX_P} needs K8 cholesky_blocked, which is "
            "not ported yet (ROADMAP queue 2)")
    return p


def _factors(factors) -> tuple[float, float, float]:
    if len(factors) != 3:
        raise ValueError(f"the CUDA kernels take exactly 3 escalation "
                         f"factors, got {factors}")
    return tuple(float(f) for f in factors)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cholesky_jittered(mat: torch.Tensor, jit: torch.Tensor, factors=FACTORS):
    """Lower Cholesky factor of ``mat + f*jit*I`` with escalation.

    ``mat [..., P, P]``, ``jit [...]`` one jitter magnitude per matrix.
    Returns ``(L [..., P, P], ld [...], f [...])``: the factor, its
    log-pivot sum and the selected escalation factor.
    """
    if mat.device.type == "cpu":
        return cholesky_jittered_ref(mat, jit, factors)
    lib = build.load_library()
    p = _check_square("cholesky_jittered: mat", mat)
    batch = mat.shape[:-2]
    _check("cholesky_jittered: mat", mat, mat.shape, mat.device)
    _check("cholesky_jittered: jit", jit, batch, mat.device)
    f0, f1, f2 = _factors(factors)
    out = torch.empty_like(mat)
    ld = torch.empty(batch, dtype=mat.dtype, device=mat.device)
    f = torch.empty(batch, dtype=mat.dtype, device=mat.device)
    n = out.numel() // (p * p)
    if n:
        rc = lib.pymra_cholesky_jittered(
            mat.data_ptr(), jit.data_ptr(), out.data_ptr(), ld.data_ptr(),
            f.data_ptr(), n, p, f0, f1, f2, mat.device.index or 0,
            _stream(mat.device))
        if rc:
            raise RuntimeError(f"cholesky_jittered kernel launch failed: "
                               f"CUDA error {rc}")
        cholesky_jittered.launches += 1
    return out, ld, f


cholesky_jittered.launches = 0


def leaf_factor(c_own: torch.Tensor, kmask: torch.Tensor, a_oo: torch.Tensor,
                jitter: float, factors=FACTORS):
    """Fused MRA leaf factorization stage.

    Args: ``c_own [..., P, P]`` conditional covariance, ``kmask [..., P]``
    own-knot mask (float 0/1), ``a_oo [..., P, P]`` data Gram block —
    required to vanish outside the knot rows/columns, which the sweep's
    ``B_own``-based Gram guarantees — and ``jitter``, the raw
    scale-relative jitter.

    With ``K_leaf = c_own ⊙ kk^T + diag(1-k)`` and ``s = mean|diag K_leaf|
    + 1``, returns ``(Li, ld_prior, ld_post, fp, fq)``: ``Li = chol(K_leaf
    + A_oo + fq*jitter*s*I)^-1``, the prior and posterior Cholesky
    log-diagonal sums and the selected prior/posterior factors.
    """
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
    if n:
        rc = lib.pymra_leaf_factor(
            c_own.data_ptr(), kmask.data_ptr(), a_oo.data_ptr(),
            float(jitter), li.data_ptr(), ldp.data_ptr(), ldq.data_ptr(),
            fp.data_ptr(), fq.data_ptr(), n, p, f0, f1, f2,
            c_own.device.index or 0, _stream(c_own.device))
        if rc:
            raise RuntimeError(f"leaf_factor kernel launch failed: CUDA "
                               f"error {rc}")
        leaf_factor.launches += 1
    return li, ldp, ldq, fp, fq


leaf_factor.launches = 0
