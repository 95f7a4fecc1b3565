"""Bessel K of fractional order and the general-smoothness Matern
(counterpart of ``pymra_tpu/ops/special.py``).

On the card the general-nu Matern is one launch of
``ops/cuda/csrc/matern.cu`` (:func:`matern_cuda`: the covariance of ``C``
parameter sets from the points, forward and backward, counted in
``.launches`` and ``.pullback_launches``), which reads the Bessel pair from
a table built once per smoothness (:func:`matern_table`); on the CPU its
plain twin,
:func:`matern_general` over :func:`kv_frac`, below. The twins count the
calls they get with CUDA tensors in ``.cuda_calls``.

``kv_frac`` — the modified Bessel function of the second kind ``K_nu(x)``
for a *static* real order ``nu`` and a tensor argument ``x`` — by the
classic two-regime scheme: Temme's series for ``x <= 2``, Steed's continued
fraction CF2 above (Numerical Recipes ch. 6.7; Temme 1975), with fixed
iteration counts. It is plain elementwise torch arithmetic, so it runs on
any device and autograd differentiates it in ``x`` (and through ``x`` in a
kernel's length scale). The order-dependent constants are evaluated on the
host with ``math``; the order selects the recurrence depth, so it stays a
Python number, as the reference bakes ``nu`` into its sklearn kernel.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from pymra_torch.ops.cuda import build
from pymra_torch.ops.distances import _as2d, dist
from pymra_torch.ops.cuda.launch import counter as _counter
from pymra_torch.ops.cuda.launch import launched as _launched
from pymra_torch.ops.cuda.launch import ptr as _ptr
from pymra_torch.ops.cuda.launch import where as _where
from pymra_torch.utils import profiling as _prof

__all__ = ["kv_frac", "matern_general", "matern_cuda", "matern_table",
           "MaternTable"]

_SERIES_ITERS = 40  # Temme series terms (x <= 2); converges ~geometrically
_CF2_ITERS = 64  # Steed CF2 iterations (x > 2)


def _host_gam12(mu: float) -> tuple[float, float, float, float]:
    """Temme's gamma factors for a static fractional order ``mu`` in [0, 1).

    gam1 = (1/Gamma(1-mu) - 1/Gamma(1+mu)) / (2 mu)   (limit -euler_gamma)
    gam2 = (1/Gamma(1-mu) + 1/Gamma(1+mu)) / 2
    gampl = Gamma(1+mu), gammi = Gamma(1-mu)
    """
    gampl = math.gamma(1.0 + mu)
    gammi = math.gamma(1.0 - mu)
    if abs(mu) < 1e-12:
        # 1/Gamma(1 +/- mu) = 1 +/- euler_gamma*mu + O(mu^2), so the
        # difference quotient tends to -euler_gamma
        gam1 = -0.5772156649015329
    else:
        gam1 = (1.0 / gammi - 1.0 / gampl) / (2.0 * mu)
    gam2 = (1.0 / gammi + 1.0 / gampl) / 2.0
    return gam1, gam2, gampl, gammi


def _kv_series(x: torch.Tensor, mu: float):
    """Temme's series for (K_mu, K_{mu+1}), valid for 0 < x <= 2 and
    0 <= mu < 1."""
    gam1, gam2, gampl, gammi = _host_gam12(mu)
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < 1e-12 else pimu / math.sin(pimu)

    d = -torch.log(x / 2.0)
    e = mu * d
    # sinh(e)/e with the removable singularity at e=0
    tiny = e.abs() < 1e-12
    e_safe = torch.where(tiny, torch.ones_like(e), e)
    fact2 = torch.where(tiny, torch.ones_like(e), torch.sinh(e_safe) / e_safe)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ee = torch.exp(e)  # = (x/2)^(-mu)
    p = 0.5 * ee * gampl  # p_0 = (1/2)(x/2)^(-mu) Gamma(1+mu)
    q = 0.5 * gammi / ee  # q_0 = (1/2)(x/2)^(+mu) Gamma(1-mu)
    c = torch.ones_like(x)
    dd = x * x / 4.0
    total, total1 = ff, p
    for i in range(1, _SERIES_ITERS + 1):
        i = float(i)
        ff = (i * ff + p + q) / (i * i - mu * mu)
        c = c * dd / i
        p = p / (i - mu)
        q = q / (i + mu)
        total = total + c * ff
        total1 = total1 + c * (p - i * ff)
    return total, total1 * 2.0 / x


def _kv_cf2(x: torch.Tensor, mu: float):
    """Steed's CF2 for (K_mu, K_{mu+1}), valid for x > 2 (any mu in
    [0, 1)).

    Numerical Recipes' ``bessik`` sums ``S = 1 + sum_i Q_i dh_i``: partial
    sums ``Q_i = sum_{k<=i} C_k q_k`` that grow without bound (past 1e48 by
    step 64 at x=50) against increments ``dh_i`` of ``h`` that decay
    faster. Carried apart, as the JAX package carries them, they leave
    float32's range within the fixed 64 steps, and every x > 2 comes out
    NaN there. Here each is carried already multiplied by ``dh_i``: ``A_i
    = Q_i dh_i = A_{i-1} f_i + C_i q_i dh_i`` with ``f_i = dh_i /
    dh_{i-1}``, and the recurrence's last two terms as ``C_i q_{i-1} dh_i``
    and ``C_i q_i dh_i`` (rescaled by ``C_i / C_{i-1} = -a_i / i`` and by
    ``f_i`` each step): the same sums in exact arithmetic, all of them
    bounded."""
    a1 = 0.25 - mu * mu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    dh = d
    # C_1 q_0 dh_1 and C_1 q_1 dh_1 (q_0 = 0, q_1 = 1, C_1 = a1); A_1
    t1 = torch.zeros_like(x)
    t2 = a1 * dh
    acc = t2
    s = 1.0 + acc
    for i in range(2, _CF2_ITERS + 1):
        i = float(i)
        # closed form of NR's running "a -= 2*(i-1)" from a = -a1:
        # a_i = -a1 - 2*sum_{k=2..i}(k-1) = -a1 - i(i-1)
        a = -a1 - (i - 1.0) * i
        scale = -a / i  # C_i / C_{i-1}
        t1, t2 = t2 * scale, (t1 - b * t2) * (scale / a)
        b = b + 2.0
        d = 1.0 / (b + a * d)
        f = b * d - 1.0  # dh_i / dh_{i-1}
        dh = f * dh
        h = h + dh
        t1, t2 = t1 * f, t2 * f
        acc = acc * f + t2
        s = s + acc
    h = a1 * h
    k_mu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    return k_mu, k_mu * (mu + x + 0.5 - h) / x


def kv_frac(nu: float, x: torch.Tensor) -> torch.Tensor:
    """``K_nu(x)`` for a static ``nu`` and a tensor ``x > 0``;
    differentiable in ``x``.

    Both regimes are evaluated on range-clamped copies of ``x`` and
    selected with ``torch.where`` (the clamping keeps the inactive branch
    finite, so reverse-mode gradients stay NaN-free: the double-where
    rule). The fractional-order pair (K_mu, K_{mu+1}) is lifted to order
    ``nu`` by the stable upward recurrence
    K_{m+1} = K_{m-1} + (2 m / x) K_m.
    """
    if torch.is_tensor(x) and x.is_cuda:
        kv_frac.cuda_calls += 1
    nu = abs(float(nu))  # K_{-nu} = K_nu
    n_up = int(nu + 0.5)  # recurrence steps; mu in [-0.5, 0.5)
    mu = nu - n_up
    if mu < 0:  # Temme's series wants mu in [0, 1): one step down
        mu += 1.0
        n_up -= 1

    x = torch.as_tensor(x)
    small = x <= 2.0
    xs = torch.clamp(x, max=2.0)  # series-safe copy
    xl = torch.clamp(x, min=2.0)  # CF2-safe copy
    ks_mu, ks_mup1 = _kv_series(
        torch.clamp(xs, min=torch.finfo(x.dtype).tiny), mu)
    kl_mu, kl_mup1 = _kv_cf2(xl, mu)
    k_mu = torch.where(small, ks_mu, kl_mu)
    if n_up == 0:
        return k_mu
    k_prev, k_cur = k_mu, torch.where(small, ks_mup1, kl_mup1)
    order = mu + 1.0
    for _ in range(n_up - 1):
        k_prev, k_cur = k_cur, k_prev + (2.0 * order / x) * k_cur
        order += 1.0
    return k_cur


kv_frac.cuda_calls = 0


def matern_general(d: torch.Tensor, l, sig, nu: float) -> torch.Tensor:
    """Matern covariance for an arbitrary static smoothness ``nu``.

    ``sig * 2^(1-nu)/Gamma(nu) * s^nu K_nu(s)``, ``s = sqrt(2 nu) d / l``,
    with the removable singularity at d=0 taken exactly (value ``sig``).
    Differentiable in ``l``, ``sig`` and ``d``. Below float64, as the
    kernel does: ``l`` and ``sig`` rounded to ``d``'s precision, the rest
    in float64, the result rounded once (the series and the continued
    fraction in float32 move by ~1e-6 relative with the last bit of ``s``,
    so a batched and an unbatched call could disagree that much). Inside a
    traced call it adds the entries with ``s > 0`` to the counter
    ``cov_fallback_entries`` of the innermost open span, as the kernel
    counts those its table did not cover: the twin has no table, so the
    series or the continued fraction evaluates every one of them.
    """
    if d.is_cuda:
        matern_general.cuda_calls += 1
    nu = float(nu)
    dtype = d.dtype
    if dtype != torch.float64:
        l, sig = (torch.as_tensor(v, dtype=dtype, device=d.device).double()
                  for v in (l, sig))
        d = d.double()
    coef = 2.0 ** (1.0 - nu) / math.gamma(nu)
    s = math.sqrt(2.0 * nu) * d / l
    zero = s <= 0.0
    if _prof.ON and _prof.current_call() is not None:
        _prof.count("cov_fallback_entries", (s > 0.0).sum())
    s_safe = torch.where(zero, torch.ones_like(s), s)
    val = coef * s_safe ** nu * kv_frac(nu, s_safe)
    return (sig * torch.where(zero, torch.ones_like(val), val)).to(dtype)


matern_general.cuda_calls = 0


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

#: threads of a block of ``matern.cu`` (``kThreads``) and the most blocks
#: its pullback sums into partial sums (a grid-stride loop past that)
_THREADS = 256
_PULLBACK_BLOCKS = 2048
#: widest points the kernel takes; wider go through ``dist`` first, as
#: ``sqdist`` expands the product there
_MAX_DIM = 4


class MaternTable(NamedTuple):
    """The table ``matern.cu`` reads at one smoothness on one device."""

    #: float64, the exponentially scaled pair's polynomials (None where no
    #: table holds 1e-10 at this smoothness: the kernels then take the
    #: series or the continued fraction for every entry)
    table: torch.Tensor | None
    #: the table's largest relative error, against the series and CF2
    max_err: float
    #: host seconds to build it and hand it to the device
    build_s: float


_TABLES: dict = {}


def matern_table(nu: float, device) -> MaternTable:
    """The table of ``matern.cu`` for the smoothness ``nu`` on ``device``
    (``pymra_matern_table``: e^x x^nu K_nu(x) and e^x x^nu K_(nu-1)(x) as
    piecewise polynomials from 2^-12 to 2^10), built on the host at the
    first call for ``(nu, device)`` and kept: no launch refits it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (float(nu), device)
    rec = _TABLES.get(key)
    if rec is None:
        lib = build.load_library()
        t0 = time.perf_counter()
        n = lib.pymra_matern_table(float(nu), None, 0, None)
        host = torch.empty(n, dtype=torch.float64)
        err = torch.zeros(1, dtype=torch.float64)
        ok = lib.pymra_matern_table(float(nu), host.data_ptr(), n,
                                    err.data_ptr()) == n
        table = host.to(device) if ok else None
        rec = _TABLES[key] = MaternTable(table, float(err),
                                         time.perf_counter() - t0)
    return rec


def _matern_launch(a, b, d, l, sig, nu):
    """``[C, B, p, q]`` from the points ``a [B, p, dim]``, ``b [B, q,
    dim]`` (or the distances ``d [B, p, q]``) and ``l``, ``sig [C]``.
    Inside a traced call the kernel counts the entries times sets whose
    Bessel pair the table did not cover into a tensor kept as the span's
    counter ``cov_fallback_entries`` (read with the spans)."""
    lib = build.load_library()
    src = d if d is not None else a
    C = l.shape[0]
    B, p = src.shape[0], src.shape[1]
    q = d.shape[2] if d is not None else b.shape[1]
    dim = 0 if d is not None else a.shape[2]
    out = torch.empty((C, B, p, q), dtype=src.dtype, device=src.device)
    pairs = B * p * q
    if pairs:
        table = matern_table(nu, src.device).table
        fallback = None
        if _prof.ON and _prof.current_call() is not None:
            fallback = torch.zeros((), dtype=torch.int64, device=src.device)
            _prof.count("cov_fallback_entries", fallback)
        _launched("matern", lib.pymra_matern(
            _ptr(a), _ptr(b), _ptr(d), l.data_ptr(), sig.data_ptr(),
            out.data_ptr(), _ptr(table), _ptr(fallback),
            src.dtype == torch.float64, float(nu), C, pairs, p, q, dim,
            *_where(src)))
        matern_cuda.launches += 1
    return out


def _matern_pullback(a, b, d, l, sig, g, nu):
    """``(sum g d out / d l, sum g d out / d sig)``, each ``[C]`` in
    ``l``'s type: the kernel's float64 partial sums of its blocks, added
    here."""
    lib = build.load_library()
    src = d if d is not None else a
    C, pairs = g.shape[0], g[0].numel()
    p, q = g.shape[-2], g.shape[-1]
    dim = 0 if d is not None else a.shape[2]
    blocks = max(1, min(_PULLBACK_BLOCKS, -(-pairs // _THREADS)))
    partial = torch.zeros((2, C, blocks), dtype=torch.float64,
                          device=src.device)
    if pairs:
        _launched("matern_pullback", lib.pymra_matern_pullback(
            _ptr(a), _ptr(b), _ptr(d), l.data_ptr(), sig.data_ptr(),
            g.data_ptr(), _ptr(matern_table(nu, src.device).table),
            partial.data_ptr(), blocks, src.dtype == torch.float64,
            float(nu), C, pairs, p, q, dim, *_where(src)))
        matern_cuda.pullback_launches += 1
    sums = partial.sum(-1).to(l.dtype)
    return sums[0], sums[1]


class _Matern(torch.autograd.Function):
    """The kernel's covariance, differentiable in ``l`` and ``sig``; its
    backward is the pullback launch (span ``pymra.bwd.cov`` in a traced
    call's backward), which recomputes each entry from the points."""

    @staticmethod
    def forward(ctx, l, sig, a, b, d, nu):
        ctx.nu = nu
        ctx.call = _prof.current_call()
        ctx.save_for_backward(l, sig, a, b, d)
        return _matern_launch(a, b, d, l, sig, nu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        l, sig, a, b, d = ctx.saved_tensors
        sp = _prof.backward_span(ctx.call, "pymra.bwd.cov")
        gl, gsig = _matern_pullback(a, b, d, l, sig, g.contiguous(), ctx.nu)
        if sp is not None:
            sp.close()
        return gl, gsig, None, None, None, None


def _on_card(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matern_cuda: points on {a.device} and "
                         f"{b.device}, expected one CUDA device")


def matern_cuda(locs1, locs2, l, sig, nu: float, circular: bool = False):
    """The general-nu Matern of :func:`matern_general` on the card: one
    launch of ``ops/cuda/csrc/matern.cu`` for every parameter set, from the
    points ``locs1 [..., p, dim]`` and ``locs2 [..., q, dim]`` (None: locs1
    again), float32 or float64 on a CUDA device, and ``l``, ``sig`` each a
    number, a 0-dim tensor or ``C`` sets as ``[C, 1, ..., 1]`` (a batched
    :class:`pymra_torch.kernels.Kernel`'s). Returns ``[C, ..., p, q]`` (no
    ``C`` axis without a batched parameter), bit for bit the twin's
    distances, the Bessel functions in float64 rounded once.

    Differentiable in ``l`` and ``sig`` (one pullback launch, no tensor of
    the output's size saved), not in the points. Circular distances and
    points wider than four coordinates are formed by ``dist`` first and
    handed to the kernel as distances."""
    a = _as2d(torch.as_tensor(locs1))
    b = a if locs2 is None else _as2d(torch.as_tensor(locs2))
    _on_card(a, b)
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise TypeError(f"matern_cuda: the kernel takes float32 or float64 "
                        f"points, got {a.dtype} and {b.dtype}")
    if a.requires_grad or b.requires_grad:
        raise NotImplementedError(
            "matern_cuda: no gradient in the locations on the card")
    fl = dict(dtype=a.dtype, device=a.device)
    l, sig = (v if torch.is_tensor(v)
              else torch.tensor(float(v), dtype=torch.float64)
              for v in (l, sig))
    batched = l.dim() > 0 or sig.dim() > 0
    C = max(l.numel(), sig.numel())
    for name, v in (("l", l), ("sig", sig)):
        if v.numel() not in (1, C):
            raise ValueError(f"matern_cuda: {name} of shape "
                             f"{tuple(v.shape)} against {C} sets")
    lc = l.to(**fl).reshape(-1).expand(C).contiguous()
    sc = sig.to(**fl).reshape(-1).expand(C).contiguous()
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    p, q = a.shape[-2], b.shape[-2]
    if circular or a.shape[-1] > _MAX_DIM:
        d = dist(a, None if locs2 is None else b, circular=circular)
        d = d.expand(lead + (p, q)).reshape(-1, p, q).contiguous()
        pa = pb = None
    else:
        d = None
        pa = a.expand(lead + a.shape[-2:]).reshape(-1, p, a.shape[-1])
        pb = b.expand(lead + b.shape[-2:]).reshape(-1, q, b.shape[-1])
        pa, pb = pa.contiguous(), pb.contiguous()
    args = (lc, sc, pa, pb, d, float(nu))
    if torch.is_grad_enabled() and (lc.requires_grad or sc.requires_grad):
        out = _Matern.apply(*args)
    else:
        out = _matern_launch(pa, pb, d, lc, sc, float(nu))
    return out.reshape(((C,) if batched else ()) + lead + (p, q))


_counter(matern_cuda, "launches", "pullback_launches")
