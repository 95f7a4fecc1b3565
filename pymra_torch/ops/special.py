"""Bessel K of fractional order and the general-smoothness Matern
(counterpart of ``pymra_tpu/ops/special.py``).

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

import torch

__all__ = ["kv_frac", "matern_general"]

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


def matern_general(d: torch.Tensor, l, sig, nu: float) -> torch.Tensor:
    """Matern covariance for an arbitrary static smoothness ``nu``.

    ``sig * 2^(1-nu)/Gamma(nu) * s^nu K_nu(s)``, ``s = sqrt(2 nu) d / l``,
    with the removable singularity at d=0 taken exactly (value ``sig``).
    Differentiable in ``l``, ``sig`` and ``d``.
    """
    nu = float(nu)
    coef = 2.0 ** (1.0 - nu) / math.gamma(nu)
    s = math.sqrt(2.0 * nu) * d / l
    zero = s <= 0.0
    s_safe = torch.where(zero, torch.ones_like(s), s)
    val = coef * s_safe ** nu * kv_frac(nu, s_safe)
    return sig * torch.where(zero, torch.ones_like(val), val)
