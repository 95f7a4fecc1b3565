"""Plain reference of the MRA likelihood with the Matern covariance of
smoothness :data:`NU`: :mod:`portbench.reference.mra`'s model and sweep,
with

    K(d) = sig 2^(1-nu) / Gamma(nu) s^nu K_nu(s),  s = sqrt(2 nu) d / l,

``sig`` at ``d = 0`` (Stein 1999's Matern class, as sklearn's ``Matern``
that upstream pyMRA's ``MRATools.Matern`` wraps). The harness hands a
reference no configuration, so the smoothness is this module's constant;
a test holds it equal to the configuration's ``nu``.

The Bessel function is taken by a method of its own, independent of the
series and continued fraction of the program under test: the integral

    K_nu(x) = int_0^inf exp(-x cosh t) cosh(nu t) dt

by the trapezoid rule on ``NODES`` + 1 equally spaced nodes of ``[0,
acosh(1 + 45 / x)]`` (beyond that the integrand is below e^-45 of its
peak; the rule converges geometrically in the node count for an integrand
analytic in a strip), and the derivative in ``l`` from the same nodes
through ``d/dx [x^nu K_nu(x)] = -x^nu K_(nu-1)(x)``: both within 1e-12 of
``scipy.special.kv`` relative in float64 for 1e-4 <= x <= 100. The
covariance is a function of the distance alone, so each block's distances
are reduced once to their distinct values (``torch.unique``) and the
integral is evaluated once per distinct value and parameter set, in
chunks, then gathered back: the same numbers as evaluating it at every
entry. Plain PyTorch in the precision it is given (float64 for the
reference, float32 with TF32 matmuls for the calibration's control), no
import of the program under test.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import mra

__all__ = ["Reference", "NU", "bessel_k_pair"]

#: the smoothness of ``configs/grid1m_matern08.json``
NU = 0.8
#: trapezoid intervals per value
NODES = 96
#: values a chunk of the quadrature takes at once
CHUNK = 1 << 16


def bessel_k_pair(nu: float, x: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(K_nu(x), K_(nu-1)(x))`` for ``x > 0`` (a 1-D tensor) by the
    trapezoid rule above, in ``x``'s precision."""
    out_a, out_b = torch.empty_like(x), torch.empty_like(x)
    k = torch.arange(NODES + 1, dtype=x.dtype, device=x.device)
    w = torch.ones_like(k)
    w[0] = w[-1] = 0.5
    for i in range(0, x.numel(), CHUNK):
        xs = x[i:i + CHUNK, None]
        h = torch.acosh(1.0 + 45.0 / xs) / NODES
        t = h * k
        f = torch.exp(-xs * torch.cosh(t)) * w
        out_a[i:i + CHUNK] = (h * (f * torch.cosh(nu * t))).sum(-1)
        out_b[i:i + CHUNK] = (h * (f * torch.cosh((nu - 1.0) * t))).sum(-1)
    return out_a, out_b


class _Distances:
    """A block of distances as its distinct values and, for each entry,
    the index of its value."""

    def __init__(self, d: torch.Tensor):
        u, inv = torch.unique(d.reshape(-1), return_inverse=True)
        self.values, self.index = u, inv.reshape(d.shape)


class _Scaled(torch.autograd.Function):
    """``sig f`` at ``[C, U]`` values, with the derivatives the quadrature
    gave: ``d/dl = sig g / l`` and ``d/dsig = f`` (``l``, ``sig`` ``[C,
    1]``)."""

    @staticmethod
    def forward(ctx, l, sig, f, g):
        ctx.save_for_backward(l, sig, f, g)
        return sig * f

    @staticmethod
    def backward(ctx, gv):
        l, sig, f, g = ctx.saved_tensors
        return ((gv * g).sum(-1, keepdim=True) * sig / l,
                (gv * f).sum(-1, keepdim=True), None, None)


class Reference(mra.Reference):
    """:class:`portbench.reference.mra.Reference` with the Matern
    covariance of smoothness ``nu`` (:data:`NU` unless given): :meth:`sweep`
    takes ``[C]`` tensors ``l`` and ``sig``."""

    def __init__(self, tree, y, R: float, device="cpu",
                 dtype=torch.float64, jitter: float = 0.0, nu: float = NU):
        super().__init__(tree, y, R, device=device, dtype=dtype,
                         jitter=jitter)
        self.nu = float(nu)
        for lv in self.interior:
            if lv is not None:
                for key in ("d_oo", "d_oc"):
                    if key in lv:
                        lv[key] = _Distances(lv[key])
        for lv in self.leaf_levels:
            for key in ("d_qx", "d_xx"):
                lv[key] = _Distances(lv[key])

    def _cov(self, l: torch.Tensor, sig: torch.Tensor):
        """``cov(D) -> [C, *D's shape]`` for ``l``, ``sig`` ``[C, 1, 1,
        1]``."""
        nu = self.nu
        coef = 2.0 ** (1.0 - nu) / math.gamma(nu)
        lc, sc = l.reshape(-1, 1), sig.reshape(-1, 1)

        def cov(D: _Distances) -> torch.Tensor:
            with torch.no_grad():
                x = (math.sqrt(2.0 * nu) * D.values / lc).reshape(-1)
                pos = x > 0
                xp = x[pos]
                k_nu, k_m1 = bessel_k_pair(nu, xp)
                f = torch.ones_like(x)
                g = torch.zeros_like(x)
                f[pos] = coef * xp ** nu * k_nu
                g[pos] = coef * xp ** (nu + 1.0) * k_m1
            shape = (lc.shape[0], -1)
            v = _Scaled.apply(lc, sc, f.reshape(shape), g.reshape(shape))
            return v[:, D.index]

        return cov

    def sweep(self, l: torch.Tensor, sig: torch.Tensor,
              posterior: bool = False) -> dict:
        """:meth:`portbench.reference.mra.Reference.sweep` with the
        Matern covariance."""
        fl = dict(dtype=self.dtype, device=self.device)
        l = l.to(**fl).reshape(-1, 1, 1, 1)
        sig = sig.to(**fl).reshape(-1, 1, 1, 1)
        C = l.shape[0]
        r = self.r
        cov = self._cov(l, sig)
        prior = self._prior(cov)

        total = torch.zeros(C, **fl)
        msgs = [None] * (self.M + 1)
        leaf_state = []
        for lv in self.leaf_levels:
            m = lv["m"]
            Z, Cm = self._leaf_cov(lv, cov, prior[m - 1][0][:, lv["parent"]])
            o = lv["o"]
            D = (Cm * (o[:, :, None] * o[:, None, :])
                 + (self.R * o + (1.0 - o))[:, :, None] * mra._eye_like(Cm))
            LD = mra._chol(D)
            Wt = mra._solve(LD, Z.transpose(-1, -2) * o[:, :, None])
            yt = mra._solve(LD, lv["y0"][:, :, None].expand(C, -1, -1, -1))
            total = total + (mra._logdiag(LD)
                             + (yt * yt).sum((-2, -1))).sum(-1)
            H = Wt.transpose(-1, -2) @ Wt
            h = (Wt.transpose(-1, -2) @ yt)[..., 0]
            self._send(msgs, m - 1, lv["parent"], H, h)
            leaf_state.append((lv, Z.transpose(-1, -2), Cm, LD, Wt, yt))

        int_state = [None] * (self.M + 1)
        for k in range(self.M, -1, -1):
            if msgs[k] is None:
                continue
            H, h = msgs[k]
            S = k * r
            A = H[..., S:, S:] + torch.eye(r, **fl)
            if self.jitter:
                _, L, extra = prior[k]
                Li = mra._solve(L, mra._eye_like(L).expand_as(L))
                A = A + extra * (Li @ Li.transpose(-1, -2))
            LA = mra._chol(A)
            X = mra._solve(LA, H[..., S:, :S])
            t = mra._solve(LA, h[..., S:, None])
            total = total + (mra._logdiag(LA) - (t * t).sum((-2, -1))).sum(-1)
            int_state[k] = (LA, X, t)
            if k:
                self._send(msgs, k - 1, self.interior[k]["parent"],
                           H[..., :S, :S] - X.transpose(-1, -2) @ X,
                           h[..., :S] - (X.transpose(-1, -2) @ t)[..., 0])

        out = {"objective": total,
               "loglik": -0.5 * (total + self.n_obs * mra.LOG2PI)}
        if posterior:
            out["mean"], out["var"] = self._posterior(int_state, leaf_state,
                                                      C)
        return out
