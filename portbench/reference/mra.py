"""Plain reference of the MRA likelihood, its gradient and the posterior.

The multi-resolution approximation (Katzfuss 2017) of a covariance ``K`` on
a tree (:mod:`portbench.reference.planner`): every interior node at level
``k`` holds ``r`` knots, and the process is the sum of one term per level,

    w(s) = sum_k  C_k(s, Q_k) C_k(Q_k, Q_k)^-1 eta_k  +  e(s),

``C_k`` the covariance conditioned on the knots of every coarser ancestor
(conditioning on nested sets one after another is conditioning on their
union), ``e`` the remainder inside each leaf, with the covariance
``C_M(X, X)`` of the leaf's locations given all its ancestors' knots. In
whitened coordinates ``u_k = C_k(Q_k, Q_k)^-1/2 eta_k ~ N(0, I)`` the basis
of level ``k`` at ``s`` is the ``k``-th block of ``z(s) = G^-1 K(Q, s)``,
``G`` the Cholesky factor of ``K(Q, Q)`` over the ancestors' knots ``Q``
(its leading blocks factor the leading sets), so

    y_o = Z_o' u + e_o + eps,   eps ~ N(0, R),

with ``u ~ N(0, I)`` over every interior knot and ``e + eps`` independent
between leaves, ``D_v = C_M(X_v, X_v) + R`` on the observed locations of
leaf ``v``. This module evaluates that model directly: each leaf block
``D_v`` is factored, the whitened basis sends each interior node the
Gram matrix of its observations, and the interior precision ``I + Z' D^-1 Z``
is factored node by node from the deepest level up (its sparsity is the
tree's: a node couples only with its ancestors). The objective is
``log det Sigma_y + y' Sigma_y^-1 y`` over the observed entries, the
log-likelihood ``-(objective + n_obs log 2 pi) / 2``, and the posterior mean
and variance of ``w`` at every location follow by back substitution and
the selected inverse over each node's ancestor chain.

The configuration's jitter ``j`` is part of the model it states, and the
reference applies it where the configuration puts it, with the scale
``s(A) = mean|diag A| + 1`` taken as a constant (no gradient flows into it):

* each interior node's conditional knot covariance ``A = C_k(Q_k, Q_k)``
  has its diagonal floored at ``j`` times the prior variance and is
  factored as ``A + j s(A) I``; the chain factor ``G`` is built from these
  blocks, so every finer level conditions on the jittered knots;
* a leaf's conditional covariance ``C`` (floored the same way) enters
  through its own knots (the leaf's locations that no ancestor took):
  ``C_M = B (K + j s(K) I)^-1 B'`` with ``B = C[:, knots]`` and ``K`` equal
  to ``C`` on the knot pairs and to the identity elsewhere;
* each interior node's posterior precision gets ``j s(A + j s(A) I)`` added
  to its prior precision, in the prior's coordinates (whitened:
  ``j s L^-1 L^-T``, ``L`` the node's factor), while its prior
  log-determinant does not.

With ``j = 0`` the model is the plain MRA above.

Plain PyTorch in whatever precision it is given (float64 for the
reference; float32 with TF32 matmuls for the benchmark's control),
differentiable by autograd in the kernel's parameters. It imports nothing
of the program under test and takes nothing it made: the tree is planned
again by the frozen planner, the data is the benchmark's own.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = ["Reference", "tf32"]

LOG2PI = math.log(2.0 * math.pi)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in every float32 matmul inside the block (the control), or
    full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., p, 2] x [..., q, 2] -> [..., p, q]`` Euclidean distances."""
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    return torch.sqrt(dx * dx + dy * dy)


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor; a member that is not positive definite comes out
    NaN instead of raising (the result is then NaN, never a number)."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L.transpose(-1, -2), b, upper=True)


def _logdiag(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def _diag(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1)


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


class Reference:
    """The exponential-covariance MRA of ``tree`` with observations ``y``
    (``[N]``, NaN where missing), measurement-error variance ``R`` and the
    configuration's jitter.

    :meth:`sweep` takes ``[C]`` tensors ``l`` and ``sig`` (the covariance
    ``sig exp(-d / l)``) and returns each set's objective and
    log-likelihood and, on request, the posterior mean and variance
    ``[C, N]``; with ``l`` or ``sig`` requiring gradients the results are
    differentiable.
    """

    def __init__(self, tree, y, R: float, device="cpu",
                 dtype=torch.float64, jitter: float = 0.0):
        self.dtype = dtype
        self.device = torch.device(device)
        self.jitter = float(jitter)
        fl = dict(dtype=dtype, device=self.device)
        ix = dict(dtype=torch.long, device=self.device)
        locs = torch.as_tensor(tree.locs, **fl)
        N = len(tree.locs)
        self.N, self.r = N, tree.r
        y = torch.as_tensor(np.asarray(y, dtype=np.float64), **fl)
        self.R = float(R)

        # interior nodes: row of each node within its level, parent row,
        # own knots against themselves and against the ancestors' knots
        row = {}
        self.interior = []
        for m, nodes in enumerate(tree.levels):
            ints = [nd for nd in nodes if not nd.leaf]
            for i, nd in enumerate(ints):
                row[id(nd)] = i
            if not ints:
                self.interior.append(None)
                continue
            own = locs[torch.as_tensor(np.stack([nd.knots for nd in ints]),
                                       **ix)]
            lv = {"n": len(ints), "d_oo": _dist(own, own), "parent":
                  torch.tensor([row[id(nd.parent)] if nd.parent is not None
                                else 0 for nd in ints], **ix)}
            if m:
                chain = locs[torch.as_tensor(
                    np.stack([nd.chain() for nd in ints]), **ix)]
                lv["d_oc"] = _dist(own, chain)  # [n, r, m r]
            self.interior.append(lv)

        # leaves per level: points, masks, their ancestor chains' knots
        self.leaf_levels = []
        for m, nodes in enumerate(tree.levels):
            leaves = [nd for nd in nodes if nd.leaf]
            if not leaves:
                continue
            if m == 0:
                raise NotImplementedError("a tree that is one leaf")
            P = max(len(nd.locs) for nd in leaves)
            gidx = np.full((len(leaves), P), N, dtype=np.int64)
            knot = np.zeros((len(leaves), P), dtype=bool)
            for i, nd in enumerate(leaves):
                gidx[i, :len(nd.locs)] = nd.locs
                knot[i, :len(nd.locs)] = np.isin(nd.locs, nd.knots)
            chain = np.stack([nd.chain() for nd in leaves])  # [n, m r]
            gidx_t = torch.as_tensor(gidx, **ix)
            valid = gidx_t < N
            safe = gidx_t.clamp(max=N - 1)
            yv = torch.where(valid, y[safe], torch.full_like(y[safe],
                                                              float("nan")))
            obs = torch.isfinite(yv)
            X = locs[safe]
            Q = locs[torch.as_tensor(chain, **ix)]
            self.leaf_levels.append({
                "m": m, "gidx": gidx_t, "valid": valid,
                "o": obs.to(dtype), "k": torch.as_tensor(knot, **fl),
                "y0": torch.where(obs, yv, torch.zeros_like(yv)),
                "parent": torch.tensor([row[id(nd.parent)] for nd in leaves],
                                       **ix),
                "d_qx": _dist(Q, X), "d_xx": _dist(X, X),
            })
        self.M = len(tree.levels) - 1
        self.n_obs = float(sum(lv["o"].sum() for lv in self.leaf_levels))

    def _scale(self, a: torch.Tensor) -> torch.Tensor:
        """``j s(A)`` per member, ``[..., 1, 1]``, a constant."""
        s = _diag(a).abs().mean(-1).detach() + 1.0
        return (self.jitter * s)[..., None, None]

    def _floor(self, raw: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Conditional variances floored at ``j`` times the prior's."""
        if not self.jitter:
            return cond
        lift = torch.clamp(self.jitter * _diag(raw) - _diag(cond), min=0.0)
        return cond + lift[..., :, None] * _eye_like(cond)

    def _prior(self, cov):
        """Per interior level: each node's chain factor ``G [C, n, S+r,
        S+r]`` over its ancestors' knots and its own (coarsest first), its
        own block ``L`` and the jitter its posterior adds."""
        out = [None] * (self.M + 1)
        for k, lv in enumerate(self.interior):
            if lv is None:
                continue
            raw = cov(lv["d_oo"])
            if k == 0:
                A = raw
            else:
                Gp = out[k - 1][0][:, lv["parent"]]
                Zt = _solve(Gp, cov(lv["d_oc"]).transpose(-1, -2)
                            ).transpose(-1, -2)  # [C, n, r, S]
                A = self._floor(raw, raw - Zt @ Zt.transpose(-1, -2))
            A = A + self._scale(A) * _eye_like(A)
            L = _chol(A)
            if k == 0:
                G = L
            else:
                G = torch.cat([
                    torch.cat([Gp, Gp.new_zeros(Gp.shape[:-1] + (L.shape[-1],))],
                              dim=-1),
                    torch.cat([Zt, L], dim=-1)], dim=-2)
            out[k] = (G, L, self._scale(A) if self.jitter else None)
        return out

    def _leaf_cov(self, lv, cov, Gp):
        """The leaf's whitened basis ``Z [C, n, S, P]`` and the covariance
        of its own term ``C_M [C, n, P, P]``."""
        Z = _solve(Gp, cov(lv["d_qx"]))
        raw = cov(lv["d_xx"])
        Cm = self._floor(raw, raw - Z.transpose(-1, -2) @ Z)
        if not self.jitter:
            return Z, Cm
        k = lv["k"]
        K = (Cm * (k[:, :, None] * k[:, None, :])
             + (1.0 - k)[:, :, None] * _eye_like(Cm))
        Lk = _chol(K + self._scale(K) * _eye_like(K))
        T = _solve(Lk, (Cm * k[:, None, :]).transpose(-1, -2))
        return Z, T.transpose(-1, -2) @ T

    def sweep(self, l: torch.Tensor, sig: torch.Tensor,
              posterior: bool = False) -> dict:
        fl = dict(dtype=self.dtype, device=self.device)
        l = l.to(**fl).reshape(-1, 1, 1, 1)
        sig = sig.to(**fl).reshape(-1, 1, 1, 1)
        C = l.shape[0]
        r = self.r

        def cov(d):
            return sig * torch.exp(-d / l)

        prior = self._prior(cov)

        # leaves: factor each leaf block, whiten the data and the basis
        total = torch.zeros(C, **fl)
        msgs = [None] * (self.M + 1)  # per interior level: (H, h)
        leaf_state = []
        for lv in self.leaf_levels:
            m = lv["m"]
            Z, Cm = self._leaf_cov(lv, cov, prior[m - 1][0][:, lv["parent"]])
            o = lv["o"]
            D = (Cm * (o[:, :, None] * o[:, None, :])
                 + (self.R * o + (1.0 - o))[:, :, None] * _eye_like(Cm))
            LD = _chol(D)
            Wt = _solve(LD, Z.transpose(-1, -2) * o[:, :, None])  # [C,n,P,S]
            yt = _solve(LD, lv["y0"][:, :, None].expand(C, -1, -1, -1))
            total = total + (_logdiag(LD) + (yt * yt).sum((-2, -1))).sum(-1)
            H = Wt.transpose(-1, -2) @ Wt
            h = (Wt.transpose(-1, -2) @ yt)[..., 0]
            self._send(msgs, m - 1, lv["parent"], H, h)
            leaf_state.append((lv, Z.transpose(-1, -2), Cm, LD, Wt, yt))

        # interior precision I + Z' D^-1 Z, eliminated from the deepest
        # level up; each node's message goes to its parent's chain
        int_state = [None] * (self.M + 1)
        for k in range(self.M, -1, -1):
            if msgs[k] is None:
                continue
            H, h = msgs[k]
            S = k * r
            A = H[..., S:, S:] + torch.eye(r, **fl)
            if self.jitter:
                _, L, extra = prior[k]
                Li = _solve(L, _eye_like(L).expand_as(L))
                A = A + extra * (Li @ Li.transpose(-1, -2))
            LA = _chol(A)
            X = _solve(LA, H[..., S:, :S])  # [C, n, r, S]
            t = _solve(LA, h[..., S:, None])  # [C, n, r, 1]
            total = total + (_logdiag(LA) - (t * t).sum((-2, -1))).sum(-1)
            int_state[k] = (LA, X, t)
            if k:
                self._send(msgs, k - 1, self.interior[k]["parent"],
                           H[..., :S, :S] - X.transpose(-1, -2) @ X,
                           h[..., :S] - (X.transpose(-1, -2) @ t)[..., 0])

        out = {"objective": total,
               "loglik": -0.5 * (total + self.n_obs * LOG2PI)}
        if posterior:
            out["mean"], out["var"] = self._posterior(int_state, leaf_state,
                                                      C)
        return out

    def _send(self, msgs, k, parent, H, h):
        """Add the children's messages ``H [C, n, S, S]``, ``h [C, n, S]``
        to their parents' rows at interior level ``k``."""
        n = self.interior[k]["n"]
        Hs = H.new_zeros(H.shape[:1] + (n,) + H.shape[2:]).index_add(
            1, parent, H)
        hs = h.new_zeros(h.shape[:1] + (n,) + h.shape[2:]).index_add(
            1, parent, h)
        if msgs[k] is not None:
            Hs, hs = Hs + msgs[k][0], hs + msgs[k][1]
        msgs[k] = (Hs, hs)

    def _posterior(self, int_state, leaf_state, C):
        """Posterior mean and covariance of each node's chain ``[ancestors,
        own]`` from the root down; then the mean and variance of ``w`` at
        every leaf location."""
        fl = dict(dtype=self.dtype, device=self.device)
        r = self.r
        chain_mean = [None] * (self.M + 1)
        chain_cov = [None] * (self.M + 1)
        for k in range(self.M + 1):
            st = int_state[k]
            if st is None:
                continue
            LA, X, t = st
            Ainv = _solve_t(LA, _solve(LA, torch.eye(r, **fl).expand_as(LA)))
            u_own = _solve_t(LA, t)[..., 0]  # [C, n, r]
            if k == 0:
                chain_mean[0], chain_cov[0] = u_own, Ainv
                continue
            par = self.interior[k]["parent"]
            ua = chain_mean[k - 1][:, par]  # [C, n, S]
            Sa = chain_cov[k - 1][:, par]  # [C, n, S, S]
            Y = _solve_t(LA, X)  # [C, n, r, S]
            uo = u_own - (Y @ ua[..., None])[..., 0]
            Soa = -(Y @ Sa)
            Soo = Ainv + Y @ Sa @ Y.transpose(-1, -2)
            chain_mean[k] = torch.cat([ua, uo], dim=-1)
            chain_cov[k] = torch.cat([
                torch.cat([Sa, Soa.transpose(-1, -2)], dim=-1),
                torch.cat([Soa, Soo], dim=-1)], dim=-2)

        mean = torch.zeros(C, self.N + 1, **fl)
        var = torch.zeros(C, self.N + 1, **fl)
        for lv, Zt, Cm, LD, Wt, yt in leaf_state:
            k = lv["m"] - 1
            uc = chain_mean[k][:, lv["parent"]]  # [C, n, S]
            Sc = chain_cov[k][:, lv["parent"]]
            # k(s) = C_M(X_o, s); Kt[:, s] = LD^-1 k(s)
            Kt = _solve(LD, Cm * lv["o"][:, :, None])  # [C, n, P, P]
            Hs = Zt - Kt.transpose(-1, -2) @ Wt  # [C, n, P, S]
            mu = (Hs @ uc[..., None])[..., 0] + (
                Kt.transpose(-1, -2) @ yt)[..., 0]
            vr = (((Hs @ Sc) * Hs).sum(-1)
                  + torch.diagonal(Cm, dim1=-2, dim2=-1)
                  - (Kt * Kt).sum(-2))
            gidx = lv["gidx"].reshape(-1)
            keep = lv["valid"].to(self.dtype).reshape(-1)
            mean = mean.index_add(1, gidx, mu.reshape(C, -1) * keep)
            var = var.index_add(1, gidx, vr.reshape(C, -1) * keep)
        return mean[:, :self.N], var[:, :self.N]
