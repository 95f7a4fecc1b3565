"""The fused Cholesky pullback's plain twin against the JAX package's VJP.

``cholesky_pullback`` (one launch on the card) computes what the backward
of ``cholesky_jittered`` needs: ``Abar`` and the jitter's ``jbar`` from the
factor, its cotangent, the cotangent of its log-diagonal sum and the
selected escalation factors. On the CPU it runs its twin
``cholesky_pullback_ref``, the composition the kernel fuses, which these
tests hold

* to ``jax.vjp`` of the JAX package's ``cholesky_jittered`` (its kernel in
  Pallas interpret mode, as ``tests/test_pallas.py`` runs it on the CPU)
  with the log-diagonal sum as a second output, on healthy, escalated and
  exact-zero-pivot members: rtol 1e-4 in float32 (two float32 pullbacks
  rounding in different places; the escalated members' blocks have
  condition numbers up to ~1e2, squared by the pullback) and 1e-10 in
  float64, each against the largest entry of its output;
* through ``cholesky_jittered``'s autograd backward on the CPU, to the
  composition the backward ran before it called the pullback (written out
  here with the twin solves): 1e-12 in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl

from tests.test_torch_grad import _jittered_case
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

WIDTHS = [1, 4, 8, 17, 64]
RTOL = {"float32": 1e-4, "float64": 1e-10}


def _close(got, want, rtol):
    got = got.detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _case(p, dtype, seed):
    rng = np.random.default_rng(seed)
    m, jit = _jittered_case(p, rng)
    lbar = rng.standard_normal(m.shape)
    ldbar = rng.standard_normal(len(m))
    return [x.astype(dtype) for x in (m, jit, lbar, ldbar)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p", WIDTHS)
def test_pullback_twin_matches_jax_vjp(p, dtype):
    m, jit, lbar, ldbar = _case(p, dtype, 50 + p)
    l, _, f = tl.cholesky_jittered_ref(torch.tensor(m), torch.tensor(jit))
    # healthy members and the escalated ones (1e2: indefinite, exact zero)
    assert f.tolist()[:3] == [1.0, 1e2, 1e2]
    abar, jbar = tl.cholesky_pullback_ref(l, torch.tensor(lbar),
                                          torch.tensor(ldbar), f)

    def fwd(mm, jj):
        ll = jl.cholesky_jittered(mm, jj)
        return ll, jnp.log(jnp.diagonal(ll, axis1=-2, axis2=-1)).sum(-1)

    (want_l, _), vjp = jax.vjp(fwd, jnp.asarray(m), jnp.asarray(jit))
    want_abar, want_jbar = vjp((jnp.asarray(lbar), jnp.asarray(ldbar)))
    _close(l, want_l, RTOL[dtype])
    assert torch.isfinite(abar).all() and torch.isfinite(jbar).all()
    _close(abar, want_abar, RTOL[dtype])
    _close(jbar, want_jbar, RTOL[dtype])


def _old_composition(l, lbar, ldbar, f):
    """The jittered backward's arithmetic before the pullback was one
    function: the log-diagonal cotangent folded into ``lbar``, the JAX
    ``_cholesky_bwd`` with two back substitutions, ``jbar = f tr Abar``."""
    solve = tl.solve_triangular_batched_ref
    lbar = lbar + torch.diag_embed(
        ldbar[..., None] / torch.diagonal(l, dim1=-2, dim2=-1))
    x = l.transpose(-1, -2) @ lbar
    w = torch.tril(x) - 0.5 * torch.diag_embed(
        torch.diagonal(x, dim1=-2, dim2=-1))
    x = solve(l, w, True)
    raw = solve(l, x.transpose(-1, -2), True).transpose(-1, -2)
    abar = 0.5 * (raw + raw.transpose(-1, -2))
    return abar, f * torch.diagonal(abar, dim1=-2, dim2=-1).sum(-1)


@pytest.mark.parametrize("p", [1, 8, 49])
def test_jittered_backward_equals_old_composition(p):
    m, jit, lbar, ldbar = (torch.tensor(x) for x in
                           _case(p, "float64", 60 + p))
    mt, jt = m.clone().requires_grad_(True), jit.clone().requires_grad_(True)
    l, ld, f = tl.cholesky_jittered(mt, jt)
    got = torch.autograd.grad((l, ld), (mt, jt), (lbar, ldbar))
    want = _old_composition(l.detach(), lbar, ldbar, f)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(w.abs().max()))


def test_pullback_without_optional_cotangents():
    # no log-diagonal cotangent: Lbar alone; no factors: no jbar
    m, jit, lbar, _ = (torch.tensor(x) for x in _case(8, "float64", 7))
    l, _, f = tl.cholesky_jittered_ref(m, jit)
    abar, jbar = tl.cholesky_pullback(l, lbar)
    assert jbar is None
    want, _ = _old_composition(l, lbar, torch.zeros(len(m), dtype=m.dtype),
                               f)
    np.testing.assert_allclose(abar.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    # on the CPU the wrapper runs its twin: nothing launched, no twin call
    # counted as a CUDA call
    assert tl.cholesky_pullback.launches == 0
    assert tl.cholesky_pullback_ref.cuda_calls == 0
