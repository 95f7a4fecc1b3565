"""The port's compositions for wide matrices — K8 ``cholesky_blocked``,
the blocked ``triangular_inverse_lower`` and the escalation cascade KC —
against the JAX package.

JAX's ``cholesky_blocked`` factors its 64-wide diagonal blocks with the
K4 Pallas kernel in interpret mode; its ``_tri_inv_recursive`` and
``cholesky_cascade_lanes`` are called directly, and its ``_chol_cascade``
under ``PYMRA_PALLAS=force`` (the TPU dispatch: the cascade over
``cholesky_blocked``). The port runs the same compositions over its
twins. Tolerances: float32 factors and inverses rtol 1e-4 with an
absolute floor of 1e-4 of the largest entry (the compositions are the
same; matmul sums and the column loops round in different places, and a
P = 150 factor passes three blocks of rounding); float64 gradients rtol
1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu.ops.pallas import linalg as jl
from pymra_tpu.tree import sweep as jsweep
from pymra_torch.ops import linalg as tl

from tests.test_torch_grad import _close, _t
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64
SHAPES = [(4, 96), (2, 150), (3, 64), (2, 130)]


def _spd(seed, b, p):
    a = np.random.default_rng(seed).standard_normal((b, p, p))
    return a @ np.swapaxes(a, -1, -2) / p + np.eye(p)


def _near(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("b,p", SHAPES)
def test_cholesky_blocked_matches_jax(b, p):
    m = _spd(p, b, p).astype(np.float32)
    got = tl.cholesky_blocked(torch.as_tensor(m))
    want = np.asarray(jl.cholesky_blocked(jnp.asarray(m)))
    _near(got.numpy(), want)
    assert (torch.triu(got, 1) == 0).all()
    # the twin is the same composition over the twins
    assert torch.equal(tl.cholesky_blocked_ref(torch.as_tensor(m)), got)
    _near(got.double().numpy(), np.linalg.cholesky(m.astype(np.float64)),
          rtol=1e-3)


@pytest.mark.parametrize("b,p", SHAPES)
def test_blocked_triangular_inverse_matches_jax(b, p):
    l0 = np.linalg.cholesky(_spd(p + 1, b, p)).astype(np.float32)
    got = tl.triangular_inverse_lower(torch.as_tensor(l0))
    want = np.asarray(jl._tri_inv_recursive(jnp.asarray(l0)))
    _near(got.numpy(), want)
    _near(got.numpy(), tl.triangular_inverse_lower_ref(
        torch.as_tensor(l0)).numpy())
    assert (torch.triu(got, 1) == 0).all()


def test_cholesky_blocked_nan_stays_in_its_member():
    # test_pallas.py:201: an indefinite trailing block in member 1
    m = _spd(3, 2, 96).astype(np.float32)
    m[1, 90, 90] = -1e6
    got = tl.cholesky_blocked(torch.as_tensor(m))
    assert torch.isnan(got[1]).any() and torch.isfinite(got[0]).all()
    # the block columns before the failing one stay finite
    assert torch.isfinite(got[1, :, :64]).all()


def test_cholesky_blocked_gradient_matches_jax():
    # test_pallas.py:210, float64: gradient of sum log diag in a scale
    m = _spd(4, 1, 96)

    def f_port(s):
        return torch.log(torch.diagonal(tl.cholesky_blocked(_t(m) * s),
                                        dim1=-2, dim2=-1)).sum()

    def f_jax(s):
        return jnp.sum(jnp.log(jnp.diagonal(jl.cholesky_blocked(
            jnp.asarray(m) * s), axis1=-2, axis2=-1)))

    s = torch.tensor(1.3, dtype=F64, requires_grad=True)
    f_port(s).backward()
    np.testing.assert_allclose(float(s.grad), float(jax.grad(f_jax)(1.3)),
                               rtol=1e-8)
    # and the factor's own VJP, with a random cotangent: the port's is the
    # symmetric Cholesky pullback, the JAX composition's puts the whole
    # off-diagonal gradient on the lower blocks it reads; compare the
    # symmetric parts (the gradient along symmetric inputs)
    rng = np.random.default_rng(5)
    lbar = np.tril(rng.standard_normal(m.shape))
    mt = _t(m, grad=True)
    got, = torch.autograd.grad(tl.cholesky_blocked(mt), mt, _t(lbar))
    _, vjp = jax.vjp(jl.cholesky_blocked, jnp.asarray(m))
    want = np.asarray(vjp(jnp.asarray(lbar))[0])
    _close(got, 0.5 * (want + np.swapaxes(want, -1, -2)), rtol=1e-8)
    assert torch.equal(got, got.transpose(-1, -2))


def test_cholesky_blocked_float32_carries_panels_in_float64():
    # an ill-conditioned float32 batch (cond 1e4, P = 256): the shipped
    # factor is nearer the float64 factor than the same composition with
    # float32 panels and trailing blocks (the JAX package's arithmetic)
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((4, 256, 256)))
    m = (q * np.geomspace(1.0, 1e-4, 256)) @ np.swapaxes(q, -1, -2)
    m = torch.as_tensor((0.5 * (m + np.swapaxes(m, -1, -2))).astype(
        np.float32))
    want = torch.linalg.cholesky(m.double())

    def float32_panels(a):
        cols = []
        for j0 in range(0, 256, 64):
            l11 = tl.cholesky(a[..., :64, :64].contiguous())
            if j0 + 64 < 256:
                l21 = a[..., 64:, :64] @ tl.triangular_inverse_lower(
                    l11).transpose(-1, -2)
                a = a[..., 64:, 64:] - l21 @ l21.transpose(-1, -2)
                l11 = torch.cat([l11, l21], dim=-2)
            cols.append(torch.cat([l11.new_zeros(4, j0, 64), l11], dim=-2))
        return torch.cat(cols, dim=-1)

    err = (tl.cholesky_blocked(m).double() - want).abs().max()
    err32 = (float32_panels(m).double() - want).abs().max()
    assert err < 0.6 * err32


def test_blocked_triangular_inverse_vjp_matches_jax():
    rng = np.random.default_rng(6)
    l0 = np.linalg.cholesky(_spd(6, 2, 130))
    ybar = rng.standard_normal(l0.shape)
    lt = _t(l0, grad=True)
    y = tl.triangular_inverse_lower(lt)
    got, = torch.autograd.grad(y, lt, _t(ybar))
    want_y, vjp = jax.vjp(jl.triangular_inverse_lower, jnp.asarray(l0))
    want, = vjp(jnp.asarray(ybar))
    _close(y, want_y)
    _close(got, want)


# ---------------------------------------------------------------------------
# KC: the escalation cascade
# ---------------------------------------------------------------------------

def _cascade_case(p, seed=0):
    """Healthy members, one needing the 1e2 factor, one with an exactly
    zero last pivot on the first attempt, and -I (fails every factor)."""
    rng = np.random.default_rng(seed)
    m = _spd(seed + p, 6, p)
    jit = np.full(6, 1e-2)
    q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    m[2] = (q * np.r_[np.linspace(1.0, 2.0, p - 1), -0.5]) @ q.T
    m[3] = np.diag(np.r_[np.ones(p - 1), -1e-4])
    jit[3] = 1e-4
    m[5] = -np.eye(p)
    jit[5] = 1e-6
    return m.astype(np.float32), jit.astype(np.float32)


@pytest.mark.parametrize("p", [9, 17, 49])
def test_cholesky_cascade_matches_cascade_lanes(p):
    m, jit = _cascade_case(p)
    l, ld, f = tl.cholesky_cascade(torch.as_tensor(m), torch.as_tensor(jit))
    want = np.asarray(jl.cholesky_cascade_lanes(jnp.asarray(m),
                                                jnp.asarray(jit)))
    ok = np.isfinite(want).all((-2, -1))
    np.testing.assert_array_equal(torch.isfinite(l).all(-1).all(-1).numpy(),
                                  ok)
    assert ok[:5].all() and not ok[5]
    np.testing.assert_array_equal(f.numpy(), [1, 1, 1e2, 1e2, 1, 1e4])
    _near(l.numpy()[ok], want[ok])
    np.testing.assert_allclose(
        ld.numpy()[ok],
        np.log(np.diagonal(want[ok], axis1=-2, axis2=-1)).sum(-1),
        rtol=1e-4, atol=1e-5)


def test_cholesky_cascade_wide_matches_jax_tpu_dispatch(monkeypatch):
    # P = 96: the JAX cascade over cholesky_blocked, as the TPU runs it
    m, jit = _cascade_case(96, seed=1)
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        want = np.asarray(jsweep._chol_cascade(
            jnp.asarray(m), jnp.asarray(jit)[:, None, None]))
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()
    l, _, f = tl.cholesky_cascade(torch.as_tensor(m), torch.as_tensor(jit))
    ok = np.isfinite(want).all((-2, -1))
    assert ok[:5].all() and not ok[5]
    np.testing.assert_array_equal(f.numpy(), [1, 1, 1e2, 1e2, 1, 1e4])
    _near(l.numpy()[ok], want[ok])
    torch.testing.assert_close(tl.cholesky_cascade_ref(
        torch.as_tensor(m), torch.as_tensor(jit))[0], l, rtol=0, atol=0,
        equal_nan=True)


@pytest.mark.parametrize("p", [9, 96])
def test_cholesky_cascade_vjp_matches_jax(p):
    # linearized at the selected factor, as the JAX cascade's custom JVP
    m, jit = (x.astype(np.float64) for x in _cascade_case(p, seed=2))
    m, jit = m[:5], jit[:5]
    rng = np.random.default_rng(p)
    lbar = np.tril(rng.standard_normal(m.shape))
    mt = _t(m, grad=True)
    l, _, f = tl.cholesky_cascade(mt, _t(jit))
    got, = torch.autograd.grad(l, mt, _t(lbar))
    want_l, vjp = jax.vjp(
        lambda mm: jsweep._chol_cascade(mm, jnp.asarray(jit)[:, None, None]),
        jnp.asarray(m))
    want, = vjp(jnp.asarray(lbar))
    assert f[2] == 1e2 and f[3] == 1e2
    _close(l, want_l)
    assert torch.isfinite(got).all()
    # the JAX pullback is not symmetrized; compare the symmetric parts
    want = np.asarray(want)
    _close(got, 0.5 * (want + np.swapaxes(want, -1, -2)), rtol=1e-8)


def test_gradcheck_cholesky_cascade():
    # the wide backward (torch's solves) is held to JAX above; a finite
    # difference over every entry of a P > 64 member takes minutes
    m = _t(_spd(8, 2, 6), grad=True)
    jit = _t(np.full(2, 1e-3), grad=True)
    assert torch.autograd.gradcheck(
        lambda mm, jj: tl.cholesky_cascade(
            0.5 * (mm + mm.transpose(-1, -2)), jj)[:2], (m, jit))
