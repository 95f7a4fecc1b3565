"""Backward passes of the port's autograd Functions against the JAX
package's custom VJPs, plus the JAX package's own gradient tests, ported.

* Each Function (``cholesky``, ``triangular_inverse_lower``,
  ``solve_triangular_batched`` both ways, ``cholesky_jittered``,
  ``leaf_factor``) against ``jax.vjp`` of its JAX counterpart, float64,
  the same inputs and the same random cotangents made with numpy from a
  seed: rtol 1e-9 (two float64 evaluations of the same formulas; the
  column loops round in different places, and the inputs' condition
  numbers stay below 1e3). The JAX kernels run as ``tests/test_pallas.py``
  runs them on the CPU: Pallas in interpret mode.
* ``torch.autograd.gradcheck`` on every twin-backed Function (float64).
* The gradient checks of ``tests/test_pallas.py`` (K4, K5, K2, K3 and the
  finite-difference VJP of ``leaf_factor``) with the port's functions and
  torch's own linear algebra as the reference, at that file's tolerances.
* On the CPU the wrappers run their twins: no launch, no twin call counted
  as a CUDA call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
WIDTHS = [4, 8, 17, 49, 64]
RTOL = 1e-9


def _spd(rng, b, p):
    a = rng.standard_normal((b, p, p))
    return a @ np.swapaxes(a, -1, -2) / p + np.eye(p)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=F64, requires_grad=grad)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _jittered_case(p, rng):
    """Healthy members, one indefinite enough to escalate to 1e2 at jitter
    1e-3, and one (exactly zero last pivot on the first attempt) that
    escalates at jitter 1e-4."""
    m = _spd(rng, 5, p)
    jit = np.full(5, 1e-6)
    q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    m[1] = (q * np.r_[np.linspace(1.0, 2.0, p - 1), -0.05]) @ q.T
    jit[1] = 1e-3
    m[2] = np.diag(np.r_[np.ones(p - 1), -1e-4])
    jit[2] = 1e-4
    return m, jit


# ---------------------------------------------------------------------------
# each Function's backward against the JAX custom VJP (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", WIDTHS)
def test_cholesky_vjp_matches_jax(p):
    rng = np.random.default_rng(p)
    m = _spd(rng, 4, p)
    lbar = rng.standard_normal(m.shape)
    mt = _t(m, grad=True)
    l = tl.cholesky(mt)
    got, = torch.autograd.grad(l, mt, _t(lbar))
    want_l, vjp = jax.vjp(jl.cholesky, jnp.asarray(m))
    want, = vjp(jnp.asarray(lbar))
    _close(l, want_l)
    _close(got, want)


@pytest.mark.parametrize("p", WIDTHS)
def test_triangular_inverse_vjp_matches_jax(p):
    rng = np.random.default_rng(10 + p)
    l0 = np.linalg.cholesky(_spd(rng, 4, p))
    ybar = rng.standard_normal(l0.shape)
    lt = _t(l0, grad=True)
    y = tl.triangular_inverse_lower(lt)
    got, = torch.autograd.grad(y, lt, _t(ybar))
    want_y, vjp = jax.vjp(jl.triangular_inverse_lower, jnp.asarray(l0))
    want, = vjp(jnp.asarray(ybar))
    _close(y, want_y)
    _close(got, want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("p", WIDTHS)
def test_solve_triangular_vjp_matches_jax(p, transpose):
    rng = np.random.default_rng(20 + p)
    l0 = np.linalg.cholesky(_spd(rng, 3, p))
    b = rng.standard_normal((3, p, 5))
    xbar = rng.standard_normal(b.shape)
    lt, bt = _t(l0, grad=True), _t(b, grad=True)
    x = tl.solve_triangular_batched(lt, bt, transpose)
    got = torch.autograd.grad(x, (lt, bt), _t(xbar))
    want_x, vjp = jax.vjp(
        lambda ll, bb: jl.solve_triangular_batched(ll, bb, transpose),
        jnp.asarray(l0), jnp.asarray(b))
    want = vjp(jnp.asarray(xbar))
    _close(x, want_x)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("p", WIDTHS)
def test_cholesky_jittered_vjp_matches_jax(p):
    rng = np.random.default_rng(30 + p)
    m, jit = _jittered_case(p, rng)
    lbar = rng.standard_normal(m.shape)
    mt, jt = _t(m, grad=True), _t(jit, grad=True)
    l, _, f = tl.cholesky_jittered(mt, jt)
    got = torch.autograd.grad(l, (mt, jt), _t(lbar))
    want_l, vjp = jax.vjp(lambda mm, jj: jl.cholesky_jittered(mm, jj),
                          jnp.asarray(m), jnp.asarray(jit))
    want = vjp(jnp.asarray(lbar))
    # the escalated members really escalated and were linearized there
    assert f[1] == 1e2 and f[2] == 1e2 and (f[[0, 3, 4]] == 1.0).all()
    _close(l, want_l)
    assert torch.isfinite(got[0]).all()
    for g, w in zip(got, want):
        _close(g, w)


def _leaf_case(p, rng, b=6):
    """SPD c with one member shifted indefinite (escalates at jitter 1e-2),
    a 70% knot mask with one fully masked leaf, a knot-masked Gram."""
    c = _spd(rng, b, p)
    kmask = (rng.random((b, p)) < 0.7).astype(np.float64)
    kmask[1] = 0.0
    kmask[4] = 1.0
    c[4] -= (p / 2 + 4.0) * np.eye(p)
    a2 = rng.standard_normal((b, p, p))
    a_oo = a2 @ np.swapaxes(a2, -1, -2) * 0.1 / p
    a_oo = a_oo * kmask[:, :, None] * kmask[:, None, :]
    a_oo[4] = 0.0
    return c, kmask, a_oo


@pytest.mark.parametrize("p", WIDTHS)
def test_leaf_factor_vjp_matches_jax(p):
    rng = np.random.default_rng(40 + p)
    c, kmask, a_oo = _leaf_case(p, rng)
    jitter = 1e-2
    libar = rng.standard_normal(c.shape)
    ldpbar, ldqbar = rng.standard_normal((2, len(c)))
    ct, at = _t(c, grad=True), _t(a_oo, grad=True)
    li, ldp, ldq, fp, fq = tl.leaf_factor(ct, _t(kmask), at, jitter)
    got = torch.autograd.grad((li, ldp, ldq), (ct, at),
                              (_t(libar), _t(ldpbar), _t(ldqbar)))
    want_out, vjp = jax.vjp(
        lambda cc, aa: jl.leaf_factor(cc, jnp.asarray(kmask), aa, jitter),
        jnp.asarray(c), jnp.asarray(a_oo))
    want = vjp((jnp.asarray(libar), jnp.asarray(ldpbar),
                jnp.asarray(ldqbar)))
    assert fp[4] > 1.0 and fq[4] > 1.0
    for g, w in zip((li, ldp, ldq), want_out):
        _close(g, w)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)
    # the fully masked leaf has no knot entries to receive a gradient
    assert (got[0][1] == 0).all() and (got[1][1] == 0).all()


# ---------------------------------------------------------------------------
# gradcheck of every twin-backed Function (float64)
# ---------------------------------------------------------------------------

def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def test_gradcheck_cholesky_and_cholesky_jittered():
    rng = np.random.default_rng(1)
    m = _t(_spd(rng, 3, 5), grad=True)
    jit = _t(np.full(3, 1e-3), grad=True)
    assert torch.autograd.gradcheck(lambda a: tl.cholesky(_sym(a)), (m,))
    # both the factor and its log-pivot sum, in the matrix and the jitter
    assert torch.autograd.gradcheck(
        lambda a, j: tl.cholesky_jittered(_sym(a), j)[:2], (m, jit))


def test_gradcheck_triangular_inverse_and_solve():
    rng = np.random.default_rng(2)
    l0 = _t(np.linalg.cholesky(_spd(rng, 3, 5)), grad=True)
    b = _t(rng.standard_normal((3, 5, 2)), grad=True)
    assert torch.autograd.gradcheck(
        lambda l: tl.triangular_inverse_lower(torch.tril(l)), (l0,))
    for transpose in (False, True):
        assert torch.autograd.gradcheck(
            lambda l, bb: tl.solve_triangular_batched(torch.tril(l), bb,
                                                      transpose), (l0, b))


def test_gradcheck_leaf_factor():
    # jitter 0: the jitter scale is structural (no gradient into it), so
    # a finite difference agrees with the VJP only where it vanishes
    rng = np.random.default_rng(3)
    c, kmask, a_oo = _leaf_case(6, rng)
    c[4] += (6 / 2 + 4.0) * np.eye(6)  # healthy: jitter 0 cannot escalate
    k = _t(kmask)
    pair = k[:, :, None] * k[:, None, :]

    def f(cc, aa):
        li, ldp, ldq, _, _ = tl.leaf_factor(_sym(cc), k, _sym(aa) * pair,
                                            0.0)
        return li, ldp, ldq

    assert torch.autograd.gradcheck(f, (_t(c, grad=True),
                                        _t(a_oo, grad=True)))


# ---------------------------------------------------------------------------
# the gradient checks of tests/test_pallas.py, ported
# ---------------------------------------------------------------------------

def _spd32(seed, b, p):
    a = np.random.default_rng(seed).standard_normal((b, p, p))
    m = a @ np.swapaxes(a, -1, -2) + p * np.eye(p)
    return torch.tensor(m, dtype=torch.float32)


def _grad(f, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    return torch.autograd.grad(f(*xs), xs)


def test_cholesky_gradient_matches_torch():
    # test_pallas.py:52, at its tolerance (float32)
    m = _spd32(2, 4, 6)
    g1, = _grad(lambda x: torch.sin(tl.cholesky(x)).sum(), m)
    g2, = _grad(lambda x: torch.sin(torch.linalg.cholesky(x)).sum(), m)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("transpose", [False, True])
def test_triangular_solve_gradient_matches_torch(transpose):
    # test_pallas.py:81: torch's solve gradient in L is dense, ours is
    # tril-projected; both are valid cotangents of a lower factor
    l0 = torch.linalg.cholesky(_spd32(5, 3, 6))
    rhs = torch.tensor(np.random.default_rng(6).standard_normal((3, 6, 4)),
                       dtype=torch.float32)
    g1 = _grad(lambda ll, bb: torch.cos(
        tl.solve_triangular_batched(ll, bb, transpose)).sum(), l0, rhs)
    g2 = _grad(lambda ll, bb: torch.cos(torch.linalg.solve_triangular(
        ll.transpose(-1, -2) if transpose else ll, bb,
        upper=transpose)).sum(), l0, rhs)
    np.testing.assert_allclose(torch.tril(g1[0]).numpy(),
                               torch.tril(g2[0]).numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(g1[1].numpy(), g2[1].numpy(), rtol=1e-3,
                               atol=1e-4)


def test_cholesky_jittered_gradient():
    # test_pallas.py:160
    m = _spd32(8, 3, 4)
    jit = torch.full((3,), 1e-5)
    eye = torch.eye(4)
    g1, = _grad(lambda x: torch.sin(tl.cholesky_jittered(x, jit)[0]).sum(),
                m)
    g2, = _grad(lambda x: torch.sin(
        torch.linalg.cholesky(x + 1e-5 * eye)).sum(), m)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-3, atol=1e-4)


def test_triangular_inverse_vjp_matches_solve_autodiff():
    # test_pallas.py:276
    l0 = torch.tril(_spd32(5, 2, 6).to(F64))
    eye = torch.eye(6, dtype=F64)

    def f_ours(s):
        return torch.sin(tl.triangular_inverse_lower(l0 * s)).sum()

    def f_ref(s):
        ls = l0 * s
        return torch.sin(torch.linalg.solve_triangular(
            ls, eye.expand_as(ls), upper=False)).sum()

    s = torch.tensor(1.3, dtype=F64)
    g0, = _grad(f_ours, s)
    g1, = _grad(f_ref, s)
    np.testing.assert_allclose(float(g0), float(g1), rtol=1e-5)


def test_leaf_factor_vjp_finite_difference():
    # test_pallas.py:462: symmetric perturbations of c and a_oo
    rng = np.random.default_rng(31)
    b, p, jitter = 3, 7, 1e-6
    c = _spd(rng, b, p) + p * np.eye(p)
    kmask = (rng.random((b, p)) < 0.7).astype(np.float64)
    kmask[1] = 0.0
    a2 = rng.standard_normal((b, p, p))
    a_oo = (a2 @ np.swapaxes(a2, -1, -2) * 0.1
            * kmask[:, :, None] * kmask[:, None, :])
    km = _t(kmask)

    def f(cj, aj):
        li, ldp, ldq, _, _ = tl.leaf_factor(cj, km, aj, jitter)
        return ldp.sum() + 2.0 * ldq.sum() + (li * 0.01).sum()

    g_c, g_a = _grad(f, _t(c), _t(a_oo))
    eps = 1e-5
    for (i, j, k) in [(0, 2, 3), (1, 0, 0), (2, 5, 5)]:
        for which, x0, g in ((0, c, g_c), (1, a_oo, g_a)):
            d = np.zeros_like(x0)
            d[i, j, k] += eps / 2
            d[i, k, j] += eps / 2
            args_p = [_t(c), _t(a_oo)]
            args_m = [_t(c), _t(a_oo)]
            args_p[which] = _t(x0 + d)
            args_m[which] = _t(x0 - d)
            fd = (float(f(*args_p)) - float(f(*args_m))) / (2 * eps)
            an = (float(g[i, j, k]) + float(g[i, k, j])) / 2
            np.testing.assert_allclose(fd, an, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# escalation: an escalated member never poisons a healthy one
# ---------------------------------------------------------------------------

def test_all_fail_member_keeps_its_nan_gradient_to_itself():
    # kernel structure (float32): a member that fails every factor has a
    # NaN factor; its gradient is NaN, its neighbours' stay finite
    m = torch.stack([2.0 * torch.eye(4), -torch.eye(4),
                     3.0 * torch.eye(4)]).requires_grad_(True)
    jit = torch.full((3,), 1e-6)
    l, _, f = tl.cholesky_jittered(m, jit)
    assert f[1] == 1e4 and torch.isnan(l[1]).any()
    g, = torch.autograd.grad(
        torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1),
        m, torch.ones(3))
    assert torch.isfinite(g[[0, 2]]).all() and torch.isnan(g[1]).any()
    np.testing.assert_allclose(torch.diagonal(g[0]).numpy(),
                               np.full(4, 0.5 / (2 + 1e-6)), rtol=1e-6)


def test_cpu_runs_twins_and_counts_nothing():
    before = (tl.cholesky.launches, tl.triangular_inverse_lower.launches,
              tl.solve_triangular_batched.launches,
              tl.cholesky_jittered.launches, tl.leaf_factor.launches,
              tl.cholesky_ref.cuda_calls,
              tl.triangular_inverse_lower_ref.cuda_calls,
              tl.solve_triangular_batched_ref.cuda_calls,
              tl.cholesky_jittered_ref.cuda_calls,
              tl.leaf_factor_ref.cuda_calls)
    rng = np.random.default_rng(4)
    c, kmask, a_oo = _leaf_case(8, rng)
    ct = _t(c, grad=True)
    li, ldp, ldq, _, _ = tl.leaf_factor(ct, _t(kmask), _t(a_oo), 1e-2)
    m = _t(_spd(rng, 3, 4), grad=True)
    l = tl.cholesky_jittered(m, _t(np.full(3, 1e-6)))[0]
    (li.sum() + ldp.sum() + ldq.sum() + l.sum()).backward()
    assert torch.isfinite(ct.grad).all() and torch.isfinite(m.grad).all()
    after = (tl.cholesky.launches, tl.triangular_inverse_lower.launches,
             tl.solve_triangular_batched.launches,
             tl.cholesky_jittered.launches, tl.leaf_factor.launches,
             tl.cholesky_ref.cuda_calls,
             tl.triangular_inverse_lower_ref.cuda_calls,
             tl.solve_triangular_batched_ref.cuda_calls,
             tl.cholesky_jittered_ref.cuda_calls,
             tl.leaf_factor_ref.cuda_calls)
    assert after == before
