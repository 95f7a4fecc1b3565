"""K6 ``cholesky_logdet`` and K7 ``cholesky_inv_logdet`` of the port
against the JAX package's Pallas kernels and custom VJPs.

The JAX kernels run in Pallas interpret mode on the CPU, called directly
(as ``tests/test_pallas.py`` runs them); the port runs its plain twins.
The same inputs, made with numpy from a seed, go to both:

* float32 forward: rtol 1e-4 / atol 1e-5 on log-determinants and inverse
  factors (two float32 column loops rounding in different places), the
  selected escalation factors identical — healthy members, a singular
  rank-1 block, one indefinite beyond the base jitter, an exact zero pivot
  on the first attempt, and one (-I) that fails every factor;
* float64 backward against ``jax.vjp`` on the same cotangents, rtol 1e-9
  (the same formulas; K7's pullback takes an exact identity where the JAX
  VJP re-inverts, which float64 does not see), and ``gradcheck``;
* the launch on the card, on ``meta`` tensors with the kernel library
  replaced by a recorder: one launch a call at the register-tiled core's
  width tier ``tile_tier(P)``, P > 64 refused before any launch.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl

from tests.test_torch_grad import _close, _jittered_case, _sym, _t
from tests.test_torch_linalg import _chol_case
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
#: the edges of the CUDA kernels' width tiers (16, 32, 48, 64), and 5
WIDTHS = [1, 5, 16, 17, 32, 33, 48, 49, 64]


def _with_all_fail(p):
    m, jit = _chol_case(p)
    return (np.concatenate([m, -np.eye(p, dtype=np.float32)[None]]),
            np.r_[jit, np.float32(1e-6)])


@pytest.mark.parametrize("p", WIDTHS)
def test_cholesky_logdet_ref_matches_pallas(p):
    m, jit = _with_all_fail(p)
    ld, f = tl.cholesky_logdet(torch.as_tensor(m), torch.as_tensor(jit))
    want_ld, want_f = jl._chol_logdet_pair(jnp.asarray(m), jnp.asarray(jit),
                                           tl.FACTORS)
    np.testing.assert_array_equal(f.numpy(), np.asarray(want_f))
    ok = np.isfinite(np.asarray(want_ld))
    np.testing.assert_array_equal(torch.isfinite(ld).numpy(), ok)
    np.testing.assert_allclose(ld.numpy()[ok], np.asarray(want_ld)[ok],
                               rtol=RTOL, atol=ATOL)
    # the indefinite member (at P > 1) and the exact zero pivot escalated;
    # -I failed every factor and keeps a non-finite sum
    assert (f[7] > 1.0) == (p > 1)
    assert f[8] == 1e2 and f[9] == 1e4 and not ok[9]
    assert ok[:9].all()


@pytest.mark.parametrize("p", WIDTHS)
def test_cholesky_inv_logdet_ref_matches_pallas(p):
    m, jit = _with_all_fail(p)
    x, ld, f = tl.cholesky_inv_logdet(torch.as_tensor(m),
                                      torch.as_tensor(jit))
    want_x, want_ld, want_f = (np.asarray(o) for o in
                               jl._chol_inv_logdet_tuple(
                                   jnp.asarray(m), jnp.asarray(jit),
                                   tl.FACTORS))
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_allclose(ld.numpy()[:9], want_ld[:9], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.numpy()[:9], want_x[:9], rtol=RTOL,
                               atol=ATOL)
    assert f[8] == 1e2 and f[9] == 1e4
    assert not np.isfinite(want_ld[9]) and not torch.isfinite(ld[9])
    assert torch.isfinite(x[:9]).all() and (torch.triu(x[:9], 1) == 0).all()
    # the inverse of the factor (the healthy, well-conditioned members)
    eye = np.eye(p)
    for i in range(6):
        k = m[i].astype(np.float64) + float(f[i] * jit[i]) * eye
        np.testing.assert_allclose(
            x[i].double().numpy(), np.linalg.inv(np.linalg.cholesky(k)),
            rtol=2e-3, atol=2e-3 * np.abs(want_x[i]).max())


def test_float64_twins_match_numpy():
    rng = np.random.default_rng(3)
    p = 11
    a = rng.standard_normal((4, p, p))
    m = a @ np.swapaxes(a, -1, -2) / p + np.eye(p)
    jit = np.full(4, 1e-3)
    ld, f = tl.cholesky_logdet(_t(m), _t(jit))
    x, ld2, f2 = tl.cholesky_inv_logdet(_t(m), _t(jit))
    for i in range(4):
        l = np.linalg.cholesky(m[i] + 1e-3 * np.eye(p))
        np.testing.assert_allclose(float(ld[i]), np.log(np.diag(l)).sum(),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(ld2[i]), float(ld[i]), rtol=1e-12)
        np.testing.assert_allclose(x[i].numpy(), np.linalg.inv(l),
                                   rtol=1e-10, atol=1e-12)
    assert (f == 1.0).all() and (f2 == 1.0).all()


# ---------------------------------------------------------------------------
# backward passes against the JAX custom VJPs (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 8, 17, 49])
def test_cholesky_logdet_vjp_matches_jax(p):
    rng = np.random.default_rng(50 + p)
    m, jit = _jittered_case(p, rng)
    ldbar = rng.standard_normal(len(m))
    mt, jt = _t(m, grad=True), _t(jit, grad=True)
    ld, f = tl.cholesky_logdet(mt, jt)
    got = torch.autograd.grad(ld, (mt, jt), _t(ldbar))
    want_ld, vjp = jax.vjp(lambda mm, jj: jl.cholesky_logdet(mm, jj),
                           jnp.asarray(m), jnp.asarray(jit))
    want = vjp(jnp.asarray(ldbar))
    assert f[1] == 1e2 and f[2] == 1e2 and (f[[0, 3, 4]] == 1.0).all()
    _close(ld, want_ld)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)


@pytest.mark.parametrize("p", [4, 8, 17, 49])
def test_cholesky_inv_logdet_vjp_matches_jax(p):
    rng = np.random.default_rng(60 + p)
    m, jit = _jittered_case(p, rng)
    xbar = rng.standard_normal(m.shape)
    ldbar = rng.standard_normal(len(m))
    mt, jt = _t(m, grad=True), _t(jit, grad=True)
    x, ld, f = tl.cholesky_inv_logdet(mt, jt)
    got = torch.autograd.grad((x, ld), (mt, jt), (_t(xbar), _t(ldbar)))
    want_out, vjp = jax.vjp(lambda mm, jj: jl.cholesky_inv_logdet(mm, jj),
                            jnp.asarray(m), jnp.asarray(jit))
    want = vjp((jnp.asarray(xbar), jnp.asarray(ldbar)))
    assert f[1] == 1e2 and f[2] == 1e2
    for g, w in zip((x, ld), want_out):
        _close(g, w)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)


def test_gradcheck_cholesky_logdet_and_inv_logdet():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 5, 5))
    m = _t(a @ np.swapaxes(a, -1, -2) / 5 + np.eye(5), grad=True)
    jit = _t(np.full(3, 1e-3), grad=True)
    assert torch.autograd.gradcheck(
        lambda mm, jj: tl.cholesky_logdet(_sym(mm), jj)[0], (m, jit))
    assert torch.autograd.gradcheck(
        lambda mm, jj: tl.cholesky_inv_logdet(_sym(mm), jj)[:2], (m, jit))


def test_logdet_gradients_match_torch_float32():
    # test_pallas.py's TestCholeskyLogdet / TestCholeskyInvLogdet VJP
    # checks, float32 at their tolerance (rtol 1e-3)
    rng = np.random.default_rng(13)
    a = rng.standard_normal((3, 6, 6))
    m = torch.tensor(a @ np.swapaxes(a, -1, -2) / 6 + np.eye(6),
                     dtype=torch.float32)
    jit = torch.full((3,), 1e-4)
    eye = torch.eye(6)

    def grad(fn):
        s = torch.tensor(1.4, requires_grad=True)
        fn(s).backward()
        return float(s.grad)

    def ours_inv(s):
        x, ld, _ = tl.cholesky_inv_logdet(m * s, jit)
        return torch.sin(x).sum() + 2.0 * ld.sum()

    def ref_inv(s):
        c = torch.linalg.cholesky(m * s + jit[:, None, None] * eye)
        x = torch.linalg.solve_triangular(c, eye.expand_as(c), upper=False)
        ld = torch.log(torch.diagonal(c, dim1=-2, dim2=-1)).sum()
        return torch.sin(x).sum() + 2.0 * ld

    np.testing.assert_allclose(
        grad(lambda s: tl.cholesky_logdet(m * s, jit)[0].sum()),
        grad(lambda s: torch.log(torch.diagonal(torch.linalg.cholesky(
            m * s + jit[:, None, None] * eye), dim1=-2, dim2=-1)).sum()),
        rtol=1e-3)
    np.testing.assert_allclose(grad(ours_inv), grad(ref_inv), rtol=1e-3)


def test_all_fail_member_keeps_nan_to_itself():
    m = torch.stack([2.0 * torch.eye(4), -torch.eye(4),
                     3.0 * torch.eye(4)]).requires_grad_(True)
    jit = torch.full((3,), 1e-6)
    ld, f = tl.cholesky_logdet(m, jit)
    x, ld2, f2 = tl.cholesky_inv_logdet(m, jit)
    assert f[1] == 1e4 and f2[1] == 1e4 and torch.isnan(x[1]).any()
    g, = torch.autograd.grad(ld.sum() + ld2.sum(), m)
    assert torch.isfinite(g[[0, 2]]).all() and torch.isnan(g[1]).any()
    np.testing.assert_allclose(torch.diagonal(g[0]).numpy(),
                               np.full(4, 1.0 / (2 + 1e-6)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the launch on the card: one a call, at the core's width tier
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The kernel library replaced by a recorder of each launch's (batch, P,
    tier, f0, f1, f2); ``meta`` tensors stand in for CUDA ones (the device
    check sees a CUDA tensor of their shape)."""
    calls = []

    def recorder(kernel):
        def launch(*args):
            # ..., batch, p, tier, f0, f1, f2, device, stream
            calls.append((kernel,) + tuple(args[-8:-2]))
            return 0
        return launch

    lib = types.SimpleNamespace(
        pymra_chol_logdet=recorder("chol_logdet"),
        pymra_chol_inv_logdet=recorder("chol_inv_logdet"),
        pymra_cholesky_jittered=recorder("cholesky_jittered"))
    real = tl._check_square
    monkeypatch.setattr(tl, "_check_square", lambda name, t: real(
        name, types.SimpleNamespace(device=torch.device("cuda"),
                                    ndim=t.ndim, shape=t.shape)))
    monkeypatch.setattr(tl.build, "load_library", lambda: lib)
    monkeypatch.setattr(tl, "_where", lambda t: (0, 0))
    for fn in (tl.cholesky_logdet, tl.cholesky_inv_logdet,
               tl.cholesky_jittered):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


@pytest.mark.parametrize("name, kernel", [
    ("cholesky_logdet", "chol_logdet"),
    ("cholesky_inv_logdet", "chol_inv_logdet")])
def test_one_launch_a_call_at_the_tile_tier(recorded, name, kernel):
    fn = getattr(tl, name)
    widths = (1, 15, 16, 17, 49, 64)
    for n, p in enumerate(widths, 1):
        out = fn(torch.empty((3, p, p), device="meta"),
                 torch.empty(3, device="meta"))
        assert out[-1].shape == (3,) and fn.launches == n
    assert [tl.tile_tier(p) for p in widths] == [16, 16, 16, 32, 64, 64]
    assert recorded == [(kernel, 3, p, tl.tile_tier(p)) + tl.FACTORS
                        for p in widths]
    recorded.clear()
    with pytest.raises(ValueError, match="P=65"):
        fn(torch.empty((3, 65, 65), device="meta"),
           torch.empty(3, device="meta"))
    assert recorded == [] and fn.launches == len(widths)


def test_k2_takes_the_core_above_the_subwarp_widths(recorded):
    # K2: one launch a call; P <= 8 the sub-warp groups (route 0), 9 <= P
    # <= 64 the register-tiled core at the width tier tile_tier(P)
    widths = (4, 8, 9, 16, 17, 49, 64)
    for n, p in enumerate(widths, 1):
        l, ld, f = tl.cholesky_jittered(torch.empty((3, p, p), device="meta"),
                                        torch.empty(3, device="meta"))
        assert l.shape == (3, p, p) and ld.shape == f.shape == (3,)
        assert tl.cholesky_jittered.launches == n
    assert [tl.jittered_tier(p) for p in widths] == [0, 0, 16, 16, 32, 64,
                                                      64]
    assert recorded == [("cholesky_jittered", 3, p,
                         tl.tile_tier(p) if p > 8 else 0) + tl.FACTORS
                        for p in widths]
