"""The wide kernel's functions — K8 ``cholesky_blocked`` and KC
``cholesky_cascade`` for 64 < P <= 256, one kernel on the card
(``pymra_torch/ops/cuda/csrc/chol_wide.cu``) — on the CPU through their
autograd Functions, which run the twins there.

The members are those ``chip_smoke.py`` phase 3 holds the kernel to its
twins on (``wide_case``: escalated to 1e2 and to 1e4, failing every
factor, a NaN in one member), held here to the JAX package: K8 to its
``cholesky_blocked``, KC to the sweep's ``_chol_cascade`` under
``PYMRA_PALLAS=force`` (the TPU dispatch, over ``cholesky_blocked``), as
``tests/test_torch_blocked.py`` does; the JAX cascade runs its kernels
interpreted, ~10 s a width, so it is held at two widths and the port's
cascade at every width to its own K8 at the selected factors. The JAX
package keeps its panels in float32, the port in float64: float32
tolerances rtol 1e-4 / atol 1e-5 plus 1e-4 of the member's largest entry,
selected factors identical. JAX's kernels write NaN over a failed member
more widely than the port's twins (whole rows, the upper triangle), so
against JAX a member is held to be finite or not, and the finite members
to their values; the port's own NaN pattern is the twins' (held on the
card by ``chip_smoke.py``). The width dispatch on the card is checked
with the launch and the composition replaced by recorders, on tensors of
the ``meta`` device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import chip_smoke
from pymra_tpu.ops.pallas import linalg as jl
from pymra_tpu.tree import sweep as jsweep
from pymra_torch.ops import linalg as tl
from tests.test_torch_grad import _close, _t
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
WIDTHS = [65, 128, 169, 256]


def _case(p):
    """Members 0-5 of phase 3's wide batch: healthy, 1e2 (indefinite),
    1e2 (exact zero pivot), all-fail (-I), 1e4, all-fail (a NaN)."""
    return chip_smoke.wide_case(np.random.default_rng(p), 6, p)


def _near(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL + RTOL * np.abs(want).max())


def _jax_cascade(monkeypatch, m, jit):
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        return np.asarray(jsweep._chol_cascade(
            jnp.asarray(m), jnp.asarray(jit)[:, None, None]))
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()


def _cascade(p):
    m, jit = _case(p)
    l, ld, f = tl.cholesky_cascade(torch.as_tensor(m), torch.as_tensor(jit))
    np.testing.assert_array_equal(f.numpy(), [1, 1e2, 1e2, 1e4, 1e4, 1e4])
    ok = torch.isfinite(l).flatten(1).all(1).numpy()
    np.testing.assert_array_equal(ok, [1, 1, 1, 0, 1, 0])
    assert torch.isnan(ld[~torch.as_tensor(ok)]).all()
    assert (torch.triu(l, 1) == 0).all()
    return m, jit, l, ld, f, ok


@pytest.mark.parametrize("p", WIDTHS)
def test_cascade_is_the_blocked_factor_at_the_selected_factor(p):
    # the cascade's twin: one K8 attempt per factor, a member kept at its
    # first finite one (the all-fail members at their last)
    m, jit, l, ld, f, ok = _cascade(p)
    eye = torch.eye(p)
    jit32 = torch.as_tensor(jit)
    at = torch.as_tensor(m) + eye * (jit32 * f)[:, None, None]
    want = tl.cholesky_blocked(at)
    torch.testing.assert_close(l, want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        ld[ok], torch.log(torch.diagonal(want[ok], dim1=-2, dim2=-1)).sum(-1),
        rtol=0, atol=0)


@pytest.mark.parametrize("p", [65, 169])
def test_cascade_members_match_jax(monkeypatch, p):
    m, jit, l, ld, f, ok = _cascade(p)
    want = _jax_cascade(monkeypatch, m, jit)
    np.testing.assert_array_equal(np.isfinite(want).all((-2, -1)), ok)
    for i in np.flatnonzero(ok):
        _near(l[i].numpy(), want[i])
    np.testing.assert_allclose(
        ld.numpy()[ok],
        np.log(np.diagonal(want[ok], axis1=-2, axis2=-1)).sum(-1),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", WIDTHS)
def test_blocked_members_match_jax(p):
    # no jitter: the healthy member is finite; the indefinite, zero-pivot,
    # -I and 1e4 members are NaN from their failing column on, the NaN
    # member from its NaN's row on, each in its own member only
    m, _ = _case(p)
    got = tl.cholesky_blocked(torch.as_tensor(m)).numpy()
    want = np.asarray(jl.cholesky_blocked(jnp.asarray(m)))
    np.testing.assert_array_equal(np.isfinite(got).all((-2, -1)),
                                  np.isfinite(want).all((-2, -1)))
    assert np.isfinite(got[0]).all() and np.isnan(got[3][:, 0]).all()
    assert not np.isfinite(got[5]).all()
    # columns before the failing block column stay finite
    assert np.isfinite(got[1][:, :64]).all() or p < 128
    # a failed member's finite entries lie just before an indefinite
    # pivot, where float32 and float64 panels part; the finite members
    # are held to the tolerance
    for i in np.flatnonzero(np.isfinite(want).all((-2, -1))):
        _near(got[i], want[i])
    assert (np.triu(got, 1) == 0).all()


@pytest.mark.parametrize("p", [96])
def test_blocked_function_backward_matches_jax_vjp(p):
    # float64: the Function's backward is the symmetric Cholesky pullback;
    # JAX's VJP of its composition puts the off-diagonal gradient on the
    # lower blocks it reads, so the symmetric parts are compared
    rng = np.random.default_rng(p)
    a = rng.standard_normal((1, p, p))
    m = a @ np.swapaxes(a, -1, -2) / p + np.eye(p)
    lbar = np.tril(rng.standard_normal(m.shape))
    mt = _t(m, grad=True)
    l = tl.cholesky_blocked(mt)
    got, = torch.autograd.grad(l, mt, _t(lbar))
    want_l, vjp = jax.vjp(jl.cholesky_blocked, jnp.asarray(m))
    want = np.asarray(vjp(jnp.asarray(lbar))[0])
    _close(l, want_l, rtol=1e-10)
    _close(got, 0.5 * (want + np.swapaxes(want, -1, -2)), rtol=1e-8)


# ---------------------------------------------------------------------------
# the width dispatch on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p, block, wide", [
    (64, 64, False), (65, 64, True), (169, 64, True), (256, 64, True),
    (257, 64, False), (169, 32, False), (128, 128, False)])
def test_wide_kernel_takes_64_to_256_in_64_wide_blocks(p, block, wide):
    assert tl._wide_kernel(p, block) is wide


@pytest.fixture
def recorded(monkeypatch):
    """The launch and the compositions replaced by recorders; ``meta``
    tensors stand in for CUDA ones (the wrappers' device checks pass)."""
    calls = []

    def wide(mat, jit, factors):
        calls.append(("kernel", mat.shape[-1], jit is not None))
        b = mat.shape[:-2]
        return torch.empty_like(mat), torch.empty(b), torch.empty(b)

    def blocked(mat, block, chol, tri_inv):
        calls.append(("blocked", mat.shape[-1], block))
        return torch.empty_like(mat)

    def escalate(base, jit, factors, attempt):
        calls.append(("escalate", base.shape[-1]))
        n = base.shape[0]
        return (torch.empty_like(base),), torch.empty(n), torch.empty(n)

    monkeypatch.setattr(tl, "_on_card", lambda name, mat: None)
    monkeypatch.setattr(tl, "_chol_wide", wide)
    monkeypatch.setattr(tl, "_blocked", blocked)
    monkeypatch.setattr(tl, "_escalate", escalate)
    for fn in (tl.cholesky_blocked, tl.cholesky_cascade):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "composed", 0)
    return calls


def _meta(b, p):
    return (torch.empty((b, p, p), device="meta"),
            torch.empty((b,), device="meta"))


def test_dispatch_counts_kernel_launches_and_compositions(recorded):
    for p in (65, 256):
        m, jit = _meta(3, p)
        tl._cholesky_blocked_fwd(m, 64)
        tl._cholesky_cascade_fwd(m, jit, tl.FACTORS)
    m, jit = _meta(3, 300)
    tl._cholesky_blocked_fwd(m, 64)
    tl._cholesky_cascade_fwd(m, jit, tl.FACTORS)
    tl._cholesky_blocked_fwd(_meta(3, 128)[0], 32)
    tl._cholesky_cascade_fwd(*_meta(3, 40), tl.FACTORS)
    assert recorded == [
        ("kernel", 65, False), ("kernel", 65, True),
        ("kernel", 256, False), ("kernel", 256, True),
        ("blocked", 300, 64), ("escalate", 300), ("blocked", 128, 32),
        ("escalate", 40)]
    assert tl.cholesky_blocked.launches == 2
    assert tl.cholesky_cascade.launches == 2
    assert tl.cholesky_blocked.composed == 2
    assert tl.cholesky_cascade.composed == 2


@pytest.mark.parametrize("make, match", [
    (lambda: torch.empty((2, 96, 96), dtype=torch.float64, device="meta"),
     "takes float32"),
    (lambda: torch.empty((2, 96, 96), device="meta").transpose(-1, -2),
     "contiguous")])
def test_wide_kernel_refuses_inputs_it_does_not_take(make, match):
    # checked before the library is built or loaded
    with pytest.raises((TypeError, ValueError), match=match):
        tl._chol_wide(make(), None, None)


def test_cascade_refuses_a_jitter_of_another_shape(recorded):
    m, _ = _meta(3, 96)
    with pytest.raises(ValueError, match="shape"):
        tl._cholesky_cascade_fwd(m, torch.empty((2,), device="meta"),
                                 tl.FACTORS)
