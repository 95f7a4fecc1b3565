"""Plain twins of the CUDA kernels against the JAX package's Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, called directly
(the way ``tests/test_pallas.py`` runs them). Inputs are made once with
numpy from a seed and handed to both. Float32 tolerances: rtol 1e-4 /
atol 1e-5 on factors, inverse factors and log-determinants (the two column
loops round in different places), and the selected escalation factors must
be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl
from pymra_torch.ops.cuda import build

RTOL, ATOL = 1e-4, 1e-5
WIDTHS = [5, 17, 49]


def _spd(rng, b, p):
    a = rng.standard_normal((b, p, p))
    return a @ np.swapaxes(a, -1, -2) / p + np.eye(p)


def _chol_case(p):
    """Healthy members, the escalation members of test_pallas.py's
    escalation case (a singular rank-1 block and one indefinite beyond the
    base jitter) and the exact-zero pivot construction: diag(1, .., 1, -js)
    plus js*I has an exactly zero last pivot on the first attempt."""
    rng = np.random.default_rng(p)
    good = _spd(rng, 6, p)
    ones = np.ones((p, p))
    neg = ones - 1e-4 * np.eye(p)
    js = 1e-4
    zero = np.diag(np.r_[np.ones(p - 1), -js])
    m = np.concatenate([good, ones[None], neg[None], zero[None]])
    jit = np.full(len(m), 1e-6)
    jit[-1] = js
    return m.astype(np.float32), jit.astype(np.float32)


def _jax_chol(m, jit):
    l, f = jl._cholesky_jittered_pair(jnp.asarray(m, dtype=jnp.float32),
                                      jnp.asarray(jit, dtype=jnp.float32),
                                      tl.FACTORS)
    return np.asarray(l), np.asarray(f)


@pytest.mark.parametrize("p", WIDTHS)
def test_cholesky_jittered_ref_matches_pallas(p):
    m, jit = _chol_case(p)
    l, ld, f = tl.cholesky_jittered(torch.as_tensor(m), torch.as_tensor(jit))
    want_l, want_f = _jax_chol(m, jit)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=RTOL, atol=ATOL)
    # the singular rank-1 member needs only the base jitter; the
    # indefinite one and the zero pivot really escalated
    assert (f[:7] == 1.0).all() and f[7] > 1.0 and f[8] == 1e2
    np.testing.assert_allclose(float(l[-1, -1, -1]), np.sqrt(99e-4),
                               rtol=1e-4)
    assert torch.isfinite(l).all()
    np.testing.assert_allclose(
        ld.numpy(), np.log(np.diagonal(want_l, axis1=-2, axis2=-1)).sum(-1),
        rtol=RTOL, atol=ATOL)


def test_cholesky_jittered_ref_keeps_nan_when_every_factor_fails():
    m = np.stack([-np.eye(4), np.eye(4)]).astype(np.float32)
    jit = np.full(2, 1e-6, dtype=np.float32)
    l, ld, f = tl.cholesky_jittered(torch.as_tensor(m), torch.as_tensor(jit))
    want_l, want_f = _jax_chol(m, jit)
    np.testing.assert_array_equal(f.numpy(), want_f)
    assert f[0] == 1e4 and torch.isnan(l[0]).any() and not torch.isfinite(
        ld[0])
    assert np.isnan(want_l[0]).any()
    np.testing.assert_allclose(l[1].numpy(), np.eye(4), rtol=RTOL)


def test_cholesky_jittered_ref_float64_matches_numpy():
    rng = np.random.default_rng(0)
    m = _spd(rng, 5, 9)
    jit = np.full(5, 1e-3)
    l, _, f = tl.cholesky_jittered(torch.as_tensor(m), torch.as_tensor(jit))
    np.testing.assert_allclose(
        l.numpy(), np.linalg.cholesky(m + 1e-3 * np.eye(9)), rtol=1e-12,
        atol=1e-14)
    assert (f == 1.0).all()


def _leaf_case(p, b=9):
    """test_pallas.py's TestLeafFactor case at float32: random SPD c with
    one member shifted indefinite, a random knot mask with one fully masked
    (dummy) leaf, and a knot-masked data Gram a_oo."""
    rng = np.random.default_rng(100 + p)
    c = _spd(rng, b, p)
    c[4] -= (p / 2 + 4.0) * np.eye(p)
    kmask = (rng.random((b, p)) < 0.7).astype(np.float64)
    kmask[1] = 0.0
    a2 = rng.standard_normal((b, p, p))
    a_oo = a2 @ np.swapaxes(a2, -1, -2) * 0.1 / p
    a_oo = a_oo * kmask[:, :, None] * kmask[:, None, :]
    f32 = np.float32
    return c.astype(f32), kmask.astype(f32), a_oo.astype(f32)


def _jax_leaf(c, kmask, a_oo, jitter):
    out = jl._leaf_factor_tuple(
        jnp.asarray(c, dtype=jnp.float32), jnp.asarray(kmask, jnp.float32),
        jnp.asarray(a_oo, dtype=jnp.float32), jitter, tl.FACTORS)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("p", WIDTHS)
def test_leaf_factor_ref_matches_pallas(p):
    c, kmask, a_oo = _leaf_case(p)
    jitter = 1e-2
    got = [o.numpy() for o in tl.leaf_factor(
        torch.as_tensor(c), torch.as_tensor(kmask), torch.as_tensor(a_oo),
        jitter)]
    want = _jax_leaf(c, kmask, a_oo, jitter)
    li, ldp, ldq, fp, fq = got
    np.testing.assert_array_equal(fp, want[3])
    np.testing.assert_array_equal(fq, want[4])
    np.testing.assert_allclose(ldp, want[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ldq, want[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(li, want[0], rtol=RTOL, atol=ATOL)
    # fully masked leaf: K_leaf = I, so Li = (1 + jit s)^-1/2 I exactly
    s = 2.0
    np.testing.assert_allclose(li[1], np.eye(p) / np.sqrt(1 + jitter * s),
                               rtol=1e-6)
    assert np.all(np.isfinite(li))


def test_leaf_factor_ref_escalates_indefinite_member():
    c, kmask, a_oo = _leaf_case(17)
    # the indefinite member needs more than the base jitter when its knots
    # carry the shifted diagonal
    kmask[4] = 1.0
    a_oo[4] = 0.0
    got = tl.leaf_factor(torch.as_tensor(c), torch.as_tensor(kmask),
                         torch.as_tensor(a_oo), 1e-2)
    want = _jax_leaf(c, kmask, a_oo, 1e-2)
    assert got[3][4] > 1.0 and got[4][4] > 1.0
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])


def test_leaf_factor_ref_exact_zero_pivot_fails_through_all_factors():
    # jitter 0: an exactly zero pivot gives a -inf log-pivot sum at every
    # factor; the member must report the last factor and a non-finite
    # log-determinant, its neighbours stay untouched
    p = 6
    c = np.stack([np.diag(np.r_[np.ones(p - 1), 0.0]), 2.0 * np.eye(p)])
    c = c.astype(np.float32)
    kmask = np.ones((2, p), dtype=np.float32)
    a_oo = np.zeros_like(c)
    got = tl.leaf_factor(torch.as_tensor(c), torch.as_tensor(kmask),
                         torch.as_tensor(a_oo), 0.0)
    want = _jax_leaf(c, kmask, a_oo, 0.0)
    for i in (3, 4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    assert got[3][0] == 1e4 and got[4][0] == 1e4
    assert not torch.isfinite(got[1][0]) and not torch.isfinite(got[2][0])
    assert not np.isfinite(want[1][0])
    np.testing.assert_allclose(got[0][1].numpy(), np.eye(p) / np.sqrt(2.0),
                               rtol=1e-6)


def test_leaf_factor_ref_float64_matches_numpy_oracle():
    rng = np.random.default_rng(7)
    p, b, jitter = 12, 4, 1e-3
    c = _spd(rng, b, p)
    kmask = (rng.random((b, p)) < 0.6).astype(np.float64)
    a2 = rng.standard_normal((b, p, p))
    a_oo = a2 @ np.swapaxes(a2, -1, -2) * 0.1 * kmask[:, :, None] \
        * kmask[:, None, :]
    li, ldp, ldq, fp, fq = tl.leaf_factor(
        torch.as_tensor(c), torch.as_tensor(kmask), torch.as_tensor(a_oo),
        jitter)
    for i in range(b):
        kl = c[i] * np.outer(kmask[i], kmask[i]) + np.diag(1 - kmask[i])
        s = np.abs(np.diag(kl)).mean() + 1.0
        lp = np.linalg.cholesky(kl + jitter * s * np.eye(p))
        lq = np.linalg.cholesky(kl + jitter * s * np.eye(p) + a_oo[i])
        np.testing.assert_allclose(float(ldp[i]), np.log(np.diag(lp)).sum(),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(ldq[i]), np.log(np.diag(lq)).sum(),
                                   rtol=1e-12)
        np.testing.assert_allclose(li[i].numpy(), np.linalg.inv(lq),
                                   rtol=1e-10, atol=1e-12)
    assert (fp == 1.0).all() and (fq == 1.0).all()


# ---------------------------------------------------------------------------
# device routing: a non-CPU tensor reaches the kernel or raises
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(*shape, dtype=torch.float32, device="meta")


def test_non_cpu_call_raises_without_kernel_library(monkeypatch):
    def missing():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(build, "load_library", missing)
    before = (tl.cholesky_jittered_ref.cuda_calls,
              tl.leaf_factor_ref.cuda_calls, tl.cholesky_jittered.launches,
              tl.leaf_factor.launches)
    with pytest.raises(RuntimeError, match="no kernel library"):
        tl.cholesky_jittered(_meta(3, 4, 4), _meta(3))
    with pytest.raises(RuntimeError, match="no kernel library"):
        tl.leaf_factor(_meta(3, 4, 4), _meta(3, 4), _meta(3, 4, 4), 1e-6)
    assert before == (tl.cholesky_jittered_ref.cuda_calls,
                      tl.leaf_factor_ref.cuda_calls,
                      tl.cholesky_jittered.launches, tl.leaf_factor.launches)


def test_non_cuda_device_is_refused(monkeypatch):
    monkeypatch.setattr(build, "load_library", lambda: object())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tl.cholesky_jittered(_meta(3, 4, 4), _meta(3))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tl.leaf_factor(_meta(3, 4, 4), _meta(3, 4), _meta(3, 4, 4), 1e-6)


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
