"""The port's covariance families and distances against ``pymra_tpu``.

Same float64 inputs (numpy, seeded) through both packages. Tolerance: rtol
1e-12 — both compute the same float64 expression, so only the last-ulp
rounding of exp/sin/cos may differ; atol 1e-15 covers the kanter taper's
values that are analytically 0 near the support edge.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.ops import distances as jd
from pymra_torch import kernels as tk
from pymra_torch.ops import distances as td
from tests.torch_fixtures import jax_native_planner  # noqa: F401

RTOL, ATOL = 1e-12, 1e-15


def _pts(seed, shape):
    return np.random.default_rng(seed).random(shape)


def _both(fn_t, fn_j, a, b, **kw):
    ta = torch.as_tensor(a)
    tb = None if b is None else torch.as_tensor(b)
    ja = jnp.asarray(a, dtype=jnp.float64)
    jb = None if b is None else jnp.asarray(b, dtype=jnp.float64)
    return (fn_t(ta, tb, **kw).numpy(), np.asarray(fn_j(ja, jb, **kw)))


FAMILIES = ["identity", "exponential", "matern12", "matern32", "matern52",
            "gaussian"]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("self_pair", [False, True])
def test_family_matches_jax_batched_2d(name, self_pair):
    a = _pts(0, (3, 6, 2))
    b = None if self_pair else _pts(1, (3, 5, 2))
    got, want = _both(tk.get_kernel(name), jk.get_kernel(name), a, b,
                      l=0.37, sig=1.7)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax_circular_1d(name):
    a, b = _pts(2, (7, 1)), _pts(3, (4, 1))
    got, want = _both(tk.get_kernel(name), jk.get_kernel(name), a, b,
                      l=0.21, circular=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_matern_closed_forms_match_jax(nu):
    a, b = _pts(4, (9, 2)), _pts(5, (6, 2))
    got, want = _both(tk.matern, jk.matern, a, b, l=0.3, sig=0.9, nu=nu)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_general_nu_matern_is_not_ported_yet():
    # (named before the port had it) general nu through the Bessel K of
    # pymra_torch/ops/special.py, against the JAX package's, batched and
    # circular as the families above
    a, b = _pts(10, (3, 9, 2)), _pts(11, (3, 6, 2))
    for nu in (0.7, 1.2, 3.4):
        got, want = _both(tk.matern, jk.matern, a, b, l=0.3, sig=1.4, nu=nu)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got, want = _both(tk.matern, jk.matern, _pts(12, (7, 1)), None, l=0.21,
                      nu=0.8, circular=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.diag(got) == 1.0)


@pytest.mark.parametrize("radius", [0.35, 9])
def test_kanter_matches_jax(radius):
    # radius 9 is an ensemble size converted through determine_radius
    from pymra_torch.utils import gen_locations_2d

    a = gen_locations_2d(8)
    got, want = _both(tk.kanter, jk.kanter, a, None, radius=radius)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got == 0.0).any() and np.all(np.diag(got) == 1.0)


@pytest.mark.parametrize("k,ndim", [(1, 2), (9, 2), (12, 2), (30, 2),
                                    (49, 2), (6, 1)])
def test_determine_radius_matches_jax(k, ndim):
    assert tk.determine_radius(k, 0.1, ndim) == jk.determine_radius(
        k, 0.1, ndim)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_sqdist_matches_jax(d):
    # d <= 4 sums direct differences; d > 4 takes the clamped expansion
    # with exact diagonal zeros
    a, b = _pts(6, (2, 8, d)), _pts(7, (2, 5, d))
    for bb in (b, None):
        got, want = _both(td.sqdist, jd.sqdist, a, bb)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    self_d = td.sqdist(torch.as_tensor(a))
    assert torch.all(torch.diagonal(self_d, dim1=-2, dim2=-1) == 0.0)


def test_kernel_module_holds_tensor_params():
    kern = tk.Kernel("matern32", l=0.3, sig=2.0)
    assert isinstance(kern, torch.nn.Module)
    assert set(kern.params) == {"l", "sig"}
    assert all(p.dtype == torch.float64 and p.ndim == 0
               for p in kern.params.values())
    a = _pts(8, (5, 2))
    jkern = jk.Kernel("matern32", l=0.3, sig=2.0)
    np.testing.assert_allclose(kern(torch.as_tensor(a)).numpy(),
                               np.asarray(jkern(jnp.asarray(a))),
                               rtol=RTOL, atol=ATOL)
    k2 = kern.replace(l=0.5)
    assert float(k2.l) == 0.5 and float(k2.sig) == 2.0
    with pytest.raises(KeyError, match="available"):
        tk.Kernel("nope")
    # the dense-matrix covariance: an nn.Module holding the matrix as a
    # buffer, gathering blocks by location index as the JAX package's
    mat = _pts(13, (6, 6))
    mk = tk.MatrixKernel(mat)
    assert isinstance(mk, torch.nn.Module) and mk.matrix.dtype == torch.float64
    idx = np.array([[[2], [0], [5]], [[1], [1], [4]]])
    np.testing.assert_array_equal(
        mk(torch.as_tensor(idx)).numpy(),
        np.asarray(jk.MatrixKernel(mat)(idx.astype(np.float64))))


def test_float32_locations_compute_in_float32():
    # a float64 0-dim parameter must not promote float32 locations, and it
    # is rounded to float32 once, as JAX rounds its weakly typed scalars
    a = _pts(9, (6, 2)).astype(np.float32)
    got = tk.Kernel("exponential", l=0.3)(torch.as_tensor(a))
    want = np.asarray(jk.Kernel("exponential", l=0.3)(
        jnp.asarray(a, dtype=jnp.float32)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
