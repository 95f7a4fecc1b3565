"""The port's sweep against exact dense-GP oracles: the configurations of
``tests/test_sweep_exactness.py`` (``TestExactConfigs``,
``TestApproximateConfigs``, ``TestDeepTreeFloat32``), at that file's
tolerances.

Where the multi-resolution approximation is provably exact (M=0; the 1-D
exponential kernel with knots on partition boundaries: the screening
effect) the port's float64 sweep matches dense kriging
(``tests/oracles.py::exact_gp``) to round-off; a smooth 2-D configuration
stays close; and the port's float32 kernel structure (the card's sequence
of kernels, here on their twins) holds the deepest 1-D screening trees to
the float64 sweep, objective < 5e-4. The exact and deep configurations
draw numpy-seeded data from the exact covariance; the approximate ones,
whose bounds hold for a draw rather than for every draw, take the JAX
file's data (its simulator and seeds) and are also held to the JAX
package's sweep on them (float64: objective rtol 1e-10, mean atol 1e-10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, MRATree
from pymra_torch.utils import gen_locations, gen_locations_2d

from tests import test_sweep_exactness as jax_exactness
from tests.oracles import exact_gp
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64


def _make_data(locs, kern, me_scale, frac_obs, seed):
    """A draw of the field at ``locs`` plus measurement error of variance
    ``me_scale``, ``frac_obs`` of it observed (the rest NaN); also the
    covariance matrix."""
    sig = kern(torch.as_tensor(locs, dtype=F64)).numpy()
    rng = np.random.default_rng(seed)
    n = len(sig)
    x = np.linalg.cholesky(sig + 1e-10 * np.eye(n)) @ rng.standard_normal(n)
    y = x + np.sqrt(me_scale) * rng.standard_normal(n)
    y[rng.permutation(n)[int(round(n * frac_obs)):]] = np.nan
    return y, sig


def _sweep(locs, kern, y, R, dtype=F64, **kw):
    return MRAModel(locs, dtype=dtype, device="cpu", **kw).sweep(kern, y, R)


def _jax_data(locs, name, params, me_scale, frac_obs, seed, R, **kw):
    """The JAX file's draw, the port's sweep on it, the JAX package's
    sweep and the covariance matrix."""
    kern = Kernel(name, **params)
    y = np.asarray(jax_exactness._make_data(locs, jk.Kernel(name, **params),
                                            me_scale, frac_obs, seed))
    res = _sweep(locs, kern, y, R, **kw)
    ref = JaxMRAModel(locs, **kw).sweep(jk.Kernel(name, **params), y, R)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-10)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=1e-10)
    return y, res, kern(torch.as_tensor(locs, dtype=F64)).numpy()


class TestExactConfigs:
    def test_m0_1d_exponential(self):
        locs = gen_locations(12)
        kern = Kernel("exponential", l=1.0)
        y, sig = _make_data(locs, kern, 1e-4, 0.5, 0)
        res = _sweep(locs, kern, y, 1e-4, r=12, M=0)
        oracle = exact_gp(sig, y, 1e-4)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-9)
        np.testing.assert_allclose(float(res.loglik), oracle["loglik"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-9)
        np.testing.assert_allclose(np.sqrt(res.var.numpy()), oracle["sd"],
                                   atol=1e-8)

    def test_m0_2d_matern(self):
        locs = gen_locations_2d(5)
        kern = Kernel("matern32", l=0.4, sig=1.3)
        y, sig = _make_data(locs, kern, 1e-3, 0.6, 2)
        res = _sweep(locs, kern, y, 1e-3, r=25, M=0)
        oracle = exact_gp(sig, y, 1e-3)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-9)
        np.testing.assert_allclose(np.sqrt(res.var.numpy()), oracle["sd"],
                                   atol=1e-8)

    @pytest.mark.parametrize("M,r", [(1, 2), (2, 2), (3, 2)])
    def test_screening_1d_exponential(self, M, r):
        locs = gen_locations(100)
        kern = Kernel("exponential", l=0.3)
        y, sig = _make_data(locs, kern, 1e-2, 0.4, 11)
        res = _sweep(locs, kern, y, 1e-2, r=r, M=M, J=r + 1)
        oracle = exact_gp(sig, y, 1e-2)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-8)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-8)
        np.testing.assert_allclose(np.sqrt(res.var.numpy()), oracle["sd"],
                                   atol=1e-7)

    def test_screening_tiny(self):
        locs = gen_locations(3)
        kern = Kernel("exponential", l=1.0)
        y, sig = _make_data(locs, kern, 1e-6, 0.67, 5)
        res = _sweep(locs, kern, y, 1e-6, r=1, M=1, J=2)
        oracle = exact_gp(sig, y, 1e-6)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-7)
        np.testing.assert_allclose(np.sqrt(res.var.numpy()), oracle["sd"],
                                   atol=1e-7)


class TestApproximateConfigs:
    def test_2d_matern32_close(self):
        locs = gen_locations_2d(10)
        y, res, sig = _jax_data(locs, "matern32", {"l": 0.5, "sig": 1.0},
                                1e-4, 0.7, 12, 1e-4, r=2, M=2, J=3)
        oracle = exact_gp(sig, y, 1e-4)
        signal = np.abs(oracle["mean"]).mean()
        err = np.abs(res.mean.numpy() - oracle["mean"]).max()
        assert err < 0.15 * signal
        assert np.isfinite(float(res.objective))

    def test_early_leaves_masking(self):
        locs = gen_locations(30)
        y, res, sig = _jax_data(locs, "exponential", {"l": 0.5}, 1e-3, 0.5,
                                7, 1e-3, r=2, M=3, J=3)
        plan = MRAModel(locs, r=2, M=3, J=3, dtype=F64, device="cpu").plan
        assert any(g.n_leaf and g.level < plan.M for g in plan.levels) \
            or plan.levels[-1].n_leaf > 0
        assert np.isfinite(float(res.objective))
        assert torch.isfinite(res.mean).all() and (res.var >= -1e-12).all()
        np.testing.assert_allclose(res.mean.numpy(),
                                   exact_gp(sig, y, 1e-3)["mean"], atol=1e-6)

    def test_diagonal_r(self):
        locs = gen_locations(20)
        r_diag = 10 ** np.random.default_rng(1).uniform(-4, -2, size=20)
        y, res, sig = _jax_data(locs, "exponential", {"l": 0.7}, 1e-3, 0.5,
                                9, r_diag, r=20, M=0)
        oracle = exact_gp(sig, y, r_diag)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-9)
        # the facade on the same exact configuration
        tree = MRATree(locs, 20, Kernel("exponential", l=0.7), y, r_diag,
                       M=0, dtype=F64, device="cpu")
        np.testing.assert_allclose(tree.getLikelihood(), oracle["objective"],
                                   rtol=1e-9)


class TestDeepTreeFloat32:
    """The port's float32 kernel structure composes the chain's explicit
    triangular inverses down the deepest 1-D screening trees: bounded
    against the float64 sweep at the JAX test's limits."""

    @pytest.mark.parametrize("M,r", [(5, 2), (6, 2)])
    def test_deep_tree_f32_vs_f64(self, M, r):
        n = 4500  # deep enough for M=6 at J=r+1=3
        locs = gen_locations(n)
        kern = Kernel("exponential", l=0.25)
        y, _ = _make_data(locs, kern, 1e-2, 0.5, 4)
        m64 = MRAModel(locs, r=r, M=M, J=r + 1, dtype=F64, device="cpu")
        m32 = MRAModel(locs, r=r, M=M, J=r + 1, dtype=torch.float32,
                       device="cpu")
        assert m64.plan.M == M and m32.jitter > 0
        res64 = m64.sweep(kern, y, 1e-2)
        res32 = m32.sweep(kern, y, 1e-2)
        obj64 = float(res64.objective)
        rel_obj = abs(float(res32.objective) - obj64) / abs(obj64)
        assert rel_obj < 5e-4, f"objective rel err {rel_obj:.2e} at M={M}"
        mean64 = res64.mean.numpy()
        mean_err = np.abs(res32.mean.double().numpy() - mean64).max()
        assert mean_err < 5e-3 * max(np.abs(mean64).max(), 1.0)
        sd64 = np.sqrt(np.maximum(res64.var.numpy(), 0.0))
        sd32 = np.sqrt(np.maximum(res32.var.double().numpy(), 0.0))
        assert np.abs(sd32 - sd64).max() < 5e-3
