"""The port's Bessel K and general-nu Matern (``pymra_torch/ops/special.py``)
against ``scipy.special.kv`` and the JAX package: the cases of
``tests/test_special.py``.

Tolerances: ``kv_frac`` rtol 1e-10 against scipy (the JAX test's) and 1e-12
against the JAX package's ``kv_frac`` (the same fixed iterations in
float64); ``matern_general`` rtol 1e-10 / atol 1e-12 against the closed
forms (the JAX test's); gradients rtol 1e-6 against a central difference
(the JAX test's) and 1e-10 against ``jax.grad``; the M=0 sweep rtol 1e-8
against the dense oracle (the JAX test's) and 1e-10 against the JAX sweep.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from scipy.special import kv as scipy_kv

from pymra_tpu import kernels as jk
from pymra_tpu.ops.special import kv_frac as jax_kv_frac
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel
from pymra_torch import kernels as tk
from pymra_torch.ops.distances import dist
from pymra_torch.ops.special import kv_frac, matern_general
from pymra_torch.utils import gen_locations

from tests.oracles import exact_gp
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64
X = np.concatenate([
    np.logspace(-8, 0.3, 40),      # Temme series regime
    np.linspace(0.5, 1.99, 20),
    [1.9999, 2.0, 2.0001],         # regime boundary
    np.linspace(2.001, 50.0, 40),  # CF2 regime
])


class TestKvFrac:
    @pytest.mark.parametrize(
        "nu", [0.05, 0.3, 0.7, 0.95, 1.0, 1.05, 1.5, 2.0, 2.2, 3.7, 5.0, 7.3]
    )
    def test_matches_scipy_both_regimes(self, nu):
        ours = kv_frac(nu, torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(ours, scipy_kv(nu, X), rtol=1e-10)
        np.testing.assert_allclose(
            ours, np.asarray(jax_kv_frac(nu, jnp.asarray(X))), rtol=1e-12)

    def test_jit_and_vmap(self):
        # a batched argument
        x = torch.linspace(0.1, 10.0, 16, dtype=F64).reshape(4, 4)
        np.testing.assert_allclose(kv_frac(0.7, x).numpy(),
                                   scipy_kv(0.7, x.numpy()), rtol=1e-10)

    @pytest.mark.parametrize("nu", [0.3, 0.7, 0.8, 1.5, 3.7])
    def test_float32_both_regimes(self, nu):
        # the card's dtype: finite and within 2e-5 of scipy at the float32
        # arguments in both regimes (float32 rounding through ~100
        # dependent steps, largest where the series nears x = 2: 1.05e-5
        # at nu = 0.8; the CF2 regime carries its partial sums scaled,
        # where carried apart they overflow float32 past x = 2)
        x = torch.as_tensor(X[X >= 1e-3], dtype=torch.float32)
        got = kv_frac(nu, x).double().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(
            got, scipy_kv(nu, x.double().numpy()), rtol=2e-5)


class TestMaternGeneral:
    def test_value_at_zero_is_sig(self):
        out = matern_general(torch.tensor([0.0, 1e-30], dtype=F64), 0.3, 1.7,
                             0.7)
        np.testing.assert_allclose(out.numpy()[0], 1.7, rtol=1e-12)
        assert torch.isfinite(out).all()

    @pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
    def test_matches_closed_forms(self, nu):
        locs = torch.as_tensor(gen_locations(30))
        d = dist(locs)
        closed = {0.5: tk.exponential, 1.5: tk.matern32,
                  2.5: tk.matern52}[nu](locs, l=0.4, sig=1.2)
        np.testing.assert_allclose(matern_general(d, 0.4, 1.2, nu).numpy(),
                                   closed.numpy(), rtol=1e-10, atol=1e-12)

    def test_grad_vs_finite_differences_nu07(self):
        locs = gen_locations(20)

        def f(l):
            return tk.matern(torch.as_tensor(locs), None, l=l, sig=1.3,
                             nu=0.7).sum()

        lt = torch.tensor(0.35, dtype=F64, requires_grad=True)
        f(lt).backward()
        eps = 1e-6
        fd = float((f(0.35 + eps) - f(0.35 - eps)) / (2 * eps))
        np.testing.assert_allclose(float(lt.grad), fd, rtol=1e-6)
        want = jax.grad(lambda l: jnp.sum(jk.matern(
            jnp.asarray(locs), None, l=l, sig=1.3, nu=0.7)))(0.35)
        np.testing.assert_allclose(float(lt.grad), float(want), rtol=1e-10)
        # and in sig
        st = torch.tensor(1.3, dtype=F64, requires_grad=True)
        tk.matern(torch.as_tensor(locs), None, l=0.35, sig=st,
                  nu=0.7).sum().backward()
        np.testing.assert_allclose(float(st.grad), float(f(0.35)) / 1.3,
                                   rtol=1e-12)

    def test_grad_finite_with_zero_distances(self):
        locs = torch.as_tensor(gen_locations(8))
        lt = torch.tensor(0.5, dtype=F64, requires_grad=True)
        tk.matern(locs, locs, l=lt, sig=1.0, nu=0.7).sum().backward()
        assert torch.isfinite(lt.grad)

    def test_nu_must_be_static(self):
        locs = torch.as_tensor(gen_locations(6))
        nu = torch.tensor(0.7, dtype=F64, requires_grad=True)
        with pytest.raises(TypeError, match="static"):
            tk.matern(locs, None, l=0.3, nu=nu)
        with pytest.raises(TypeError, match="static"):
            Kernel("matern", l=0.3, nu=nu)(locs)

    def test_usable_in_mra_likelihood(self):
        locs = np.asarray(gen_locations(24))
        rs = np.random.RandomState(2)
        d = np.abs(locs - locs.T)
        Sig = matern_general(torch.as_tensor(d), 0.4, 1.0, 0.7).numpy()
        y = np.linalg.cholesky(Sig + 1e-12 * np.eye(24)) @ rs.normal(size=24)
        y_obs = np.where(rs.rand(24) < 0.7, y, np.nan)
        res = MRAModel(locs, r=24, M=0, dtype=F64, device="cpu").sweep(
            Kernel("matern", l=0.4, sig=1.0, nu=0.7), y_obs, 1e-2)
        oracle = exact_gp(Sig, y_obs, 1e-2)
        np.testing.assert_allclose(float(res.objective),
                                   oracle["objective"], rtol=1e-8)
        ref = JaxMRAModel(locs, r=24, M=0).sweep(
            jk.Kernel("matern", l=0.4, sig=1.0, nu=0.7), y_obs, 1e-2)
        np.testing.assert_allclose(float(res.objective),
                                   float(ref.objective), rtol=1e-10)
        np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                                   atol=1e-10)
