"""Dense covariance matrices (``MatrixKernel``, index-mode plans,
``MRATree.setPrior``) and the general-nu Matern in the port, against the
JAX package: the cases of ``tests/test_matrix_cov.py``.

* float64 on the CPU (the plain structure) against the JAX package's
  float64 CPU path on the same data: objectives rtol 1e-10 and posteriors
  atol 1e-10 (two float64 sweeps of the same mathematics), kernels rtol
  1e-12 and atol 1e-15 (as ``tests/test_torch_kernels.py``);
* ``MatrixKernel``'s gradient in the matrix, through the whole sweep,
  against ``jax.grad`` of the JAX sweep: rtol 1e-8, atol 1e-10 (the
  gradient is a float64 sum over every block that gathers an entry);
* the index-mode plan against the JAX package's, array for array.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_tpu.tree.model import MRATree as JaxMRATree
from pymra_torch import Kernel, MatrixKernel, MRAModel, MRATree
from pymra_torch import kernels as tk
from pymra_torch.convert import device_plan_from_numpy
from pymra_torch.tree.sweep import mra_sweep
from pymra_torch.utils import gen_locations

from tests.test_matrix_cov import _setup
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64
RTOL, ATOL = 1e-12, 1e-15


def _sigma(locs):
    return Kernel("exponential", l=0.3)(torch.as_tensor(locs)).numpy()


def _trees(cov_port, cov_jax, locs, y):
    tree = MRATree(locs, 2, cov_port, y, 1e-2, M=2, J=3, dtype=F64,
                   device="cpu")
    ref = JaxMRATree(locs, 2, cov_jax, y, 1e-2, M=2, J=3)
    return tree, ref


class TestMatrixCovariance:
    def test_matrix_equals_callable(self):
        locs, _, y = _setup()
        sigma = _sigma(locs)
        tree_fn = MRATree(locs, 2, Kernel("exponential", l=0.3), y, 1e-2,
                          M=2, J=3, dtype=F64, device="cpu")
        tree_mat, ref = _trees(sigma, sigma, locs, y)
        assert tree_mat.model.index_mode
        assert isinstance(tree_mat.cov, MatrixKernel)
        np.testing.assert_allclose(tree_mat.getLikelihood(),
                                   tree_fn.getLikelihood(), rtol=1e-10)
        np.testing.assert_allclose(tree_mat.getLikelihood(),
                                   ref.getLikelihood(), rtol=1e-10)
        for got, fn, want in zip(tree_mat.predict(), tree_fn.predict(),
                                 ref.predict()):
            np.testing.assert_allclose(got, fn, atol=1e-10)
            np.testing.assert_allclose(got, want, atol=1e-10)

    def test_matrix_kernel_gather(self):
        mat = np.arange(36.0).reshape(6, 6)
        mk = MatrixKernel(mat)
        xi = torch.tensor([[1], [3]])
        yi = torch.tensor([[0], [2], [5]])
        got = mk(xi, yi).numpy()
        np.testing.assert_array_equal(got, mat[np.ix_([1, 3], [0, 2, 5])])
        want = np.asarray(jk.MatrixKernel(mat)(np.array([[1.0], [3.0]]),
                                               np.array([[0.0], [2.0],
                                                         [5.0]])))
        np.testing.assert_array_equal(got, want)
        # batched points, and one argument for both sides
        pts = torch.tensor([[[0], [4]], [[5], [1]]])
        np.testing.assert_array_equal(
            mk(pts).numpy(), np.asarray(jk.MatrixKernel(mat)(
                pts.numpy().astype(np.float64))))
        assert isinstance(mk, torch.nn.Module) and "matrix" in dict(
            mk.named_buffers())

    def test_set_prior(self):
        locs, _, y = _setup()
        kern = Kernel("exponential", l=0.3)
        tree = MRATree(locs, 2, kern, y, 1e-2, M=2, J=3, dtype=F64,
                       device="cpu")
        ref = JaxMRATree(locs, 2, jk.Kernel("exponential", l=0.3), y, 1e-2,
                         M=2, J=3)
        before = tree.getLikelihood()
        plan = tree.model.plan
        scaled = 2.0 * _sigma(locs)
        tree.setPrior(None, scaled)
        ref.setPrior(None, scaled)
        assert tree.model.index_mode and tree.model.plan is plan
        after = tree.getLikelihood()
        assert after != pytest.approx(before)
        np.testing.assert_allclose(after, ref.getLikelihood(), rtol=1e-10)
        direct = MRATree(locs, 2, scaled, y, 1e-2, M=2, J=3, dtype=F64,
                         device="cpu")
        np.testing.assert_allclose(after, direct.getLikelihood(), rtol=1e-10)

    def test_index_mode_plan_matches_jax(self):
        locs, _, _ = _setup()
        model = MRAModel(locs, r=2, M=2, J=3, dtype=F64, device="cpu",
                         index_mode=True)
        jd = JaxMRAModel(locs, r=2, M=2, J=3, index_mode=True).dplan
        # the JAX plan holds the indices in its float dtype (its
        # MatrixKernel casts them back), and its make_device_plan does not
        # set its own index_points flag; the port keeps them long
        assert model.dplan.index_points and model.dplan.dtype == F64
        for lvl, jlvl in zip(model.dplan.levels, jd.levels):
            for name in ("int_knots", "leaf_locs"):
                got = getattr(lvl, name)
                assert got.dtype == torch.long
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(getattr(jlvl, name)))
        # the same plan carried across from the JAX package stays long
        dplan = device_plan_from_numpy(
            [{k: np.asarray(v) for k, v in lvl._asdict().items()}
             for lvl in jd.levels], jd.n_locs, jd.r, jd.M, jd.groups,
            np.asarray(jd.post_inv), jd.iota_groups, dtype=F64,
            device="cpu", index_points=True)
        assert dplan.levels[-1].leaf_locs.dtype == torch.long

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_matrix_gradient_matches_jax_grad(self, dtype):
        # the gradient of the loglik in the matrix itself, through every
        # gathered block of the sweep; float32 (the kernel structure on the
        # twins) against the float64 JAX gradient at the kernel-structure
        # tests' tolerance
        locs = gen_locations(24)
        sigma = _sigma(locs)
        rng = np.random.default_rng(4)
        y = rng.standard_normal(24)
        y[rng.random(24) < 0.3] = np.nan
        tdt = getattr(torch, dtype)
        model = MRAModel(locs, r=2, M=1, J=3, dtype=tdt, device="cpu",
                         index_mode=True)
        mat = torch.tensor(sigma, dtype=tdt, requires_grad=True)
        res = mra_sweep(model.dplan, MatrixKernel(mat), y, 1e-2,
                        compute_posterior=False, jitter=model.jitter)
        res.loglik.backward()
        jmodel = JaxMRAModel(locs, r=2, M=1, J=3, index_mode=True)

        def loglik(m):
            return jmodel.sweep(jk.MatrixKernel(m), y, 1e-2,
                                compute_posterior=False).loglik

        want = np.asarray(jax.grad(loglik)(jnp.asarray(sigma)))
        got = mat.grad.double().numpy()
        assert np.abs(want).max() > 0
        if dtype == "float64":
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4,
                                       atol=2e-4 * np.abs(want).max())


class TestArbitraryNuMatern:
    def test_matches_closed_forms(self):
        locs = torch.as_tensor(gen_locations(12))
        for nu, name in [(0.5, "exponential"), (1.5, "matern32"),
                         (2.5, "matern52")]:
            got = tk.matern(locs, l=0.4, nu=nu).numpy()
            want = tk.get_kernel(name)(locs, l=0.4).numpy()
            np.testing.assert_allclose(got, want, atol=1e-10)

    def test_general_nu_host_matches_sklearn(self):
        locs = gen_locations(10)
        k = tk.matern(torch.as_tensor(locs), l=0.4, nu=0.8).numpy()
        np.testing.assert_allclose(np.diag(k), 1.0, atol=1e-10)
        assert np.linalg.eigvalsh(k).min() > -1e-10
        want = np.asarray(jk.matern(jnp.asarray(locs), l=0.4, nu=0.8))
        np.testing.assert_allclose(k, want, rtol=RTOL, atol=ATOL)
        sk = pytest.importorskip("sklearn.gaussian_process.kernels")
        np.testing.assert_allclose(
            k, sk.Matern(nu=0.8, length_scale=0.4)(locs), atol=1e-9)

    def test_traced_general_nu_jits(self):
        # a tensor length scale (what a gradient path hands the kernel)
        # gives the values of a Python one
        locs = torch.as_tensor(gen_locations(5))
        got = tk.matern(locs, l=torch.tensor(0.4, dtype=F64), nu=0.8)
        want = tk.matern(locs, l=0.4, nu=0.8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10)

    def test_traced_general_nu_grad(self):
        locs = gen_locations(6)

        def f(l):
            return tk.matern(torch.as_tensor(locs), l=l, nu=0.7).sum()

        lt = torch.tensor(0.37, dtype=F64, requires_grad=True)
        f(lt).backward()
        eps = 1e-6
        fd = (f(0.37 + eps) - f(0.37 - eps)) / (2 * eps)
        np.testing.assert_allclose(float(lt.grad), float(fd), rtol=1e-4)
        want = jax.grad(lambda l: jnp.sum(jk.matern(
            jnp.asarray(locs), l=l, nu=0.7)))(0.37)
        np.testing.assert_allclose(float(lt.grad), float(want), rtol=1e-10)
