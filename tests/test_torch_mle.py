"""``pymra_torch.fit_mle`` on the MRA likelihood (the JAX package's
``tests/test_infer.py::TestMLE``, ported) and against the JAX package's
``fit_mle`` on the same float64 problem.

The two packages' L-BFGS differ (``torch.optim.LBFGS`` with a strong-Wolfe
line search against optax's), so the tests compare optima, not paths:
the port's optimum in ``l`` within 1e-3 (relative) of the JAX optimum and
its loglik within 1e-6 (relative), both optimizers stopping on the same
rule near a smooth maximum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu import kernels as jk
from pymra_tpu.infer import fit_mle as jax_fit_mle
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, fit_mle
from pymra_torch.utils import gen_locations

from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.test_torch_loglik import _grf
from tests.torch_fixtures import jax_native_planner  # noqa: F401


def _problem():
    locs = gen_locations(60)
    return locs, _grf(locs, 0.3, 1e-2, 0.8, 0)


def _port_loglik():
    """``theta -> loglik`` of the exponential kernel, ``theta`` holding
    ``l`` and optionally ``sig``."""
    locs, y = _problem()
    model = MRAModel(locs, r=2, M=2, J=3, dtype=torch.float64, device="cpu")
    return model.loglik_fn(y, 1e-2, kernel_builder=lambda th: Kernel(
        "exponential", **th))


def test_gradient_vs_nelder_mead():
    f = _port_loglik()
    res_g = fit_mle(f, {"l": 1.0}, method="lbfgs", steps=100)
    res_nm = fit_mle(f, {"l": 1.0}, method="nelder-mead")
    # both optimizers find the same optimum of the same surface
    assert abs(res_g["theta"]["l"] - res_nm["theta"]["l"]) < 1e-2
    assert abs(res_g["loglik"] - res_nm["loglik"]) < 1e-3
    # in the right ballpark of the true range 0.3
    assert 0.1 < res_g["theta"]["l"] < 1.0
    assert res_g["converged"] and res_nm["n_evals"] > 0
    # the history is the negated loglik at the start of each step
    assert res_g["history"][0] > res_g["history"][-1]
    np.testing.assert_allclose(-res_g["history"][-1], res_g["loglik"],
                               rtol=1e-9)


def test_adam():
    f = _port_loglik()
    res = fit_mle(f, {"l": 1.0}, method="adam", steps=150,
                  learning_rate=5e-2)
    assert np.isfinite(res["loglik"])
    assert 0.05 < res["theta"]["l"] < 2.0
    assert len(res["history"]) == 150 or res["converged"]


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        fit_mle(_port_loglik(), {"l": 1.0}, method="sgd")


def test_optimum_matches_jax_fit_mle():
    locs, y = _problem()
    jf = JaxMRAModel(locs, r=2, M=2, J=3).loglik_fn(
        y, 1e-2, kernel_builder=lambda th: jk.Kernel(
            "exponential", l=th["l"], sig=th["sig"]))
    theta0 = {"l": 1.0, "sig": 1.0}
    want = jax_fit_mle(jf, theta0, method="lbfgs", steps=100)
    got = fit_mle(_port_loglik(), theta0, method="lbfgs", steps=100)
    for k in ("l", "sig"):
        np.testing.assert_allclose(got["theta"][k], want["theta"][k],
                                   rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["loglik"], want["loglik"], rtol=1e-6)

