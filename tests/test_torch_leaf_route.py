"""The leaf route of the port's sweep (``PYMRA_LEAF_SOLVE``,
``pymra_torch/utils/config.py``) against the JAX package's: the case of
``tests/test_sweep_exactness.py::TestLeafSolveStrategies`` and the kernels
each route sends the leaves through.

* float64 (the plain structure): the inverse route against the triangular
  one, objective rtol 1e-10, posterior atol 1e-9, the gradient in ``l``
  rtol 1e-8 (the JAX test's tolerances), and each route against the JAX
  package at the same tolerances;
* float32 (the kernel structure on the twins) against the JAX package
  under ``PYMRA_PALLAS=force`` (its Pallas kernels in interpret mode) and
  the same flag: objective rtol 1e-4, posterior atol 2e-4, as the port's
  other kernel-structure tests;
* which wrappers each route calls: ``auto`` and ``inv`` the fused K1,
  ``tri`` K6, K2 and K5 (P + Q <= 112) with torch's solve beyond.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_tpu.tree.sweep import mra_sweep as jax_sweep
from pymra_torch import Kernel, MRAModel
from pymra_torch.ops import linalg as tl
from pymra_torch.tree import sweep
from pymra_torch.tree.sweep import mra_sweep
from pymra_torch.utils import config, gen_locations_2d

from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64


def _case():
    """``TestLeafSolveStrategies``' tree (a 16^2 grid, r=4, M=2, J=4) with
    numpy-seeded data, 70% observed."""
    locs = gen_locations_2d(16)
    rng = np.random.default_rng(6)
    y = rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > 0.7] = np.nan
    return np.asarray(locs), y


KERN = Kernel("matern32", l=0.4, sig=1.2)


def test_inverse_solves_match_triangular(monkeypatch):
    # both routes against each other and against the JAX package's CPU
    # path (jitted once: its routes agree to 1e-10, its own test's claim)
    locs, y = _case()
    model = MRAModel(locs, r=4, M=2, J=4, dtype=F64, device="cpu")
    jmodel = JaxMRAModel(locs, r=4, M=2, J=4)
    ref = jmodel.sweep(jk.Kernel("matern32", l=0.4, sig=1.2), y, 1e-3)
    jf = jmodel.loglik_fn(y, 1e-3, kernel_builder=lambda l: jk.Kernel(
        "matern32", l=l, sig=1.2))
    want_grad = float(jax.jit(jax.grad(jf))(jnp.float64(0.4)))
    out, grads = {}, {}
    for route in ("tri", "inv"):
        monkeypatch.setenv("PYMRA_LEAF_SOLVE", route)
        out[route] = mra_sweep(model.dplan, KERN, y, 1e-3,
                               jitter=model.jitter)
        np.testing.assert_allclose(float(out[route].objective),
                                   float(ref.objective), rtol=1e-10)
        for a, b in ((out[route].mean, ref.mean), (out[route].var, ref.var)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
        lt = torch.tensor(0.4, dtype=F64, requires_grad=True)
        mra_sweep(model.dplan, Kernel("matern32", l=lt, sig=1.2), y, 1e-3,
                  compute_posterior=False).loglik.backward()
        grads[route] = float(lt.grad)
        np.testing.assert_allclose(grads[route], want_grad, rtol=1e-8)
    np.testing.assert_allclose(float(out["inv"].objective),
                               float(out["tri"].objective), rtol=1e-10)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(out["inv"], name).numpy(),
                                   getattr(out["tri"], name).numpy(),
                                   atol=1e-9)
    np.testing.assert_allclose(grads["inv"], grads["tri"], rtol=1e-8)


@pytest.mark.parametrize("route", ["tri", "inv"])
def test_float32_route_matches_pallas(route, monkeypatch):
    # 16 grouped leaves of P = 18 at the kernel-structure tests' scale
    # (exponential, R = 0.1): K6, K2 and K5 (Q = 1, 8, 18) on the
    # triangular route, the fused K1 on the inverse one
    from pymra_tpu.ops.pallas import linalg as jl

    locs = gen_locations_2d(16)
    y = np.random.default_rng(5).standard_normal(len(locs)).astype(
        np.float32)
    monkeypatch.setenv("PYMRA_LEAF_SOLVE", route)
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        jmodel = JaxMRAModel(locs, r=4, M=2, J=4, dtype=jnp.float32)
        ref = jax_sweep(jmodel.dplan, jk.Kernel("exponential", l=0.1), y,
                        0.1, jitter=jmodel.jitter)
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()
    model = MRAModel(locs, r=4, M=2, J=4, dtype=torch.float32, device="cpu")
    assert model.dplan.levels[-1].leaf_locs.shape[:2] == (16, 18)
    res = mra_sweep(model.dplan, Kernel("exponential", l=0.1), y, 0.1,
                    jitter=model.jitter)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-4)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=2e-4)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               atol=2e-4)


def _wrapper_calls(monkeypatch):
    """Count the kernel wrappers' calls as the sweep makes them (the
    names ``tree/sweep.py`` imported), with each K5 call's (P, Q)."""
    calls = {"leaf_factor": 0, "cholesky_jittered": 0, "cholesky_logdet": 0,
             "triangular_inverse_lower": 0, "solve": []}
    for name in ("leaf_factor", "cholesky_jittered", "cholesky_logdet",
                 "triangular_inverse_lower"):
        real = getattr(sweep, name)

        def count(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(sweep, name, count)
    real_solve = sweep.solve_triangular_batched

    def solve(l, b, t=False):
        calls["solve"].append((l.shape[-1], b.shape[-1]))
        return real_solve(l, b, t)

    monkeypatch.setattr(sweep, "solve_triangular_batched", solve)
    return calls


@pytest.mark.parametrize("route", ["auto", "inv", "tri"])
def test_route_chooses_the_kernels(route, monkeypatch):
    # 16 leaves of P = 64 (S = 8): the inverse routes take the fused K1,
    # the triangular one K6 (prior), K2 (posterior) and K5 where P + Q <=
    # 112 (v, g: Q = 1; Xblk, G: Q = 8), torch's solve for the posterior's
    # half (Q = P = 64)
    locs = gen_locations_2d(32)
    y = np.random.default_rng(0).standard_normal(len(locs))
    model = MRAModel(locs, r=4, M=2, J=4, dtype=torch.float32, device="cpu")
    assert model.dplan.levels[-1].leaf_locs.shape[1:] == (64, 2)
    calls = _wrapper_calls(monkeypatch)
    monkeypatch.setenv("PYMRA_LEAF_SOLVE", route)
    res = mra_sweep(model.dplan, Kernel("exponential", l=0.1), y, 0.05,
                    jitter=model.jitter)
    assert torch.isfinite(res.objective)
    if route == "tri":
        assert calls["leaf_factor"] == 0 and calls["cholesky_logdet"] == 1
        assert calls["triangular_inverse_lower"] == 0
        assert sorted(set(calls["solve"])) == [(64, 1), (64, 8)]
        assert len(calls["solve"]) == 4
    else:
        assert calls["leaf_factor"] == 1 and calls["cholesky_logdet"] == 0
        assert calls["solve"] == []


def test_keep_internals_takes_the_unfused_inverse_route(monkeypatch):
    locs = gen_locations_2d(32)
    y = np.random.default_rng(0).standard_normal(len(locs))
    model = MRAModel(locs, r=4, M=2, J=4, dtype=torch.float32, device="cpu")
    calls = _wrapper_calls(monkeypatch)
    _, internals = mra_sweep(model.dplan, Kernel("exponential", l=0.1), y,
                             0.05, jitter=model.jitter, keep_internals=True)
    leaf = internals["leaf"][-1]
    assert calls["leaf_factor"] == 0 and calls["cholesky_logdet"] == 0
    assert calls["triangular_inverse_lower"] == 1 and calls["solve"] == []
    assert leaf["L_prior"].shape == leaf["L_post"].shape == (16, 64, 64)
    assert leaf["Li"] is not None and tl.FACTORS[0] == 1.0


def test_flag_values_are_checked(monkeypatch):
    assert config.flag("PYMRA_LEAF_SOLVE") in ("auto", "inv", "tri")
    monkeypatch.setenv("PYMRA_LEAF_SOLVE", "fast")
    with pytest.raises(ValueError, match="PYMRA_LEAF_SOLVE"):
        config.flag("PYMRA_LEAF_SOLVE")
    with pytest.raises(KeyError):
        config.flag("PYMRA_NOT_A_FLAG")
    assert "PYMRA_LEAF_SOLVE" in config.describe()
