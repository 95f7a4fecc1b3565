"""Dense (correlated) measurement error R in the port, against the JAX
package and the exact dense GP.

* the three configurations of ``tests/test_dense_r.py`` in float64 (plain
  structure): port against the JAX package (objective rtol 1e-10,
  posterior atol 1e-10, two float64 sweeps of the same mathematics), and
  against that file's oracles (the exact dense GP at M=0; the leaf-blocked
  R the sweep honours otherwise) at its tolerances;
* the float32 kernel structure (the card's sequence of operations, here
  with the kernels' plain twins) against the JAX float32 sweep under
  ``PYMRA_PALLAS=force`` (Pallas in interpret mode): objective rtol 1e-4,
  posterior atol 2e-4, as the diagonal-R kernel-structure tests; the
  counters show the two-kernel leaf branch (K6, K7) ran and K1 did not;
* the gradient of ``sweep(...).loglik`` in ``l`` and ``sig`` against
  ``jax.grad`` of the JAX sweep: float64 rtol 1e-8, float32 rtol 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, MRATree, load_data
from pymra_torch.ops import linalg as tl
from pymra_torch.utils import gen_locations_2d

from tests.oracles import exact_gp
from tests.test_dense_r import _data
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.test_torch_loglik import _clustered, _obs
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64

#: the configurations of tests/test_dense_r.py: (n, seed, model kwargs)
F64_CONFIGS = {
    "m0_exact": (24, 0, dict(r=24, M=0)),
    "diagonal_as_dense": (60, 3, dict(r=2, M=3, J=3)),
    "leaf_blocked_screening": (40, 7, dict(r=2, M=2, J=3)),
}


def _correlated_r(locs, scale, rho):
    d = np.sqrt(((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1))
    return scale * np.exp(-d / rho)


@pytest.mark.parametrize("name", sorted(F64_CONFIGS))
def test_float64_dense_r_matches_jax_and_oracles(name):
    n, seed, kw = F64_CONFIGS[name]
    locs, Sig, R, y = _data(n, seed)
    if name == "diagonal_as_dense":
        R = np.diag(np.full(n, 2.5e-2))
    model = MRAModel(locs, dtype=F64, device="cpu", **kw)
    res = model.sweep(Kernel("exponential", l=0.4), y, R)
    ref = JaxMRAModel(locs, dtype=jnp.float64, **kw).sweep(
        jk.Kernel("exponential", l=0.4), y, R)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-10)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=1e-10)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               atol=1e-10)
    if name == "m0_exact":
        oracle = exact_gp(Sig, y, R)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-9)
        np.testing.assert_allclose(
            np.sqrt(np.maximum(res.var.numpy(), 0)), oracle["sd"],
            atol=1e-9)
    elif name == "diagonal_as_dense":
        diag = model.sweep(Kernel("exponential", l=0.4), y,
                           np.diag(R).copy())
        for a, b in zip(res, diag):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10)
    else:
        R_blocked = np.zeros_like(R)
        for g in model.plan.levels:
            for leaf in range(g.leaf_loc_gidx.shape[0]):
                ix = g.leaf_loc_gidx[leaf][g.leaf_loc_mask[leaf]]
                R_blocked[np.ix_(ix, ix)] = R[np.ix_(ix, ix)]
        oracle = exact_gp(Sig, y, R_blocked)
        np.testing.assert_allclose(float(res.objective), oracle["objective"],
                                   rtol=1e-8)
        np.testing.assert_allclose(res.mean.numpy(), oracle["mean"],
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# float32 kernel structure against the JAX Pallas path
# ---------------------------------------------------------------------------

F32_CONFIGS = {
    # 16 grouped leaves of P = 64: the two-kernel branch, messages
    # summed per parent by reshape
    "grid32_two_kernel": (lambda: gen_locations_2d(32),
                          dict(r=4, M=2, J=4), 0.05, 0.1),
    # leaves of P = 5 (K6 prior, K2 posterior, solves) and P = 23 (K6, K7)
    "clustered_mixed": (_clustered, dict(r=4, M=3), 0.1, 0.1),
}


def _jax_f32(monkeypatch, fn):
    from pymra_tpu.ops.pallas import linalg as jl

    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        return fn()
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()


def _count_twins(monkeypatch, names):
    calls = dict.fromkeys(names, 0)

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    for twin in calls:
        monkeypatch.setattr(tl, twin, counted(twin, getattr(tl, twin)))
    return calls


@pytest.mark.parametrize("name", sorted(F32_CONFIGS))
def test_float32_kernel_structure_dense_r_matches_pallas(name, monkeypatch):
    make_locs, kw, l, scale = F32_CONFIGS[name]
    locs = make_locs()
    y = _obs(len(locs))
    R = _correlated_r(locs, scale, 0.05)
    ref = _jax_f32(monkeypatch, lambda: JaxMRAModel(
        locs, dtype=jnp.float32, **kw).sweep(jk.Kernel("exponential", l=l),
                                              y, R))
    calls = _count_twins(monkeypatch, [
        "leaf_factor_ref", "cholesky_logdet_ref", "cholesky_inv_logdet_ref",
        "cholesky_jittered_ref", "solve_triangular_batched_ref"])
    res = MRAModel(locs, dtype=torch.float32, device="cpu", **kw).sweep(
        Kernel("exponential", l=l), y, R)
    # the two-kernel branch ran, the fused leaf kernel did not
    assert calls["leaf_factor_ref"] == 0
    assert calls["cholesky_logdet_ref"] and calls["cholesky_inv_logdet_ref"]
    assert calls["cholesky_jittered_ref"]  # the R blocks' factors
    assert calls["solve_triangular_batched_ref"]  # K5 whitens y
    assert res.objective.dtype == torch.float32
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-4)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=2e-4)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# gradient of sweep(...).loglik against jax.grad
# ---------------------------------------------------------------------------

def _port_grad(model, y, R, l, sig):
    th = {k: torch.tensor(v, dtype=F64, requires_grad=True)
          for k, v in (("l", l), ("sig", sig))}
    res = model.sweep(Kernel("exponential", l=th["l"], sig=th["sig"]), y, R,
                      compute_posterior=False)
    res.loglik.backward()
    return float(res.loglik.detach()), {k: float(t.grad)
                                        for k, t in th.items()}


def _jax_grad(model, y, R, l, sig):
    def f(th):
        return model.sweep(jk.Kernel("exponential", l=th["l"],
                                     sig=th["sig"]), y, R,
                           compute_posterior=False).loglik

    dt = model.dtype
    v, g = jax.value_and_grad(f)({"l": jnp.asarray(l, dt),
                                  "sig": jnp.asarray(sig, dt)})
    return float(v), {k: float(x) for k, x in g.items()}


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for k in ("l", "sig"):
        assert np.isfinite(got[1][k])
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol,
                                   err_msg=k)


def test_float64_dense_r_gradient_matches_jax():
    locs, _, R, y = _data(40, 7)
    kw = dict(r=2, M=2, J=3)
    got = _port_grad(MRAModel(locs, dtype=F64, device="cpu", **kw), y, R,
                     0.4, 1.3)
    want = _jax_grad(JaxMRAModel(locs, dtype=jnp.float64, **kw), y, R, 0.4,
                     1.3)
    _assert_close(got, want, rtol=1e-8)


def test_float32_dense_r_gradient_matches_pallas(monkeypatch):
    make_locs, kw, l, scale = F32_CONFIGS["clustered_mixed"]
    locs = make_locs()
    y = _obs(len(locs))
    R = _correlated_r(locs, scale, 0.05)
    want = _jax_f32(monkeypatch, lambda: _jax_grad(
        JaxMRAModel(locs, dtype=jnp.float32, **kw), y, R, l, 1.0))
    calls = _count_twins(monkeypatch, ["cholesky_ref",
                                       "triangular_inverse_lower_ref"])
    got = _port_grad(MRAModel(locs, dtype=torch.float32, device="cpu", **kw),
                     y, R, l, 1.0)
    # K6's backward refactors the prior at its selected factor (K4, K3)
    assert calls["cholesky_ref"] and calls["triangular_inverse_lower_ref"]
    _assert_close(got, want, rtol=2e-4)


# ---------------------------------------------------------------------------
# the model API
# ---------------------------------------------------------------------------

def test_model_takes_dense_r_as_array_or_tensor():
    y, locs, y_obs = load_data("small", include_truth=True)
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    R = 1e-2 * np.exp(-d / 0.1)
    model = MRAModel(locs, r=4, dtype=F64, device="cpu")
    kern = Kernel("exponential", l=2.0)
    base = model.sweep(kern, y_obs, R)
    for other in (model.sweep(kern, y_obs, torch.as_tensor(R)),
                  model.sweep(kern, y_obs, torch.as_tensor(R,
                                                           dtype=torch.float32))):
        np.testing.assert_allclose(float(other.objective),
                                   float(base.objective), rtol=1e-7)
    assert float(model.objective(kern, y_obs, R)) == float(base.objective)
    assert float(model.loglik(kern, y_obs, R)) == float(base.loglik)
    mean, sd = model.posterior(kern, y_obs, R)
    np.testing.assert_array_equal(mean.numpy(), base.mean.numpy())
    tree = MRATree(locs, 4, kern, y_obs, R, dtype=F64, device="cpu")
    assert tree.getLikelihood() == float(base.objective)
    # the diagonal of R through the dense path is the diagonal path
    diag = model.sweep(kern, y_obs, np.diag(np.diag(R)))
    np.testing.assert_allclose(
        float(diag.objective),
        float(model.sweep(kern, y_obs, np.diag(R).copy()).objective),
        rtol=1e-10)
    with pytest.raises(NotImplementedError, match="dense R"):
        model.loglik_fn(y_obs, R)
    with pytest.raises(ValueError, match="r_dense"):
        model.sweep(kern, y_obs, R[:50, :50])
