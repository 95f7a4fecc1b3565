"""Leaves wider than 64 in the port, against the JAX package.

On the card such leaves leave the fused leaf kernel: both factorizations
go through the escalation cascade KC over the blocked Cholesky K8 (K4 on
64-wide diagonal blocks, K3 to invert them, matmuls between), and the
posterior inverse through the blocked ``triangular_inverse_lower``. Two
trees: bundled ``small`` at M=0 (one leaf of 100 locations, ungrouped)
and a 48x48 grid with r=4, M=2, J=4 (16 leaves of 144 under grouped
interior levels).

* float64 (plain structure) against the JAX float64 sweep and ``jax.grad``
  of its ``loglik_fn``: objective rtol 1e-10, posterior rtol 1e-8, value
  and gradient rtol 1e-8 (two float64 sweeps of the same mathematics);
* float32 kernel structure (the card's operations, here over the plain
  twins) on ``small`` against the JAX float32 sweep under
  ``PYMRA_PALLAS=force``, which takes the same cascade over
  ``cholesky_blocked``: objective rtol 1e-4, posterior atol 2e-4, value and
  gradient rtol 2e-4, as the other kernel-structure tests (the JAX side
  runs its kernels in interpret mode, ~45 s; the grid's would take twice
  that, so the grid's float32 run is held to the port's float64 sweep at
  the same jitter instead, which the first test holds to JAX, at the same
  tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, load_data
from pymra_torch.utils import gen_locations_2d

from tests.test_torch_dense_r import _count_twins, _jax_f32
from tests.test_torch_loglik import (
    _assert_value_and_grad,
    _jax_value_and_grad,
    _obs,
    _port_value_and_grad,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64


def _small():
    locs, y = load_data("small")
    return locs, y


def _grid48():
    locs = gen_locations_2d(48)
    return locs, _obs(len(locs))


#: (data, model kwargs, l, R, leaf width); l and R keep the float32
#: posterior well enough conditioned for the kernel-structure tolerances
#: (wide leaves sum more correlated locations into K_leaf + A_oo)
CONFIGS = {
    "small_m0": (_small, dict(r=4, M=0), 0.2, 0.3, 100),
    "grid48_grouped": (_grid48, dict(r=4, M=2, J=4), 0.05, 0.3, 144),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_wide_leaves_match_jax(name):
    data, kw, l, R, P = CONFIGS[name]
    locs, y = data()
    y = np.asarray(y, dtype=np.float64)
    model = MRAModel(locs, dtype=F64, device="cpu", **kw)
    assert max(lvl.leaf_locs.shape[1] for lvl in model.dplan.levels) == P
    res = model.sweep(Kernel("exponential", l=l), y, R)
    ref = JaxMRAModel(locs, dtype=jnp.float64, **kw).sweep(
        jk.Kernel("exponential", l=l), y, R)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-10)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               rtol=1e-8, atol=1e-10)
    _assert_value_and_grad(
        _port_value_and_grad(model, y, R, l, 1.3),
        _jax_value_and_grad(JaxMRAModel(locs, dtype=jnp.float64, **kw), y,
                            R, l, 1.3), rtol=1e-8)


def _float32_run(monkeypatch, name):
    """The port's float32 kernel structure on a wide tree: sweep and
    value-and-gradient, with the twins of the wide path counted."""
    data, kw, l, R, _ = CONFIGS[name]
    locs, y = data()
    calls = _count_twins(monkeypatch, [
        "leaf_factor_ref", "cholesky_cascade_ref", "cholesky_blocked_ref",
        "triangular_inverse_lower_ref", "cholesky_ref"])
    model = MRAModel(locs, dtype=torch.float32, device="cpu", **kw)
    res = model.sweep(Kernel("exponential", l=l), y, R)
    # KC over K8 (K4 blocks, K3 inverses) and the blocked inverse ran
    assert calls["leaf_factor_ref"] == 0
    assert all(calls[k] for k in ("cholesky_cascade_ref",
                                  "cholesky_blocked_ref",
                                  "triangular_inverse_lower_ref",
                                  "cholesky_ref")), calls
    return res, _port_value_and_grad(model, y, R, l, 1.0)


def _assert_sweeps_close(res, ref):
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-4)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=2e-4)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               atol=2e-4)


def test_float32_wide_leaves_match_pallas(monkeypatch):
    data, kw, l, R, _ = CONFIGS["small_m0"]
    locs, y = data()

    def jax_run():
        jm = JaxMRAModel(locs, dtype=jnp.float32, **kw)
        return (jm.sweep(jk.Kernel("exponential", l=l), y, R),
                _jax_value_and_grad(jm, y, R, l, 1.0))

    ref, want = _jax_f32(monkeypatch, jax_run)
    res, got = _float32_run(monkeypatch, "small_m0")
    _assert_sweeps_close(res, ref)
    _assert_value_and_grad(got, want, rtol=2e-4)


def test_float32_grouped_wide_leaves_match_float64(monkeypatch):
    data, kw, l, R, _ = CONFIGS["grid48_grouped"]
    locs, y = data()
    model = MRAModel(locs, dtype=F64, jitter=1e-6, device="cpu", **kw)
    ref = model.sweep(Kernel("exponential", l=l), y, R)
    want = _port_value_and_grad(model, y, R, l, 1.0)
    res, got = _float32_run(monkeypatch, "grid48_grouped")
    _assert_sweeps_close(res, ref)
    _assert_value_and_grad(got, want, rtol=2e-4)
