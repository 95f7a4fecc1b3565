"""The port's value-and-gradient path (``MRAModel.loglik_fn``) against the
JAX package's ``jax.grad`` of its ``loglik_fn``, and the JAX package's
differentiability tests, ported.

* float64 (plain structure) on README_1D, the bundled small data and the
  several-leaf-level configurations of ``test_torch_sweep.py``, with the
  exponential kernel's ``l`` and ``sig`` as parameters: value and
  gradient at rtol 1e-8 (two float64 sweeps of the same mathematics, the
  gradients through different but exact pullbacks);
* (``test_torch_loglik_f32.py``: the float32 kernel structure against
  the JAX package's float32 Pallas path);
* ``TestDifferentiability``, ``TestCholCascade`` and
  ``test_loglik_fn_uses_prep_and_matches`` of ``test_sweep_exactness.py``
  with the port's functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, load_data
from pymra_torch.tree import sweep as tsweep
from pymra_torch.utils import gen_locations

from tests.test_golden_anchors import _readme_1d_data
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64


def _clustered():
    return np.random.default_rng(1).random((300, 2)) ** 3


def _obs(n, seed=5, keep=0.85):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n).astype(np.float32)
    y[rng.random(n) > keep] = np.nan
    return y


def _grf(locs, l, me, frac, seed):
    """A draw of the exponential GP at ``locs`` plus noise of variance
    ``me``, a fraction ``frac`` observed (NaN elsewhere); numpy only."""
    rng = np.random.default_rng(seed)
    locs = np.asarray(locs, dtype=np.float64).reshape(len(locs), -1)
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    x = np.linalg.cholesky(np.exp(-d / l) + 1e-10 * np.eye(len(locs))) \
        @ rng.standard_normal(len(locs))
    y = x + np.sqrt(me) * rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > frac] = np.nan
    return y


def _theta(l, sig):
    return {"l": torch.tensor(l, dtype=F64, requires_grad=True),
            "sig": torch.tensor(sig, dtype=F64, requires_grad=True)}


def _port_value_and_grad(model, y, R, l, sig):
    f = model.loglik_fn(y, R, kernel_builder=lambda th: Kernel(
        "exponential", l=th["l"], sig=th["sig"]))
    th = _theta(l, sig)
    v = f(th)
    v.backward()
    return float(v.detach()), {k: float(t.grad) for k, t in th.items()}


def _jax_value_and_grad(model, y, R, l, sig):
    f = model.loglik_fn(y, R, kernel_builder=lambda th: jk.Kernel(
        "exponential", l=th["l"], sig=th["sig"]))
    dt = model.dtype
    v, g = jax.value_and_grad(f)({"l": jnp.asarray(l, dt),
                                  "sig": jnp.asarray(sig, dt)})
    return float(v), {k: float(x) for k, x in g.items()}


def _assert_value_and_grad(got, want, rtol):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for k in ("l", "sig"):
        assert np.isfinite(got[1][k])
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the slice as a whole: loglik_fn value and gradient against jax.grad
# ---------------------------------------------------------------------------

def _f64_config(name):
    if name == "readme_1d":
        locs, y = _readme_1d_data()
        return locs, y, dict(r=2, M=3, J=3), 0.3, 1e-2, 0.0
    if name == "bundled_small":
        locs, y = load_data("small")
        return locs, y, dict(r=4), 2.0, 1e-4, 0.0
    y = _obs(100 if name == "multi_leaf_1d" else 300).astype(np.float64)
    if name == "multi_leaf_1d":
        return gen_locations(100), y, dict(r=3, J=2), 0.2, 0.05, 0.0
    # clustered_2d with jitter: the plain structure's escalation cascade
    return _clustered(), y, dict(r=4, M=3), 0.2, 0.05, 1e-6


@pytest.mark.parametrize("name", ["readme_1d", "bundled_small",
                                  "multi_leaf_1d", "clustered_2d"])
def test_float64_loglik_and_gradient_match_jax(name):
    locs, y, kw, l, R, jitter = _f64_config(name)
    got = _port_value_and_grad(
        MRAModel(locs, dtype=F64, jitter=jitter, device="cpu", **kw),
        y, R, l, 1.3)
    want = _jax_value_and_grad(
        JaxMRAModel(locs, dtype=jnp.float64, jitter=jitter, **kw),
        y, R, l, 1.3)
    _assert_value_and_grad(got, want, rtol=1e-8)


# ---------------------------------------------------------------------------
# test_sweep_exactness.py, ported
# ---------------------------------------------------------------------------

def test_grad_loglik_finite_and_correct():
    # TestDifferentiability: the Kernel itself is theta; its tensor
    # buffer receives the gradient
    locs = gen_locations(27)
    y = _grf(locs, 0.3, 1e-2, 0.6, 3)
    model = MRAModel(locs, r=2, M=2, J=3, dtype=F64, device="cpu")
    f = model.loglik_fn(y, 1e-2)
    kern = Kernel("exponential", l=torch.tensor(0.3, dtype=F64,
                                                requires_grad=True))
    f(kern).backward()
    gl = float(kern.l.grad)
    assert np.isfinite(gl)
    eps = 1e-5
    with torch.no_grad():
        fp = float(f(Kernel("exponential", l=0.3 + eps)))
        fm = float(f(Kernel("exponential", l=0.3 - eps)))
    np.testing.assert_allclose(gl, (fp - fm) / (2 * eps), rtol=1e-4)


def test_loglik_fn_uses_prep_and_matches():
    locs = gen_locations(40)
    y = _grf(locs, 1.5, 1e-3, 0.7, 3)

    def kern_b(th):
        return Kernel("exponential", l=torch.exp(th))

    model = MRAModel(locs, r=3, M=2, dtype=F64, device="cpu")
    f = model.loglik_fn(y, 1e-3, kernel_builder=kern_b)
    th = torch.tensor(0.2, dtype=F64, requires_grad=True)
    want = model.loglik(kern_b(torch.tensor(0.2, dtype=F64)), y, 1e-3)
    got = f(th)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    got.backward()
    assert np.isfinite(float(th.grad))


def _escalating_pair(t):
    good = torch.eye(3, dtype=t.dtype) * t
    # rank-1, strongly indefinite after base jitter: needs escalation
    v = torch.ones(3, dtype=t.dtype)
    bad = torch.outer(v, v) - 1e-3 * torch.eye(3, dtype=t.dtype)
    return torch.stack([good, bad])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_escalated_member_does_not_poison_healthy_grads(dtype):
    # TestCholCascade; float64 takes the plain cascade, float32 the
    # kernel structure (cholesky_jittered)
    dt = getattr(torch, dtype)
    jitter = 1e-10 if dtype == "float64" else 1e-6
    t = torch.tensor(2.0, dtype=dt, requires_grad=True)
    c = tsweep._chol(_escalating_pair(t), jitter)
    torch.log(torch.diagonal(c[0])).sum().backward()
    # d/dt sum(log diag(chol(t I))) = 1.5 / t
    np.testing.assert_allclose(float(t.grad), 1.5 / 2.0,
                               rtol=1e-6 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_escalated_member_itself_has_finite_grad(dtype):
    dt = getattr(torch, dtype)
    jitter = 1e-8 if dtype == "float64" else 1e-6
    t = torch.tensor(1.3, dtype=dt, requires_grad=True)
    v = torch.ones(3, dtype=dt) * t
    # a deficit recoverable only at the escalated jitter
    deficit = 1e-5 if dtype == "float64" else 1e-3
    bad = torch.outer(v, v) - deficit * torch.eye(3, dtype=dt)
    c = tsweep._chol(bad[None], jitter)
    val = torch.log(torch.diagonal(c[0])).sum()
    val.backward()
    assert np.isfinite(float(val)) and np.isfinite(float(t.grad))


def test_matches_plain_cholesky_when_psd():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 5, 5))
    mats = torch.tensor(a @ np.swapaxes(a, -1, -2) + 5 * np.eye(5))
    c = tsweep._chol(mats, 0.0)
    np.testing.assert_allclose(c.numpy(), np.linalg.cholesky(mats.numpy()),
                               rtol=1e-12)


def test_grad_matches_autodiff_of_plain_cholesky():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4))
    base = torch.tensor(a.T @ a + 4 * np.eye(4))

    def grad(fn):
        s = torch.tensor(1.7, dtype=F64, requires_grad=True)
        fn(s).backward()
        return float(s.grad)

    g0 = grad(lambda s: torch.sin(tsweep._chol((base * s)[None], 1e-12))
              .sum())
    g1 = grad(lambda s: torch.sin(torch.linalg.cholesky((base * s)[None]))
              .sum())
    np.testing.assert_allclose(g0, g1, rtol=1e-8)


def test_float64_parameters_drive_a_float32_sweep():
    # 0-dim float64 parameters drive a float32 sweep: the value is computed
    # in float32 (jitter 1e-6) and the gradient comes back in float64,
    # 2.0e-5 (value) and 4.3e-5 (gradients) from the float64 sweep's;
    # rtol 1e-4 and 2e-4
    locs, y = load_data("small")
    model = MRAModel(locs, r=4, dtype=torch.float32, device="cpu")
    v, g = _port_value_and_grad(model, y, 1e-2, 2.0, 1.0)
    want = _port_value_and_grad(MRAModel(locs, r=4, dtype=F64,
                                         device="cpu"), y, 1e-2, 2.0, 1.0)
    np.testing.assert_allclose(v, want[0], rtol=1e-4)
    for k in ("l", "sig"):
        np.testing.assert_allclose(g[k], want[1][k], rtol=2e-4)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU error")
    locs, y = load_data("small")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MRAModel(locs, r=4)
    from pymra_torch import MRATree
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MRATree(locs, 4, Kernel("exponential", l=2.0), y, 1e-4)
