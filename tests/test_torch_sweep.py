"""The port's sweep against the JAX package's: goldens, kernel structure,
plan transfer and the no-JAX import.

* float64 (plain structure) against the frozen goldens of
  ``tests/test_golden_anchors.py``, at the same tolerances;
* float32 with jitter (the kernel structure the CUDA path runs, here with
  the kernels' plain twins) against the JAX sweep under
  ``PYMRA_PALLAS=force`` (Pallas kernels in interpret mode): objective
  rtol 1e-4, posterior mean/var atol 2e-4 — two float32 sweeps whose
  factorizations round in different places;
* the port on a JAX-built plan and kernel (``pymra_torch.convert``) equals
  the port on its own plan, bit for bit;
* ``import pymra_torch`` and a sweep work with JAX unavailable.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_tpu.tree.model import MRATree as JaxMRATree
from pymra_torch import Kernel, MRAModel, MRATree, PlanConfig, load_data
from pymra_torch.convert import device_plan_from_numpy, kernel_from_numpy
from pymra_torch.ops import linalg as tl
from pymra_torch.tree.sweep import mra_sweep, prepare_obs
from pymra_torch.utils import gen_locations, gen_locations_2d

from tests.test_golden_anchors import (
    BUNDLED_SMALL_OBJECTIVE,
    N250K_MEAN_1234,
    N250K_OBJECTIVE,
    N250K_VAR_1234,
    README_1D_OBJECTIVE,
    _readme_1d_data,
)

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clustered():
    return np.random.default_rng(1).random((300, 2)) ** 3


def _obs(n, seed=5, keep=0.85):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n).astype(np.float32)
    y[rng.random(n) > keep] = np.nan
    return y


# ---------------------------------------------------------------------------
# (a), (b): float64 goldens
# ---------------------------------------------------------------------------

def test_readme_1d_golden():
    locs, y_obs = _readme_1d_data()
    model = MRAModel(locs, r=2, M=3, J=3, dtype=F64)
    res = model.sweep(Kernel("exponential", l=0.3), y_obs, 1e-2)
    np.testing.assert_allclose(float(res.objective), README_1D_OBJECTIVE,
                               rtol=1e-9)


def test_bundled_small_golden():
    locs, y_obs = load_data("small")
    model = MRAModel(locs, r=4, dtype=F64)
    res = model.sweep(Kernel("exponential", l=2.0), y_obs, 1e-4)
    np.testing.assert_allclose(float(res.objective), BUNDLED_SMALL_OBJECTIVE,
                               rtol=1e-10)


def test_250k_golden_objective_and_posterior():
    locs = gen_locations_2d(500)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > 0.9] = np.nan
    model = MRAModel(locs, r=8, dtype=F64,
                     config=PlanConfig(r=8, kmeans_impl="native"))
    assert model.dplan.M == 7
    res = model.sweep(Kernel("exponential", l=0.05), y, 1e-2,
                      compute_posterior=True)
    np.testing.assert_allclose(float(res.objective), N250K_OBJECTIVE,
                               rtol=1e-9)
    np.testing.assert_allclose(float(res.mean[1234]), N250K_MEAN_1234,
                               rtol=1e-7)
    np.testing.assert_allclose(float(res.var[1234]), N250K_VAR_1234,
                               rtol=1e-7)


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("name", ["multi_leaf_1d", "clustered_2d"])
def test_float64_several_leaf_levels_match_jax(name, jitter):
    # leaves at two depths, P < 16, ungrouped and grouped levels: the
    # plain structure against the JAX CPU path, both float64; jitter > 0
    # takes the plain escalation cascade
    locs, kw = {"multi_leaf_1d": (gen_locations(100), dict(r=3, J=2)),
                "clustered_2d": (_clustered(), dict(r=4, M=3))}[name]
    y = _obs(len(locs)).astype(np.float64)
    res = MRAModel(locs, dtype=F64, jitter=jitter, **kw).sweep(
        Kernel("matern32", l=0.2), y, 0.05)
    ref = JaxMRAModel(locs, dtype=jnp.float64, jitter=jitter, **kw).sweep(
        jk.Kernel("matern32", l=0.2), y, 0.05)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-10)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# (c): float32 kernel structure against JAX's Pallas path
# ---------------------------------------------------------------------------

F32_CONFIGS = {
    # 16 leaves of P = 64 under grouped interior levels: leaf_factor
    "grid32_fused": (lambda: gen_locations_2d(32),
                     dict(r=4, M=2, J=4), 0.05, 0.1),
    # leaves at levels 2 (P = 5: cholesky_jittered + triangular solves)
    # and 3 (P = 23: leaf_factor)
    "clustered_mixed": (_clustered, dict(r=4, M=3), 0.1, 0.1),
}


@pytest.mark.parametrize("name", sorted(F32_CONFIGS))
def test_float32_kernel_structure_matches_pallas(name, monkeypatch):
    from pymra_tpu.ops.pallas import linalg as jl

    make_locs, kw, l, R = F32_CONFIGS[name]
    locs = make_locs()
    y = _obs(len(locs))
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        jmodel = JaxMRAModel(locs, dtype=jnp.float32, **kw)
        assert jmodel.jitter > 0
        ref = jmodel.sweep(jk.Kernel("exponential", l=l), y, R)
    finally:
        jl.pallas_available.cache_clear()

    calls = {"leaf": 0, "chol": 0}
    orig_leaf, orig_chol = tl.leaf_factor_ref, tl.cholesky_jittered_ref

    def leaf(*a, **k):
        calls["leaf"] += 1
        return orig_leaf(*a, **k)

    def chol(*a, **k):
        calls["chol"] += 1
        return orig_chol(*a, **k)

    monkeypatch.setattr(tl, "leaf_factor_ref", leaf)
    monkeypatch.setattr(tl, "cholesky_jittered_ref", chol)
    model = MRAModel(locs, dtype=torch.float32, **kw)
    assert model.jitter == 1e-6
    res = model.sweep(Kernel("exponential", l=l), y, R)
    # the CPU run went through the wrappers the card launches
    assert calls["leaf"] > 0 and calls["chol"] > 0
    assert res.objective.dtype == torch.float32
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-4)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(ref.mean),
                               atol=2e-4)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(ref.var),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# (d): plan and kernel carried across from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_on_jax_plan_equals_port_on_own_plan(dtype):
    locs = _clustered()
    y = _obs(len(locs))
    tdt = getattr(torch, dtype)
    jmodel = JaxMRAModel(locs, r=4, M=3, dtype=getattr(jnp, dtype))
    jd = jmodel.dplan
    dplan = device_plan_from_numpy(
        [{k: np.asarray(v) for k, v in lvl._asdict().items()}
         for lvl in jd.levels],
        jd.n_locs, jd.r, jd.M, jd.groups, np.asarray(jd.post_inv),
        jd.iota_groups, dtype=tdt)
    jkern = jk.Kernel("matern52", l=0.15, sig=1.3)
    kern = kernel_from_numpy(jkern.name, {k: np.asarray(v) for k, v in
                                          jkern.params.items()},
                             jkern.static)
    model = MRAModel(locs, r=4, M=3, dtype=tdt)
    got = mra_sweep(dplan, kern, y, 0.1, jitter=model.jitter)
    want = model.sweep(Kernel("matern52", l=0.15, sig=1.3), y, 0.1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# facade, hoisting, side paths
# ---------------------------------------------------------------------------

def test_mratree_facade_matches_jax():
    y, locs, y_obs = load_data("small", include_truth=True)
    tree = MRATree(locs, 4, Kernel("exponential", l=2.0), y_obs, 1e-4,
                   dtype=F64)
    ref = JaxMRATree(locs, 4, jk.Kernel("exponential", l=2.0), y_obs, 1e-4)
    np.testing.assert_allclose(tree.getLikelihood(), BUNDLED_SMALL_OBJECTIVE,
                               rtol=1e-10)
    np.testing.assert_allclose(tree.getLogLik(), ref.getLogLik(),
                               rtol=1e-10)
    mean, sd = tree.predict()
    want_mean, want_sd = ref.predict()
    assert mean.shape == (100, 1) and sd.shape == (100,)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sd, want_sd, rtol=1e-8, atol=1e-10)
    assert (tree.avgLeafSize(), tree.minLeaf(), tree.maxLeaf()) == (
        ref.avgLeafSize(), ref.minLeaf(), ref.maxLeaf())
    assert (tree.M, tree.J, tree.r) == (ref.M, ref.J, ref.r)
    # the unobserved locations are predicted too
    assert np.isnan(y_obs).any() and np.all(np.isfinite(mean))
    assert np.all(sd > 0)


def test_model_defaults_and_hoisted_prep():
    locs, y_obs = load_data("small")
    m32 = MRAModel(locs, r=4, dtype=torch.float32)
    assert m32.jitter == 1e-6 and MRAModel(locs, r=4, dtype=F64).jitter == 0
    kern = Kernel("exponential", l=2.0)
    base = m32.sweep(kern, y_obs, 1e-4)
    prep = prepare_obs(m32.dplan, y_obs, 1e-4)
    got = mra_sweep(m32.dplan, kern, None, None, jitter=m32.jitter,
                    prep=prep)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(m32.objective(kern, y_obs, 1e-4)) == float(base.objective)
    assert float(m32.loglik(kern, y_obs, 1e-4)) == float(base.loglik)
    mean, sd = m32.posterior(kern, y_obs, 1e-4)
    np.testing.assert_array_equal(mean.numpy(), base.mean.numpy())
    assert torch.all(sd >= 0) and m32.leaf_sizes().sum() > 0
    assert "TreePlan" in m32.describe()


def test_side_paths_raise():
    locs, y_obs = load_data("small")
    model = MRAModel(locs, r=4, dtype=F64)
    kern = Kernel("exponential", l=2.0)
    with pytest.raises(NotImplementedError, match="dense"):
        model.sweep(kern, y_obs, np.eye(100))
    for kw in ({"keep_internals": True}, {"axis_name": "x"},
               {"r_dense": np.eye(100)}):
        with pytest.raises(NotImplementedError):
            mra_sweep(model.dplan, kern, y_obs, 1e-4, **kw)
    with pytest.raises(NotImplementedError):
        MRATree(locs, 4, np.eye(100), y_obs, 1e-4)


# ---------------------------------------------------------------------------
# (e): no JAX needed
# ---------------------------------------------------------------------------

def test_port_imports_and_runs_without_jax():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pymra_tpu'] = None\n"
        "import torch\n"
        "import pymra_torch\n"
        "from pymra_torch import Kernel, MRAModel, load_data\n"
        "locs, y = load_data('small')\n"
        "res = MRAModel(locs, r=4, dtype=torch.float32).sweep(\n"
        "    Kernel('exponential', l=2.0), y, 1e-4)\n"
        "assert torch.isfinite(res.objective)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'pymra_tpu'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', float(res.objective))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
