"""The posterior, a dense R and ``keep_internals`` under a batch of
parameter sets (a ``Kernel`` with ``[C]`` hyper-parameters), against C
single sweeps of the port and against ``jax.vmap`` of the JAX package's
``mra_sweep`` (the sharded batch runs in ``tests/test_torch_sharded.py``'s
gloo worlds).

* Batched against three single port sweeps, C = 3, on
  ``tests/test_torch_batched.py``'s tiny trees (leaves of 8 and 18; 81 for
  the posterior): float64 (the plain structure) every output within rtol
  1e-12; float32 (the kernel structure on the twins) loglik and objective
  within 1e-6, the gradient within 2e-4 (that file's ``RTOL``), mean, var
  and every stash within 1e-6 of their largest magnitude.
* Against ``jax.jit(jax.vmap(...))`` of the JAX package's sweep in
  float64: loglik, its gradient, mean and var within rtol 1e-9 (absolute
  1e-9 of the largest magnitude for the moments); for ``keep_internals``
  every stash, the JAX package's broadcast ``chain_Q`` and ``grp``
  included.
* One batched sweep calls each kernel wrapper (here its twin) as often as
  one single sweep, in the same order, on three times the members; under a
  dense R, R's blocks (K2) and ``y``'s whitening (K5) run once on the
  single sweep's members, and the basis is whitened in one solve with the
  sets as columns.
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
from pymra_torch.tree.sweep import mra_sweep

from tests.test_torch_batched import RTOL, THETA, TREES, _data
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
C = len(THETA["l"])
#: the batched paths and the trees each runs on
PATHS = {"posterior": ("p8", "p18", "p81"), "dense": ("p8", "p18"),
         "keep": ("p8", "p18")}
#: float32 mean, var and stashes against the single sweeps, relative to
#: their largest magnitude
F32_MOMENT_RTOL = 1e-6


def _dense_r(locs):
    """A correlated measurement error: ``R exp(-d / rho)``, ``rho`` one
    grid spacing."""
    d = np.sqrt(((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1))
    rho = np.min(d[d > 0])
    return 0.1 * np.exp(-d / rho)


def _case(tree, path, dtype=F64):
    side, kw, _ = TREES[tree]
    locs, y = _data(side)
    model = MRAModel(locs, dtype=dtype, device="cpu", **kw)
    R = _dense_r(locs) if path == "dense" else 0.1
    return model, locs, y, R, kw


def _run(model, y, R, path, values):
    """The sweep of ``path`` at ``values`` (``{l, sig}``, floats or lists):
    ``(result, stashes or None, gradient of the summed loglik)``."""
    th = {k: torch.tensor(v, dtype=F64, requires_grad=True)
          for k, v in values.items()}
    dense = np.ndim(R) == 2
    out = mra_sweep(model.dplan, Kernel("exponential", l=th["l"],
                                        sig=th["sig"]),
                    y, None if dense else R, jitter=model.jitter,
                    r_dense=R if dense else None,
                    keep_internals=path == "keep")
    res, stash = out if path == "keep" else (out, None)
    res.loglik.sum().backward()
    return res, stash, {k: t.grad for k, t in th.items()}


def _one(c):
    return {k: v[c] for k, v in THETA.items()}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    assert float(np.max(np.abs(got - want), initial=0.0)) <= rtol * scale, (
        what, float(np.max(np.abs(got - want), initial=0.0)) / scale)


def _stashes(tree, prefix=""):
    """``{path: leaf}`` of a stash tree (tensors, arrays, ints)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_stashes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_stashes(v, f"{prefix}/{i}"))
        return out
    return {} if tree is None else {prefix: tree}


def _np(x):
    return (x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("path,tree", [(p, t) for p, ts in PATHS.items()
                                       for t in ts])
def test_batched_paths_match_single_sweeps(path, tree, dtype):
    model, _, y, R, _ = _case(tree, path, dtype)
    res, stash, grad = _run(model, y, R, path, THETA)
    n = model.dplan.n_locs
    assert res.loglik.shape == (C,) and res.mean.shape == (C, n)
    value_rtol, grad_rtol = RTOL[dtype]
    moment_rtol = 1e-12 if dtype == F64 else F32_MOMENT_RTOL
    for c in range(C):
        one, one_stash, one_grad = _run(model, y, R, path, _one(c))
        for k in ("loglik", "objective"):
            np.testing.assert_allclose(float(getattr(res, k)[c].detach()),
                                       float(getattr(one, k).detach()),
                                       rtol=value_rtol, err_msg=k)
        for k in THETA:
            np.testing.assert_allclose(float(grad[k][c]), float(one_grad[k]),
                                       rtol=grad_rtol, err_msg=k)
        for k in ("mean", "var"):
            _close(_np(getattr(res, k)[c]), _np(getattr(one, k)),
                   moment_rtol, f"set {c} {k}")
        if stash is None:
            continue
        got, want = _stashes(stash), _stashes(one_stash)
        assert set(got) == set(want)
        for key, w in want.items():
            if isinstance(w, int):
                assert got[key] == w, key
            else:
                # every stash has the [C] axis in front
                assert got[key].shape == (C,) + w.shape, key
                _close(_np(got[key][c]), _np(w), moment_rtol,
                       f"set {c} {key}")


def _jax_vmap(tree, path):
    """``jax.vmap`` of the JAX package's float64 sweep of ``path`` over the
    sets: ``(loglik, gradient, mean, var)``, or ``(result, stashes)`` for
    ``keep_internals``; one ``jax.jit`` each."""
    model, locs, y, R, kw = _case(tree, path)
    dplan = JaxMRAModel(locs, **kw).dplan
    dense = np.ndim(R) == 2

    def sweep(th, **extra):
        return jax_sweep(dplan, jk.Kernel("exponential", l=th["l"],
                                          sig=th["sig"]),
                         y, 1.0 if dense else R,  # r_diag: ignored
                         r_dense=jnp.asarray(R) if dense else None, **extra)

    sets = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in THETA.items()}
    if path == "keep":
        return model, y, R, jax.jit(jax.vmap(
            lambda th: sweep(th, keep_internals=True)))(sets)

    def loglik(th):
        res = sweep(th)
        return res.loglik, (res.mean, res.var)

    (value, (mean, var)), grad = jax.jit(jax.vmap(
        jax.value_and_grad(loglik, has_aux=True)))(sets)
    return model, y, R, (value, grad, mean, var)


@pytest.mark.parametrize("path,tree", [("posterior", "p81"),
                                       ("dense", "p18"), ("keep", "p8")])
def test_batched_paths_match_jax_vmap(path, tree):
    model, y, R, want = _jax_vmap(tree, path)
    res, stash, grad = _run(model, y, R, path, THETA)
    if path == "keep":
        want_res, want_stash = want
        for k in ("loglik", "mean", "var"):
            _close(_np(getattr(res, k)), _np(getattr(want_res, k)), 1e-9, k)
        got, ref = _stashes(stash), _stashes(want_stash)
        assert set(got) == set(ref)
        for key, w in ref.items():
            g = got[key]
            if isinstance(g, int):
                # the JAX package's group count comes back broadcast
                assert np.array_equal(np.asarray(w), np.full(C, g)), key
            else:
                _close(_np(g), _np(w), 1e-9, key)
        return
    value, jgrad, mean, var = want
    np.testing.assert_allclose(_np(res.loglik), _np(value), rtol=1e-9)
    for k in THETA:
        np.testing.assert_allclose(_np(grad[k]), _np(jgrad[k]), rtol=1e-9)
    _close(_np(res.mean), _np(mean), 1e-9, "mean")
    _close(_np(res.var), _np(var), 1e-9, "var")


def _record_twins(monkeypatch):
    """Every twin call (the wrappers' CPU branch) in order: ``(name,
    members, columns)``."""
    calls = []
    for name in ("cholesky_ref", "triangular_inverse_lower_ref",
                 "solve_triangular_batched_ref", "cholesky_pullback_ref",
                 "cholesky_jittered_ref", "leaf_factor_ref",
                 "cholesky_logdet_ref", "cholesky_inv_logdet_ref",
                 "cholesky_blocked_ref", "cholesky_cascade_ref"):
        real = getattr(tl, name)

        def record(first, *a, _real=real, _name=name, **k):
            members = first.numel() // (first.shape[-1] * first.shape[-2])
            cols = a[0].shape[-1] if _name.startswith("solve") else None
            calls.append((_name, members, cols))
            return _real(first, *a, **k)

        monkeypatch.setattr(tl, name, record)
    return calls


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batched_paths_call_each_kernel_as_one_sweep(path, monkeypatch):
    # float32, the kernel structure: the value and gradient of one batched
    # sweep against one single sweep's, twin call by twin call
    model, _, y, R, _ = _case("p18", path, torch.float32)
    calls = _record_twins(monkeypatch)
    _run(model, y, R, path, _one(1))
    single = list(calls)
    calls.clear()
    _run(model, y, R, path, THETA)
    assert single and [c[0] for c in calls] == [c[0] for c in single]
    shared = []
    for (name, members, cols), (_, members_1, cols_1) in zip(calls, single):
        if members == C * members_1:
            continue
        # what the sets share: the dense R's blocks and y's whitening, and
        # the basis whitening with the sets as columns of one solve
        assert members == members_1 and path == "dense", name
        shared.append((name, cols, cols_1))
    if path != "dense":
        return
    levels = sum(1 for lvl in model.dplan.levels if lvl.leaf_locs.shape[0])
    factors = [s for s in shared if s[0] == "cholesky_jittered_ref"]
    solves = [s for s in shared if s[0] == "solve_triangular_batched_ref"]
    y_solves = [s for s in solves if s[1] == s[2] == 1]
    basis = [s for s in solves if s[1] == C * s[2] > C]
    assert len(factors) == len(y_solves) == levels
    assert basis and len(shared) == len(factors) + len(y_solves) + len(basis)
