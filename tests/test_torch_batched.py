"""Batches of parameter sets through one sweep of the port: a ``Kernel``
with ``[C]`` hyper-parameters, ``MRAModel.loglik_fn(..., batched=True)``
and the samplers' chains, particles and draws in lockstep (the port's
counterpart of the JAX package's ``jax.vmap``).

* The batched loglik and gradient at C = 3 against three single port
  evaluations: float64 (the plain structure) rtol 1e-12; float32 (the
  kernel structure on the twins) value rtol 1e-6, gradient 2e-4 (the
  leaves above 64 take their backward through torch's solve and
  matmuls, whose blocking follows the batch: 8.8e-5 apart at P = 81,
  where the float32 gradient is 1.2e-4 from float64); on both leaf
  routes and on trees with leaves of 8, 18 and 81 (KC's twin above 64).
* The same against ``jax.vmap(jax.value_and_grad(...))`` of the JAX
  package's ``MRAModel.loglik_fn`` with a ``kernel_builder``, rtol 1e-9
  (``tests/test_torch_grad.py``'s), on each tree, the routes alternating
  (the single evaluations hold the routes to each other).
* One batched evaluation calls each kernel wrapper as often as one single
  evaluation does, on three times the members; each wrapper given
  ``[C, n, P, P]`` equals itself given ``[C*n, P, P]``; the 32-bit guard.
* HMC, NUTS, SMC and ADVI batched against their serial runs with the same
  generators, on a Gaussian and on the tiny MRA loglik: identical tree
  depths, acceptance, divergences; draws within 1e-9.
* What a batch still refuses raises: a second batch axis, the host basis
  matrix, a ``MatrixKernel``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu import kernels as jk
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel, MRAModel, MatrixKernel
from pymra_torch.infer import advi, hmc, nuts, smc
from pymra_torch.ops import linalg as tl
from pymra_torch.tree.basis import basis_matrix
from pymra_torch.tree.sweep import mra_sweep
from pymra_torch.utils import gen_locations_2d

from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
#: grid side, model arguments and leaf width of each tree
TREES = {
    "p8": (10, dict(r=2, M=2, J=4), 8),
    "p18": (16, dict(r=4, M=2, J=4), 18),
    "p81": (18, dict(r=4, M=1, J=4), 81),
}
THETA = {"l": [0.15, 0.25, 0.4], "sig": [0.8, 1.0, 1.3]}
R = 0.1
#: (value, gradient) relative tolerances of batched against single
RTOL = {F64: (1e-12, 1e-12), torch.float32: (1e-6, 2e-4)}


def _data(side):
    locs = gen_locations_2d(side)
    y = np.random.default_rng(1).standard_normal(len(locs))
    y[::5] = np.nan
    return np.asarray(locs), y


def _builder(theta):
    return Kernel("exponential", l=theta["l"], sig=theta["sig"])


def _model(tree, dtype=F64):
    side, kw, P = TREES[tree]
    locs, y = _data(side)
    model = MRAModel(locs, dtype=dtype, device="cpu", **kw)
    assert max(lvl.leaf_locs.shape[1] for lvl in model.dplan.levels) == P
    return model, y


def _theta(values):
    return {k: torch.tensor(v, dtype=F64, requires_grad=True)
            for k, v in values.items()}


def _batched(model, y):
    """Value ``[C]`` and gradient ``{k: [C]}`` of one batched evaluation."""
    th = _theta(THETA)
    value = model.loglik_fn(y, R, kernel_builder=_builder, batched=True)(th)
    value.sum().backward()
    return value.detach().numpy(), {k: t.grad.numpy() for k, t in th.items()}


def _singles(model, y):
    f = model.loglik_fn(y, R, kernel_builder=_builder)
    values, grads = [], {k: [] for k in THETA}
    for c in range(len(THETA["l"])):
        th = _theta({k: v[c] for k, v in THETA.items()})
        value = f(th)
        value.backward()
        values.append(float(value.detach()))
        for k, t in th.items():
            grads[k].append(float(t.grad))
    return np.array(values), {k: np.array(v) for k, v in grads.items()}


def _close(got, want, rtol):
    rtol_value, rtol_grad = rtol
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_value)
    for k in THETA:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol_grad)


# ---------------------------------------------------------------------------
# the batched loglik and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["tri", "inv"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_batched_loglik_matches_single_evaluations(tree, route, dtype,
                                                   monkeypatch):
    monkeypatch.setenv("PYMRA_LEAF_SOLVE", route)
    model, y = _model(tree, dtype)
    got = _batched(model, y)
    assert got[0].shape == (3,)
    _close(got, _singles(model, y), RTOL[dtype])


@pytest.mark.parametrize("tree,route", [("p8", "tri"), ("p18", "inv"),
                                        ("p81", "tri")])
def test_batched_loglik_matches_jax_vmap(tree, route, monkeypatch):
    # the JAX package on its CPU path, the same route flag for both
    monkeypatch.setenv("PYMRA_LEAF_SOLVE", route)
    side, kw, _ = TREES[tree]
    locs, y = _data(side)
    jf = JaxMRAModel(locs, **kw).loglik_fn(
        y, R, kernel_builder=lambda th: jk.Kernel(
            "exponential", l=th["l"], sig=th["sig"]))
    values, grads = jax.jit(jax.vmap(jax.value_and_grad(jf)))(
        {k: jnp.asarray(v, dtype=jnp.float64) for k, v in THETA.items()})
    want = (np.asarray(values), {k: np.asarray(g) for k, g in grads.items()})
    _close(_batched(_model(tree)[0], y), want, (1e-9, 1e-9))


def _count_twins(monkeypatch):
    """Calls and members of every twin (the wrappers' CPU branch)."""
    calls = {}
    for name in ("cholesky_ref", "triangular_inverse_lower_ref",
                 "solve_triangular_batched_ref", "cholesky_pullback_ref",
                 "cholesky_jittered_ref", "leaf_factor_ref",
                 "cholesky_logdet_ref", "cholesky_inv_logdet_ref",
                 "cholesky_blocked_ref", "cholesky_cascade_ref"):
        real = getattr(tl, name)

        def count(first, *a, _real=real, _name=name, **k):
            n = first.numel() // (first.shape[-1] * first.shape[-2])
            got = calls.setdefault(_name, [0, 0])
            got[0] += 1
            got[1] += n
            return _real(first, *a, **k)

        monkeypatch.setattr(tl, name, count)
    return calls


@pytest.mark.parametrize("tree", sorted(TREES))
def test_batched_evaluation_calls_each_kernel_once_per_level(tree,
                                                             monkeypatch):
    # float32, the kernel structure: one batched value and gradient calls
    # each wrapper (here its twin) as often as one single evaluation, on
    # three times the members
    model, y = _model(tree, torch.float32)
    calls = _count_twins(monkeypatch)
    f = model.loglik_fn(y, R, kernel_builder=_builder)
    f(_theta({"l": 0.25, "sig": 1.0})).backward()
    single = {k: list(v) for k, v in calls.items()}
    calls.clear()
    _batched(model, y)
    assert single and set(calls) == set(single)
    for name, (n_calls, members) in single.items():
        assert calls[name] == [n_calls, 3 * members], name


def _spd(rng, b, p):
    a = rng.standard_normal((b, p, p))
    return (a @ np.swapaxes(a, -1, -2) / p + np.eye(p)).astype(np.float32)


def _flat_cases(rng):
    """``(wrapper, inputs with a [2, 3] batch)`` for every wrapper."""
    t = torch.tensor
    a9, a70 = _spd(rng, 6, 9), _spd(rng, 6, 70)
    l9 = np.linalg.cholesky(a9).astype(np.float32)
    jit = np.full(6, 1e-3, dtype=np.float32)
    kmask = (rng.random((3, 9)) < 0.7).astype(np.float32)
    c_own = a9 * np.tile(kmask, (2, 1))[:, :, None] * np.tile(
        kmask, (2, 1))[:, None, :]
    return {
        "cholesky": (tl.cholesky, [t(a9)]),
        "triangular_inverse_lower": (tl.triangular_inverse_lower, [t(l9)]),
        "solve_triangular_batched": (tl.solve_triangular_batched, [
            t(l9), t(rng.standard_normal((6, 9, 4)).astype(np.float32))]),
        "cholesky_jittered": (tl.cholesky_jittered, [t(a9), t(jit)]),
        "leaf_factor": (tl.leaf_factor, [t(c_own), t(kmask), t(a9 * 0.1)]),
        "cholesky_logdet": (tl.cholesky_logdet, [t(a9), t(jit)]),
        "cholesky_inv_logdet": (tl.cholesky_inv_logdet, [t(a9), t(jit)]),
        "cholesky_blocked": (tl.cholesky_blocked, [t(a70)]),
        "cholesky_cascade": (tl.cholesky_cascade, [t(a70), t(jit)]),
        "cholesky_pullback": (tl.cholesky_pullback, [
            t(l9), t(rng.standard_normal((6, 9, 9)).astype(np.float32)),
            t(rng.standard_normal(6).astype(np.float32)),
            t(np.full(6, 1e2, dtype=np.float32))]),
    }


@pytest.mark.parametrize("name", sorted(_flat_cases(np.random.default_rng(0))))
def test_wrapper_takes_a_leading_batch_as_a_flat_one(name):
    fn, inputs = _flat_cases(np.random.default_rng(7))[name]

    def shaped(x, lead):
        if name == "leaf_factor" and x.shape == (3, 9):
            # the sweep's mask: one per node, shared by the sets
            return x if lead == (2, 3) else x.repeat(2, 1)
        return x.reshape(lead + x.shape[1:])

    outs = {}
    for lead in ((2, 3), (6,)):
        args = [shaped(x, lead).clone().requires_grad_(
            x.dtype.is_floating_point and name != "cholesky_pullback"
            and not (name == "leaf_factor" and x.shape == (3, 9)))
            for x in inputs]
        extra = (1e-3,) if name == "leaf_factor" else ()
        out = fn(*args, *extra)
        out = out if isinstance(out, tuple) else (out,)
        diff = [o for o in out if o is not None and o.requires_grad]
        if diff:
            cots = [torch.ones_like(o) for o in diff]
            grads = torch.autograd.grad(diff, [a for a in args
                                               if a.requires_grad], cots)
        else:
            grads = ()
        outs[lead] = [o.detach().reshape(-1) for o in out if o is not None] \
            + [g.reshape(-1) for g in grads]
    assert len(outs[(2, 3)]) == len(outs[(6,)])
    for a, b in zip(outs[(2, 3)], outs[(6,)]):
        assert torch.equal(torch.nan_to_num(a, 7.0),
                           torch.nan_to_num(b, 7.0)), name


def test_kernels_refuse_a_batch_past_their_32_bit_indices():
    # C = 4 on the N=10^6 tree: K1, K3 and K4 on 65,536 members of 64, KP
    # on 16,384 of 8: far inside
    tl._fits_int32("leaf_factor", 65536)
    tl._fits_int32("cholesky_pullback", 16384, tl._LANES)
    with pytest.raises(ValueError, match="32-bit"):
        tl._fits_int32("cholesky", 2 ** 31 - 100)
    with pytest.raises(ValueError, match="32-bit"):
        tl._fits_int32("cholesky_pullback", 2 ** 26, tl._LANES)
    with pytest.raises(ValueError, match="32-bit"):
        tl._fits_int32("solve_triangular_batched", 2 ** 28, 8)


def test_batched_kernel_covariance_shape_and_dtype():
    x = torch.rand(5, 4, 2, dtype=torch.float32)
    k = Kernel("matern32", l=torch.tensor([0.2, 0.3], dtype=F64), sig=1.5)
    assert k.batch_shape == (2,) and Kernel("gaussian", l=0.2).batch_shape == ()
    out = k(x, x)
    assert out.shape == (2, 5, 4, 4) and out.dtype == torch.float32
    for c, l in enumerate((0.2, 0.3)):
        assert torch.equal(out[c], Kernel("matern32", l=l, sig=1.5)(x, x))
    nu = Kernel("matern", l=torch.tensor([0.2, 0.3], dtype=F64), nu=0.8)
    np.testing.assert_allclose(
        nu(x, x)[1].numpy(), Kernel("matern", l=0.3, nu=0.8)(x, x).numpy(),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the samplers in lockstep against their serial runs
# ---------------------------------------------------------------------------

PREC = torch.tensor([[1.6, -0.9], [-0.9, 2.1]], dtype=F64)


def _gaussian(theta):
    x = theta["x"]  # [2] or [k, 2]
    return -0.5 * ((x @ PREC) * x).sum(-1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_chains_equal(a, b, extra=()):
    for name in ("tree_depth", "num_divergent") + tuple(extra):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    sa, sb = a.samples, b.samples
    for k in (sa if isinstance(sa, dict) else {"x": sa}):
        got = sa[k] if isinstance(sa, dict) else sa
        want = sb[k] if isinstance(sb, dict) else sb
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(a.log_prob.numpy(), b.log_prob.numpy(),
                               rtol=1e-9)
    for name in ("accept_rate", "step_size", "inv_mass"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=1e-9)


def _init(chains, seed=3):
    return {"x": torch.randn(chains, 2, generator=_gen(seed), dtype=F64)}


def test_nuts_lockstep_matches_serial_on_a_gaussian():
    kw = dict(num_warmup=30, num_samples=20, max_depth=5)
    serial = nuts(_gaussian, _init(3), _gen(0), **kw)
    batched = nuts(_gaussian, _init(3), _gen(0), batched=True, **kw)
    _assert_chains_equal(batched, serial)
    assert len(set(serial.tree_depth.reshape(-1).tolist())) > 1


def test_hmc_lockstep_matches_serial_on_a_gaussian():
    kw = dict(num_warmup=20, num_samples=15, num_leapfrog=6)
    serial = hmc(_gaussian, _init(3), _gen(1), **kw)
    batched = hmc(_gaussian, _init(3), _gen(1), batched=True, **kw)
    np.testing.assert_allclose(batched.samples["x"].numpy(),
                               serial.samples["x"].numpy(), rtol=0, atol=1e-9)
    for name in ("log_prob", "accept_rate", "step_size", "inv_mass"):
        np.testing.assert_allclose(getattr(batched, name).numpy(),
                                   getattr(serial, name).numpy(), rtol=1e-9)


def _smc_prior(theta):
    return -0.125 * (theta["x"] ** 2).sum(-1)


def _smc_sample(g):
    return {"x": 2.0 * torch.randn(2, generator=g, dtype=F64)}


def test_smc_batched_matches_serial_on_a_gaussian():
    kw = dict(n_particles=32, n_mutations=2, max_stages=8)
    serial = smc(_gaussian, _smc_prior, _smc_sample, _gen(2), **kw)
    batched = smc(_gaussian, _smc_prior, _smc_sample, _gen(2), batched=True,
                  **kw)
    np.testing.assert_allclose(batched.particles["x"].numpy(),
                               serial.particles["x"].numpy(), atol=1e-12)
    for name in ("log_evidence", "betas", "acc_rates"):
        np.testing.assert_allclose(getattr(batched, name).numpy(),
                                   getattr(serial, name).numpy(), rtol=1e-12)


def test_advi_batched_matches_serial_on_a_gaussian():
    kw = dict(steps=25, num_mc=4)
    init = {"x": torch.tensor([0.5, -0.3], dtype=F64)}
    serial = advi(_gaussian, init, _gen(4), **kw)
    batched = advi(_gaussian, init, _gen(4), batched=True, **kw)
    np.testing.assert_allclose(batched.elbo_history.numpy(),
                               serial.elbo_history.numpy(), rtol=1e-12)
    np.testing.assert_allclose(batched.mean["x"].numpy(),
                               serial.mean["x"].numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def mra_logp():
    """The tiny MRA loglik (16 leaves of 8, float64) in log l and log sig,
    single and batched, plus a weak prior."""
    side, kw, _ = TREES["p8"]
    locs, y = _data(side)
    model = MRAModel(locs, dtype=F64, device="cpu", **kw)

    def build(theta):
        return Kernel("exponential", l=theta["log_l"].exp(),
                      sig=theta["log_sig"].exp())

    def with_prior(f):
        return lambda th: f(th) - 0.125 * (th["log_l"] ** 2
                                           + th["log_sig"] ** 2)

    return {b: with_prior(model.loglik_fn(y, R, kernel_builder=build,
                                          batched=b)) for b in (False, True)}


def _mra_init(chains):
    g = _gen(5)
    return {"log_l": -1.5 + 0.05 * torch.randn(chains, generator=g,
                                               dtype=F64),
            "log_sig": 0.05 * torch.randn(chains, generator=g, dtype=F64)}


def test_samplers_in_lockstep_on_the_mra_loglik(mra_logp):
    kw = dict(num_warmup=6, num_samples=4, max_depth=3)
    _assert_chains_equal(nuts(mra_logp[True], _mra_init(2), _gen(6),
                              batched=True, **kw),
                         nuts(mra_logp[False], _mra_init(2), _gen(6), **kw))
    kw = dict(num_warmup=4, num_samples=3, num_leapfrog=3)
    a = hmc(mra_logp[True], _mra_init(2), _gen(7), batched=True, **kw)
    b = hmc(mra_logp[False], _mra_init(2), _gen(7), **kw)
    for k in ("log_l", "log_sig"):
        np.testing.assert_allclose(a.samples[k].numpy(),
                                   b.samples[k].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.accept_rate.numpy(), b.accept_rate.numpy(),
                               rtol=1e-9)
    kw = dict(steps=3, num_mc=2)
    init = {k: v[0] for k, v in _mra_init(1).items()}
    np.testing.assert_allclose(
        advi(mra_logp[True], init, _gen(8), batched=True, **kw
             ).elbo_history.numpy(),
        advi(mra_logp[False], init, _gen(8), **kw).elbo_history.numpy(),
        rtol=1e-9)

    def sample(g):
        return {k: v + 0.05 * torch.randn((), generator=g, dtype=F64)
                for k, v in (("log_l", -1.5), ("log_sig", 0.0))}

    def prior(th):
        return -0.5 * ((th["log_l"] + 1.5) ** 2 + th["log_sig"] ** 2) / 0.05 ** 2

    kw = dict(n_particles=6, n_mutations=1, max_stages=3)
    a = smc(mra_logp[True], prior, sample, _gen(9), batched=True, **kw)
    b = smc(mra_logp[False], prior, sample, _gen(9), **kw)
    for k in ("log_l", "log_sig"):
        np.testing.assert_allclose(a.particles[k].numpy(),
                                   b.particles[k].numpy(), atol=1e-9)
    np.testing.assert_allclose(float(a.log_evidence), float(b.log_evidence),
                               rtol=1e-9)


def test_batched_samplers_refuse_a_scalar_log_prob():
    with pytest.raises(ValueError, match="batched"):
        nuts(lambda th: _gaussian(th).sum(), _init(2), _gen(0),
             num_warmup=2, num_samples=2, batched=True)
    with pytest.raises(ValueError, match="batched"):
        advi(lambda th: _gaussian(th).sum(), {"x": torch.zeros(2, dtype=F64)},
             _gen(0), steps=1, num_mc=3, batched=True)


# ---------------------------------------------------------------------------
# what a batch does not take
# ---------------------------------------------------------------------------

def test_unsupported_batched_calls_raise():
    # every path takes a batch of sets (tests/test_torch_batched_paths.py);
    # what a batch still refuses: more than one batch axis, the host basis
    # matrix, a MatrixKernel, and (tests/test_torch_sharded.py, in a gloo
    # world) keep_internals with sharded interior levels
    model, y = _model("p8")
    kern = Kernel("exponential", l=torch.tensor([0.2, 0.3], dtype=F64))

    class TwoAxes(torch.nn.Module):
        batch_shape = (2, 3)

        def forward(self, x, z=None):
            raise AssertionError("never evaluated")

    for kw in (dict(compute_posterior=True), dict(keep_internals=True)):
        with pytest.raises(ValueError, match="one batch axis"):
            mra_sweep(model.dplan, TwoAxes(), y, R, **kw)
    with pytest.raises(NotImplementedError, match="one set"):
        basis_matrix(model, kern, y=y, R=R)
    # a MatrixKernel has no hyper-parameter to batch
    n = model.dplan.n_locs
    with pytest.raises(NotImplementedError, match="MatrixKernel"):
        MatrixKernel(torch.zeros(2, n, n, dtype=F64))(
            torch.zeros(3, 1, dtype=torch.long))
    index = MRAModel(_data(TREES["p8"][0])[0], dtype=F64, device="cpu",
                     index_mode=True, **TREES["p8"][1])
    f = index.loglik_fn(y, R, kernel_builder=lambda th: MatrixKernel(
        torch.eye(n, dtype=F64) * th["sig"][0]), batched=True)
    with pytest.raises(NotImplementedError, match="MatrixKernel"):
        f({"sig": torch.ones(2, dtype=F64)})
    # batched parameters share one axis; a batch needs batched=True
    with pytest.raises(ValueError, match="one common"):
        Kernel("exponential", l=torch.ones(3), sig=torch.ones(2)).batch_shape
    with pytest.raises(ValueError, match="batched=True"):
        model.loglik_fn(y, R, kernel_builder=_builder)(_theta(THETA))
