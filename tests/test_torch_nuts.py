"""The port's NUTS (``pymra_torch.infer.nuts``) and HMC leapfrog against the
JAX package's, and ``tests/test_nuts.py``, ported.

* Pure parts against the JAX functions on the same float64 inputs: the
  U-turn criterion (same booleans), the count of trailing one-bits that
  sizes the stack pops (JAX's popcount formula), and a leapfrog trajectory
  on a correlated Gaussian (rtol 1e-12; the port carries the gradient
  between steps, JAX's ``_leapfrog`` evaluates it twice a step).
* The samplers draw from torch generators, not JAX keys, so NUTS is held
  statistically at ``tests/test_nuts.py``'s tolerances: a correlated
  Gaussian, the adaptation's calibration at targets 0.8 and 0.9, ESS on a
  badly scaled target, the MRA smoke run.
* ``steps_per_call`` is bit-identical to one call, the same generator seed
  gives bit-identical draws, and a non-finite log density counts as a
  divergence without leaving a non-finite draw.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_torch import Kernel, MRAModel
from pymra_torch.infer import ess, nuts, split_rhat
from pymra_torch.infer._flat import value_and_grad
from pymra_torch.utils import gen_locations, make_observations, simulate_grf
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
# the modules (``infer.nuts`` and ``infer.hmc`` are also functions' names)
jnuts = importlib.import_module("pymra_tpu.infer.nuts")
jhmc = importlib.import_module("pymra_tpu.infer.hmc")
tnuts = importlib.import_module("pymra_torch.infer.nuts")
thmc = importlib.import_module("pymra_torch.infer.hmc")

COV = np.array([[1.0, 0.8], [0.8, 2.0]])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _gaussian(cov=COV, mean=(0.0, 0.0)):
    prec = torch.tensor(np.linalg.inv(cov), dtype=F64)
    mean = torch.tensor(mean, dtype=F64)

    def logp(theta):
        d = theta["x"] - mean
        return -0.5 * d @ prec @ d

    return logp


# ---------------------------------------------------------------------------
# pure parts against the JAX functions
# ---------------------------------------------------------------------------

def test_uturn_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        q0, v0, q1, v1 = rng.standard_normal((4, 3))
        want = bool(jnuts._uturn(*map(jnp.asarray, (q0, v0, q1, v1))))
        got = tnuts._uturn(*(torch.tensor(a, dtype=F64)
                             for a in (q0, v0, q1, v1)))
        assert got == want


def test_trailing_ones_match_jax_popcount():
    n = np.arange(1024, dtype=np.uint32)
    want = np.asarray(jax.lax.population_count(((n + 1) & ~n) - 1))
    assert [tnuts._trailing_ones(int(i)) for i in n] == want.tolist()


def test_leapfrog_trajectory_matches_jax():
    prec = np.linalg.inv(COV)
    x0, p0 = np.array([0.3, -1.2]), np.array([1.1, 0.4])
    inv_mass = np.array([0.7, 1.9])
    x_j, p_j = jhmc._leapfrog(jax.grad(lambda x: -0.5 * x @ prec @ x),
                              jnp.asarray(x0), jnp.asarray(p0), 0.13,
                              jnp.asarray(inv_mass), 25)
    vg = value_and_grad(_gaussian(), lambda x: {"x": x})
    x = torch.tensor(x0, dtype=F64)
    lp, g = vg(x)
    x_t, p_t, lp_t, g_t = thmc._leapfrog(vg, x, torch.tensor(p0, dtype=F64),
                                         g, 0.13, torch.tensor(inv_mass,
                                                               dtype=F64), 25)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-12)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-12)
    xj = np.asarray(x_j)
    np.testing.assert_allclose(lp_t, -0.5 * xj @ prec @ xj, rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), -prec @ xj, rtol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_nuts.py, ported
# ---------------------------------------------------------------------------

def test_recovers_correlated_gaussian():
    logp = _gaussian(mean=(1.0, -1.0))
    init = {"x": torch.randn(4, 2, generator=_gen(0), dtype=F64)}
    res = nuts(logp, init, _gen(1), num_warmup=400, num_samples=500,
               max_depth=8)
    xs = res.samples["x"].numpy()
    assert xs.shape == (4, 500, 2) and res.tree_depth.shape == (4, 500)
    flat = xs.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0), [1.0, -1.0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.35)
    assert np.all(split_rhat(xs).numpy() < 1.05)
    assert int(res.num_divergent.sum()) == 0
    assert float(res.accept_rate.mean()) > 0.55
    # multi-step trajectories, not a random walk
    assert float(res.tree_depth.double().mean()) >= 1.0
    # each draw's recorded log density is the target's there
    np.testing.assert_allclose(
        res.log_prob[:, -1].numpy(),
        [float(logp({"x": torch.tensor(x)})) for x in xs[:, -1]],
        rtol=1e-12)


@pytest.mark.parametrize("target,hi", [(0.8, 0.95), (0.9, 0.98)])
def test_adaptation_calibration(target, hi):
    # dual averaging with a converged warmup lands the realized acceptance
    # statistic at or mildly above target (tests/test_nuts.py explains the
    # overshoot and why targets below ~0.7 are not tested)
    def logp(theta):
        return -0.5 * torch.sum(theta["x"] ** 2)

    res = nuts(logp, {"x": torch.zeros(4, 3, dtype=F64)}, _gen(2),
               num_warmup=500, num_samples=300, max_depth=8,
               target_accept=target)
    acc = float(res.accept_rate.mean())
    assert target - 0.05 <= acc <= hi, (target, acc)


def test_chunked_equals_monolithic():
    logp = _gaussian()
    init = {"x": torch.randn(3, 2, generator=_gen(3), dtype=F64)}
    kw = dict(num_warmup=60, num_samples=40, max_depth=6)
    r1 = nuts(logp, init, _gen(4), **kw)
    r2 = nuts(logp, init, _gen(4), steps_per_call=17, **kw)
    for a, b in zip(r1, r2):
        a, b = (a["x"], b["x"]) if isinstance(a, dict) else (a, b)
        assert torch.equal(a, b)
    assert int(r1.num_divergent.sum()) == int(r2.num_divergent.sum())
    with pytest.raises(ValueError, match="steps_per_call"):
        nuts(logp, init, _gen(4), steps_per_call=0, **kw)


def test_same_seed_same_draws_and_no_global_rng():
    logp = _gaussian()
    init = {"x": torch.zeros(2, 2, dtype=F64)}
    kw = dict(num_warmup=30, num_samples=20, max_depth=5)
    torch.manual_seed(0)
    state = torch.get_rng_state()
    r1 = nuts(logp, init, _gen(5), **kw)
    assert torch.equal(torch.get_rng_state(), state)
    torch.manual_seed(1)
    r2 = nuts(logp, init, _gen(5), **kw)
    for a, b in zip(r1, r2):
        a, b = (a["x"], b["x"]) if isinstance(a, dict) else (a, b)
        assert torch.equal(a, b)
    r3 = nuts(logp, init, _gen(6), **kw)
    assert not torch.equal(r1.samples["x"], r3.samples["x"])
    # each chain draws from its own stream: adding a chain changes none of
    # the others
    r4 = nuts(logp, {"x": torch.zeros(3, 2, dtype=F64)}, _gen(5), **kw)
    assert torch.equal(r4.samples["x"][:2], r1.samples["x"])


def test_ess_beats_short_hmc():
    sd = torch.tensor([0.05, 1.0, 20.0], dtype=F64)

    def logp(theta):
        z = theta["x"] / sd
        return -0.5 * torch.sum(z * z)

    res = nuts(logp, {"x": torch.zeros(4, 3, dtype=F64)}, _gen(2),
               num_warmup=500, num_samples=500, max_depth=8)
    xs = res.samples["x"].numpy()
    np.testing.assert_allclose(xs.reshape(-1, 3).std(0), sd.numpy(),
                               rtol=0.3)
    assert np.all(ess(xs).numpy() > 200)


def test_non_finite_log_prob_is_a_divergence():
    # NaN beyond x > 1.5 (a sweep past its jitter escalation): trajectories
    # that reach it diverge, the draws stay finite
    def logp(theta):
        x = theta["x"]
        v = -0.5 * torch.sum(x * x)
        return torch.where(x.max() > 1.5, torch.full_like(v, float("nan")),
                           v)

    res = nuts(logp, {"x": torch.zeros(2, 1, dtype=F64)}, _gen(7),
               num_warmup=30, num_samples=100, max_depth=6)
    xs = res.samples["x"].numpy()
    assert np.isfinite(xs).all() and (xs <= 1.5).all()
    assert np.isfinite(res.log_prob.numpy()).all()
    assert int(res.num_divergent.sum()) > 0
    assert np.isfinite(res.accept_rate.numpy()).all()


def test_mra_posterior_smoke():
    locs = gen_locations(50)
    x = simulate_grf(_gen(0), locs, Kernel("exponential", l=0.3),
                     jitter=1e-10, device="cpu")
    y, _ = make_observations(_gen(1), x, 1e-2, 0.8)
    model = MRAModel(locs, r=2, M=2, J=3, dtype=F64, device="cpu")
    f = model.loglik_fn(y.numpy(), 1e-2, kernel_builder=lambda th: Kernel(
        "exponential", l=torch.exp(th["log_l"])))

    def logp(th):
        # a weak normal prior on log l keeps the posterior proper
        return f(th) - 0.5 * (th["log_l"] + 1.0) ** 2 / 4.0

    init = {"log_l": torch.tensor([-1.5, -1.0], dtype=F64)}
    res = nuts(logp, init, _gen(3), num_warmup=50, num_samples=50,
               max_depth=6)
    ls = np.exp(res.samples["log_l"].numpy())
    assert np.all(np.isfinite(ls))
    assert 0.03 < np.median(ls) < 3.0
