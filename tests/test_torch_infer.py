"""The port's inference front-end (``pymra_torch.infer``) against the JAX
package's, and the JAX package's ``tests/test_infer.py``, ported.

* Pure functions against the JAX ones on the same float64 inputs made with
  numpy: the warmup schedule (every ``num_warmup`` in 0..1200, list-equal),
  200-step dual-averaging and Welford sequences (rtol 1e-12), ``split_rhat``
  and ``ess`` (rtol 1e-10), SMC's ``_next_beta`` (1e-12) and systematic
  resampling (identical indices for the uniform JAX draws from its key),
  the health reports.
* The samplers draw from torch generators, not JAX keys, so they are held
  statistically, at ``tests/test_infer.py``'s tolerances: HMC, ADVI and SMC
  on Gaussians, HMC on the MRA likelihood.
* The same generator seed gives bit-identical draws, and the global
  generator is neither read nor advanced.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_tpu.infer import adapt as jadapt
from pymra_tpu.infer import diagnostics as jdiag
from pymra_tpu.utils import health as jhealth
from pymra_torch import Kernel, MRAModel
from pymra_torch.infer import adapt, advi, ess, hmc, smc, split_rhat
from pymra_torch.utils import (
    gen_locations,
    gen_locations_2d,
    health,
    make_observations,
    simulate_grf,
)
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
# the modules (``infer.smc`` is also the name of the function)
jsmc = importlib.import_module("pymra_tpu.infer.smc")
tsmc = importlib.import_module("pymra_torch.infer.smc")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


# ---------------------------------------------------------------------------
# warmup adaptation against the JAX functions
# ---------------------------------------------------------------------------

def test_warmup_schedule_matches_jax():
    for n in range(1201):
        assert adapt.warmup_schedule(n) == jadapt.warmup_schedule(n), n


def test_dual_averaging_sequence_matches_jax():
    rng = np.random.default_rng(0)
    accept = rng.uniform(size=200)
    accept[::17] = 0.0
    for eps0, target in ((0.1, 0.8), (1.7, 0.9)):
        t, j = adapt.da_init(eps0), jadapt.da_init(eps0)
        for a in accept:
            t = adapt.da_update(t, torch.tensor(a, dtype=F64), target)
            j = jadapt.da_update(j, jnp.asarray(a), target)
            for got, want in zip(t, j):
                _close(got, want, 1e-12)
        _close(adapt.da_final(t), jadapt.da_final(j), 1e-12)


def test_welford_sequence_and_variance_match_jax():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((200, 3)) * np.array([0.01, 1.0, 30.0]) + 2.0
    t, j = adapt.welford_init(3), jadapt.welford_init(3, jnp.float64)
    for i, x in enumerate(xs):
        if i < 6 or i % 37 == 0:
            for reg in (True, False):
                _close(adapt.welford_var(t, reg), jadapt.welford_var(j, reg),
                       1e-12)
        t = adapt.welford_update(t, torch.tensor(x, dtype=F64))
        j = jadapt.welford_update(j, jnp.asarray(x))
        for got, want in zip(t, j):
            _close(got, want, 1e-12)
    _close(adapt.welford_var(t), jadapt.welford_var(j), 1e-12)


# ---------------------------------------------------------------------------
# diagnostics against the JAX functions, and tests/test_infer.py's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,max_lag", [((4, 500, 3), None),
                                           ((4, 256, 2), 100),
                                           ((3, 101), None), ((2, 64), 7)])
def test_split_rhat_and_ess_match_jax(shape, max_lag):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    x[1] += 0.3  # one chain off, so R-hat departs from 1
    x = np.cumsum(x, axis=1) * 0.1 + x  # autocorrelated
    _close(split_rhat(x), jdiag.split_rhat(x), 1e-10)
    _close(ess(x, max_lag=max_lag), jdiag.ess(x, max_lag=max_lag), 1e-10)
    # tensors in, the same numbers out
    _close(ess(torch.as_tensor(x), max_lag=max_lag),
           jdiag.ess(x, max_lag=max_lag), 1e-10)


def test_rhat_iid_and_detects_an_offset_chain():
    x = np.random.default_rng(0).standard_normal((4, 500, 3))
    assert np.all(np.abs(split_rhat(x).numpy() - 1.0) < 0.05)
    y = np.random.default_rng(1).standard_normal((4, 500))
    y[0] += 3.0
    assert float(split_rhat(y)) > 1.5


def test_ess_iid_vs_correlated():
    rng = np.random.default_rng(2)
    iid = rng.standard_normal((4, 500))
    e_iid = float(ess(iid))
    assert e_iid > 800
    ar = np.zeros((4, 500))
    for c in range(4):
        z = rng.standard_normal(500)
        for t in range(1, 500):
            ar[c, t] = 0.95 * ar[c, t - 1] + np.sqrt(1 - 0.95 ** 2) * z[t]
    assert float(ess(ar)) < e_iid / 5


# ---------------------------------------------------------------------------
# SMC's pure parts against the JAX functions
# ---------------------------------------------------------------------------

def test_next_beta_matches_jax():
    rng = np.random.default_rng(3)
    for scale, beta, target in ((50.0, 0.0, 0.5), (5.0, 0.3, 0.5),
                                (500.0, 0.9, 0.7), (0.01, 0.0, 0.5)):
        ll = rng.normal(size=256) * scale - 100.0
        got = tsmc._next_beta(torch.tensor(ll, dtype=F64), beta, target, 256)
        want = float(jsmc._next_beta(jnp.asarray(ll), jnp.float64(beta),
                                     target, 256))
        assert abs(got - want) <= 1e-12, (scale, beta, got, want)
    assert got == 1.0  # the last case needs no tempering


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(4)
    for seed, n in ((0, 16), (1, 384), (2, 1000)):
        log_w = rng.normal(size=n) * 3.0
        key = jax.random.key(seed)
        want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(log_w),
                                                    n))
        u = float(jax.random.uniform(key, ()))
        got = tsmc._systematic_resample_u(torch.tensor(u, dtype=F64),
                                          torch.tensor(log_w, dtype=F64), n)
        np.testing.assert_array_equal(got.numpy(), want)
    idx = tsmc._systematic_resample(_gen(0), torch.zeros(8, dtype=F64), 8)
    np.testing.assert_array_equal(idx.numpy(), np.arange(8))


# ---------------------------------------------------------------------------
# health reports against the JAX package's
# ---------------------------------------------------------------------------

def test_check_samples_and_resume_state_match_jax():
    rng = np.random.default_rng(5)
    samples = {"b": rng.standard_normal((2, 5, 3)),
               "a": rng.standard_normal((2, 5))}
    samples["b"][1, 2, 0] = np.nan
    samples["a"][0, 4] = np.inf
    for s in (samples, {"a": samples["a"][:, :, None] * 0 + 1.0}):
        for div in (None, np.array([0, 1]), np.array([3, 2])):
            want = jhealth.check_samples(s, div, max_divergence_rate=0.2)
            got = health.check_samples(
                {k: torch.as_tensor(v) for k, v in s.items()},
                None if div is None else torch.as_tensor(div),
                max_divergence_rate=0.2)
            assert tuple(got) == tuple(want)
            assert str(got) == str(want)
    with pytest.raises(health.SweepHealthError):
        health.check_samples(samples, raise_on_failure=True)
    got = health.resume_state({k: torch.as_tensor(v)
                               for k, v in samples.items()})
    want = jhealth.resume_state(samples)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_check_result_matches_jax():
    from pymra_tpu import kernels as jk
    from pymra_tpu.tree.model import MRAModel as JaxMRAModel

    locs = gen_locations_2d(8)
    y = np.random.default_rng(0).standard_normal(len(locs))
    port = MRAModel(locs, r=4, M=1, J=4, dtype=F64, device="cpu")
    ref = JaxMRAModel(locs, r=4, M=1, J=4)
    for l in (0.3, float("nan")):
        got = health.check_result(port.sweep(Kernel("exponential", l=l), y,
                                             1e-3))
        want = jhealth.check_result(ref.sweep(
            jk.Kernel("exponential", l=jnp.float64(l)), y, 1e-3))
        assert got.ok == want.ok and got.nonfinite == want.nonfinite
        assert got.negative_var == want.negative_var
    assert not got.ok and "objective" in got.nonfinite


# ---------------------------------------------------------------------------
# the samplers (tests/test_infer.py, ported)
# ---------------------------------------------------------------------------

def _gaussian_logp(mean, sd):
    mean = torch.tensor(mean, dtype=F64)
    sd = torch.tensor(sd, dtype=F64)

    def logp(theta):
        z = (theta["x"] - mean) / sd
        return -0.5 * torch.sum(z * z)

    return logp, mean.numpy(), sd.numpy()


def test_hmc_recovers_gaussian():
    logp, mean, sd = _gaussian_logp([1.0, -2.0], [0.5, 2.0])
    init = {"x": torch.randn(4, 2, generator=_gen(0), dtype=F64)}
    # twice the JAX test's draws: the mean's error bound (0.2) is ~2.7
    # MCSEs of 400 draws a chain, which this seed's run exceeds
    res = hmc(logp, init, _gen(1), num_warmup=300, num_samples=800,
              num_leapfrog=8)
    xs = res.samples["x"].numpy()
    assert xs.shape == (4, 800, 2) and res.log_prob.shape == (4, 800)
    flat = xs.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0), mean, atol=0.2)
    np.testing.assert_allclose(flat.std(0), sd, rtol=0.25)
    assert float(res.accept_rate.mean()) > 0.5
    assert np.all(split_rhat(xs).numpy() < 1.1)
    # mass adaptation learned the scale ratio
    ratio = res.inv_mass.numpy().mean(0)
    assert ratio[1] > ratio[0]


def test_hmc_same_seed_same_draws_and_no_global_rng():
    logp, _, _ = _gaussian_logp([0.0, 0.0], [1.0, 3.0])
    init = {"x": torch.zeros(2, 2, dtype=F64)}
    kw = dict(num_warmup=30, num_samples=20, num_leapfrog=5)
    torch.manual_seed(123)
    r1 = hmc(logp, init, _gen(9), **kw)
    state = torch.get_rng_state()
    torch.manual_seed(456)
    r2 = hmc(logp, init, _gen(9), **kw)
    assert torch.equal(r1.samples["x"], r2.samples["x"])
    assert torch.equal(r1.log_prob, r2.log_prob)
    assert torch.equal(r1.step_size, r2.step_size)
    torch.manual_seed(123)
    hmc(logp, init, _gen(9), **kw)
    assert torch.equal(torch.get_rng_state(), state)
    r3 = hmc(logp, init, _gen(10), **kw)
    assert not torch.equal(r1.samples["x"], r3.samples["x"])


def test_hmc_rejects_non_finite_energy():
    # log_prob NaN beyond x > 1: every trajectory that ends there is
    # rejected (accept probability 0), so the chain stays finite
    def logp(theta):
        x = theta["x"]
        v = -0.5 * torch.sum(x * x)
        return torch.where(x.max() > 1.0, torch.full_like(v, float("nan")),
                           v)

    res = hmc(logp, {"x": torch.zeros(2, 1, dtype=F64)}, _gen(2),
              num_warmup=20, num_samples=60, num_leapfrog=6)
    xs = res.samples["x"].numpy()
    assert np.isfinite(xs).all() and (xs <= 1.0).all()
    assert np.isfinite(res.log_prob.numpy()).all()


def _mra_loglik():
    """The MRA smoke problem of ``tests/test_infer.py``, its data drawn
    with the port's simulators (``theta -> loglik`` in ``l``)."""
    locs = gen_locations(60)
    x = simulate_grf(_gen(0), locs, Kernel("exponential", l=0.3),
                     jitter=1e-10, device="cpu")
    y, _ = make_observations(_gen(1), x, 1e-2, 0.8)
    model = MRAModel(locs, r=2, M=2, J=3, dtype=F64, device="cpu")
    return model.loglik_fn(y.numpy(), 1e-2, kernel_builder=lambda th: Kernel(
        "exponential", l=th["l"]))


def test_hmc_mra_posterior_smoke():
    f = _mra_loglik()

    def logp(theta):
        # log-uniform prior on l through the log-parameterization
        return f({"l": torch.exp(theta["log_l"])})

    init = {"log_l": torch.tensor([-1.0, -0.5], dtype=F64)}
    res = hmc(logp, init, _gen(2), num_warmup=40, num_samples=40,
              num_leapfrog=4)
    ls = np.exp(res.samples["log_l"].numpy())
    assert np.all(np.isfinite(ls))
    assert 0.02 < np.median(ls) < 5.0


def _advi_target():
    mean = torch.tensor([0.5, -1.0], dtype=F64)
    sd = torch.tensor([0.3, 1.5], dtype=F64)

    def logp(theta):
        z = (theta["x"] - mean) / sd
        return -0.5 * torch.sum(z * z) - torch.sum(torch.log(sd))

    return logp, mean.numpy(), sd.numpy()


def test_advi_recovers_gaussian():
    # the returned mean is Adam's last iterate, which wanders ~0.1 around
    # the optimum in x[1] at these settings (tests/test_infer.py's, where
    # atol 0.15 is ~1.5 of that): four runs' average is held to it
    logp, mean, sd = _advi_target()
    runs = [advi(logp, {"x": torch.zeros(2, dtype=F64)}, _gen(seed),
                 steps=600, num_mc=16, learning_rate=5e-2)
            for seed in range(4)]
    np.testing.assert_allclose(np.mean([r.mean["x"].numpy() for r in runs],
                                       axis=0), mean, atol=0.15)
    np.testing.assert_allclose(np.mean([r.sd["x"].numpy() for r in runs],
                                       axis=0), sd, rtol=0.35)
    for res in runs:
        assert res.elbo_history.shape == (600,)
        assert np.isfinite(res.elbo_history.numpy()).all()
    draws = runs[0].sample(_gen(1), 100)
    assert draws["x"].shape == (100, 2)
    assert torch.equal(draws["x"], runs[0].sample(_gen(1), 100)["x"])


def test_advi_steps_match_optax_on_the_same_draws():
    # the port's ELBO, its gradient and torch.optim.Adam against the JAX
    # package's ELBO and optax.adam, fed the draws the port takes from its
    # generator: the same iterates to 1e-10
    import optax

    logp, mean, sd = _advi_target()
    steps, num_mc, lr = 40, 4, 5e-2
    res = advi(logp, {"x": torch.tensor([0.2, 0.1], dtype=F64)}, _gen(7),
               steps=steps, num_mc=num_mc, learning_rate=lr)
    gen = _gen(7)
    zs = [torch.randn(num_mc, 2, generator=gen, dtype=F64).numpy()
          for _ in range(steps)]

    def neg_elbo(params, z):
        mu, log_sd = params
        draws = mu + z * jnp.exp(log_sd)
        lps = -0.5 * jnp.sum(((draws - mean) / sd) ** 2, axis=1) - jnp.sum(
            jnp.log(sd))
        return -(jnp.mean(lps) + jnp.sum(log_sd)
                 + 0.5 * 2 * (1.0 + jnp.log(2 * jnp.pi)))

    solver = optax.adam(lr)
    params = (jnp.asarray([0.2, 0.1]), jnp.full(2, -2.0))
    state = solver.init(params)
    history = []
    for z in zs:
        value, grads = jax.value_and_grad(neg_elbo)(params, z)
        updates, state = solver.update(grads, state)
        params = optax.apply_updates(params, updates)
        history.append(-float(value))
    _close(res.elbo_history, history, 1e-10)
    _close(res.mean["x"], params[0], 1e-10)
    _close(res.sd["x"], jnp.exp(params[1]), 1e-10)


def test_smc_gaussian_posterior_and_evidence():
    # prior N(0, 1), likelihood N(theta; 1, 0.5^2): analytic posterior
    like_mean, like_sd = 1.0, 0.5
    post_var = 1.0 / (1.0 + 1 / like_sd ** 2)
    post_mean = post_var * like_mean / like_sd ** 2
    ev_var = 1.0 + like_sd ** 2
    log_ev = -0.5 * (np.log(2 * np.pi * ev_var) + like_mean ** 2 / ev_var)
    half_log_2pi = 0.5 * np.log(2 * np.pi)

    res = smc(
        log_like_fn=lambda th: -0.5 * ((th["x"] - like_mean) / like_sd) ** 2
        - np.log(like_sd) - half_log_2pi,
        log_prior_fn=lambda th: -0.5 * th["x"] ** 2 - half_log_2pi,
        prior_sample_fn=lambda g: {"x": torch.randn((), generator=g,
                                                    dtype=F64)},
        generator=_gen(3), n_particles=512, n_mutations=5)
    xs = res.particles["x"].numpy()
    assert xs.shape == (512,) and float(res.betas[-1]) == 1.0
    assert res.acc_rates.shape == res.betas.shape
    np.testing.assert_allclose(xs.mean(), post_mean, atol=0.1)
    np.testing.assert_allclose(xs.std(), np.sqrt(post_var), rtol=0.2)
    np.testing.assert_allclose(float(res.log_evidence), log_ev, atol=0.15)


def test_sampler_resume_from_retained_draws(tmp_path):
    # the recovery recipe of tests/test_aux.py::test_sampler_checkpoint_resume:
    # the draws retained in a checkpoint file, reloaded; continue from the
    # last draws with a fresh generator; the continuation is healthy and
    # moves
    from pymra_torch.utils.checkpoint import load_pytree, save_pytree

    def logp(theta):
        return -0.5 * torch.sum(theta["x"] ** 2)

    res1 = hmc(logp, {"x": torch.zeros(2, 3, dtype=F64)}, _gen(0),
               num_warmup=50, num_samples=30)
    assert health.check_samples(res1.samples).ok
    save_pytree(tmp_path / "draws.npz", res1.samples)
    kept = load_pytree(tmp_path / "draws.npz")
    init2 = health.resume_state(kept)
    assert init2["x"].shape == (2, 3)
    assert torch.equal(init2["x"], res1.samples["x"][:, -1])
    res2 = hmc(logp, init2, _gen(1), num_warmup=20, num_samples=30)
    rep = health.check_samples(res2.samples)
    assert rep.ok, str(rep)
    assert bool(((res2.samples["x"][:, -1] - init2["x"]).abs() > 1e-6).any())
