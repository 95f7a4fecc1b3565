"""The port's samplers held to the quadrature posterior of
``tests/test_sampler_validation.py`` (the JAX package's validation,
ported).

The MRA likelihood at M=0 is exactly the dense-GP marginal likelihood, so
on the JAX test's small 1-D problem (N=36, exponential kernel, R=1e-2) the
posterior of log l and the evidence are known to machine precision by
quadrature. Here:

* the port's ``loglik_fn`` (float64, CPU) on the JAX test's data equals the
  JAX package's, value and gradient, within 1e-10 relative at three
  points, and the dense loglik within the JAX test's 1e-7;
* the port's NUTS and HMC hold the quadrature moments within 4 MCSE (from
  the run's own ESS), with the JAX test's R-hat bounds (1.02 / 1.03), no
  NUTS divergence and ESS > 100;
* the port's SMC holds ``TestSMCEvidence``'s bands on the evidence.

The NUTS and HMC chains are shorter than the JAX test's, to fit the
suite's time (one value-and-gradient evaluation here takes ~1.5 ms); the
bounds are the JAX test's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pymra_torch import Kernel, MRAModel
from pymra_torch.infer import ess, hmc, nuts, smc, split_rhat
from tests import test_sampler_validation as jsv
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
PRIOR_MU, PRIOR_SD = jsv.PRIOR_MU, jsv.PRIOR_SD


def _gen(seed):
    return torch.Generator().manual_seed(seed)


_PORT = {}


def _port_loglik():
    """The port's ``theta -> loglik`` on the JAX test's data (``log_l``)."""
    if "f" not in _PORT:
        from pymra_torch.utils import gen_locations

        model = MRAModel(gen_locations(36), r=4, M=0, J=2, dtype=F64,
                         device="cpu")
        _PORT["f"] = model.loglik_fn(
            jsv._problem()["y"], jsv.R_NOISE,
            kernel_builder=lambda th: Kernel("exponential",
                                             l=torch.exp(th["log_l"])))
    return _PORT["f"]


def _logp(th):
    return _port_loglik()(th) - 0.5 * ((th["log_l"] - PRIOR_MU)
                                       / PRIOR_SD) ** 2


def _moment_tolerances(xs):
    """(mcse_mean, mcse_sd, ess) for a scalar parameter's [chains, n]."""
    e = max(float(torch.sum(ess(xs[..., None]))), 8.0)
    sd = float(xs.std())
    return sd / np.sqrt(e), sd / np.sqrt(2.0 * e), e


def _holds_quadrature(xs, rhat_max):
    pb = jsv._problem()
    xs = np.asarray(xs)
    assert float(split_rhat(xs[..., None]).max()) < rhat_max
    mcse_mean, mcse_sd, e = _moment_tolerances(xs)
    assert e > 100.0
    # 4-sigma MCSE bands around the quadrature-exact moments
    assert abs(xs.mean() - pb["post_mean"]) < 4.0 * mcse_mean, (
        xs.mean(), pb["post_mean"], mcse_mean)
    assert abs(xs.std() - pb["post_sd"]) < 4.0 * mcse_sd, (
        xs.std(), pb["post_sd"], mcse_sd)


def test_loglik_matches_jax_and_dense():
    pb = jsv._problem()
    f = _port_loglik()
    jax_vg = jax.value_and_grad(lambda g: pb["f"]({"log_l": g}))
    for g in (-2.0, -1.0, 0.0):
        th = {"log_l": torch.tensor(g, dtype=F64, requires_grad=True)}
        value = f(th)
        value.backward()
        want, want_grad = jax_vg(jnp.float64(g))
        value = float(value.detach())
        assert abs(value - float(want)) <= 1e-10 * abs(float(want))
        assert abs(float(th["log_l"].grad) - float(want_grad)) <= (
            1e-10 * abs(float(want_grad)))
        dense = pb["dense_loglik"](g)
        assert abs(value - dense) < 1e-7 * max(1.0, abs(dense))


def test_nuts_posterior_moments_within_mcse():
    init = {"log_l": PRIOR_MU + 0.3 * torch.randn(4, generator=_gen(7),
                                                  dtype=F64)}
    res = nuts(_logp, init, _gen(8), num_warmup=150, num_samples=200,
               max_depth=6)
    assert int(res.num_divergent.sum()) == 0
    _holds_quadrature(res.samples["log_l"], 1.02)


def test_hmc_posterior_moments_within_mcse():
    init = {"log_l": PRIOR_MU + 0.3 * torch.randn(4, generator=_gen(9),
                                                  dtype=F64)}
    res = hmc(_logp, init, _gen(10), num_warmup=100, num_samples=150,
              num_leapfrog=12)
    _holds_quadrature(res.samples["log_l"], 1.03)


def test_smc_log_evidence_matches_quadrature():
    pb = jsv._problem()
    half_log = 0.5 * np.log(2 * np.pi * PRIOR_SD ** 2)

    def log_prior(th):
        return -0.5 * ((th["log_l"] - PRIOR_MU) / PRIOR_SD) ** 2 - half_log

    def prior_sample(g):
        return {"log_l": PRIOR_MU + PRIOR_SD * torch.randn(
            (), generator=g, dtype=F64)}

    evs, means = [], []
    for seed in (20, 21, 22):
        res = smc(_port_loglik(), log_prior, prior_sample, _gen(seed),
                  n_particles=384, n_mutations=5)
        assert float(res.betas[-1]) == 1.0
        evs.append(float(res.log_evidence))
        means.append(float(res.particles["log_l"].mean()))
    evs = np.array(evs)
    # each replicate near the quadrature evidence, the replicates' spread
    # of Monte-Carlo size
    mc_sd = max(evs.std(ddof=1), 0.01)
    assert abs(evs.mean() - pb["log_evidence"]) < max(
        4.0 * mc_sd / np.sqrt(len(evs)), 0.05), (evs, pb["log_evidence"])
    assert np.all(np.abs(evs - pb["log_evidence"]) < 0.5)
    assert abs(np.mean(means) - pb["post_mean"]) < 0.15
