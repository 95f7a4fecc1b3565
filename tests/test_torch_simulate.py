"""The port's simulators and location generators (``pymra_torch.utils``)
against the JAX package's.

* ``simulate_grf_grid`` (numpy, circulant embedding) bit-identical to the
  JAX package's for a numpy covariance of distance, and within 1e-12 for
  the two packages' ``Kernel`` objects; ``gen_clusters`` identical.
* ``simulate_grf`` and ``make_observations`` draw from a torch generator
  (the JAX ones from a key), so they are held to their definitions: the
  Cholesky factor times the generator's normals, the observed count, the
  NaN pattern and the noise scale, and the same seed gives the same draw
  without touching the global generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu import kernels as jk
from pymra_tpu.utils import locations as jloc
from pymra_tpu.utils import simulate as jsim
from pymra_torch import Kernel
from pymra_torch.utils import (
    gen_clusters,
    gen_locations,
    make_observations,
    simulate_grf,
    simulate_grf_grid,
)
from tests.torch_fixtures import jax_native_planner  # noqa: F401
from tests.torch_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("nx,ny,dtype", [(16, 0, "float32"),
                                         (24, 10, "float64"),
                                         (1, 5, "float64")])
def test_simulate_grf_grid_matches_jax(nx, ny, dtype):
    def covfn(d):
        return 2.0 * np.exp(-d / 0.2)

    for seed in (0, 7):
        got = simulate_grf_grid(seed, nx, covfn, ny=ny, ubx=2.0,
                                dtype=dtype)
        want = jsim.simulate_grf_grid(seed, nx, covfn, ny=ny, ubx=2.0,
                                      dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_simulate_grf_grid_with_kernels_matches_jax():
    got = simulate_grf_grid(3, 20, Kernel("matern32", l=0.1, sig=1.5),
                            dtype="float64")
    want = jsim.simulate_grf_grid(3, 20, jk.Kernel("matern32", l=0.1,
                                                   sig=1.5), dtype="float64")
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_gen_clusters_matches_jax():
    for n, k, seed in ((100, 4, 0), (103, 5, 1), (7, 3, None), (50, 1, 2)):
        got = gen_clusters(n, k, seed=seed)
        if seed is None:
            assert got.shape == (n, 2)
            continue
        np.testing.assert_array_equal(got, jloc.gen_clusters(n, k,
                                                             seed=seed))


def test_simulate_grf_is_the_factor_times_the_generators_normals():
    locs = gen_locations(30)
    kern = Kernel("exponential", l=0.3)
    cov = kern(torch.as_tensor(locs)) + 1e-10 * torch.eye(30, dtype=F64)
    chol = torch.linalg.cholesky(cov)
    z = torch.randn(30, generator=_gen(4), dtype=F64)
    want = chol @ z + 1.5
    for covfn in (kern, cov, ("chol", chol)):
        jitter = 1e-10 if covfn is kern else 0.0
        got = simulate_grf(_gen(4), locs, covfn, mean=1.5, jitter=jitter,
                           device="cpu")
        assert got.shape == (30,) and got.dtype == F64
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
    # the field's covariance: many draws from one generator
    g = _gen(5)
    draws = torch.stack([simulate_grf(g, locs, ("chol", chol), device="cpu")
                         for _ in range(4000)])
    emp = torch.cov(draws.T)
    assert float((emp - cov).abs().max()) < 0.1


def test_simulate_grf_runs_on_the_card_unless_asked(monkeypatch):
    locs = gen_locations(10)
    kern = Kernel("exponential", l=0.3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_grf(_gen(0), locs, kern, jitter=1e-10)
    got = simulate_grf(_gen(0), locs, kern, jitter=1e-10, device="cpu")
    assert got.device.type == "cpu" and got.shape == (10,)


def test_make_observations():
    x = torch.linspace(0.0, 1.0, 400, dtype=F64)
    state = torch.get_rng_state()
    y, mask = make_observations(_gen(6), x, 1e-2, 0.85)
    assert torch.equal(torch.get_rng_state(), state)
    assert mask.dtype == torch.bool and int(mask.sum()) == round(400 * 0.85)
    assert torch.equal(torch.isnan(y), ~mask)
    noise = (y - x)[mask]
    assert abs(float(noise.std()) - 0.1) < 0.015
    y2, mask2 = make_observations(_gen(6), x.numpy(), 1e-2, 0.85)
    assert torch.equal(mask, mask2)
    assert torch.equal(torch.nan_to_num(y), torch.nan_to_num(y2))
    y_all, mask_all = make_observations(_gen(7), x.reshape(20, 20), 1e-4)
    assert bool(mask_all.all()) and y_all.shape == (400,)
