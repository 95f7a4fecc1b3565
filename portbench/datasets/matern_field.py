"""Locations on a regular grid over the unit square and observations of a
smooth random field plus noise, drawn from the run's seed:
:mod:`portbench.datasets.grid_field` with the frequencies of the Matern
covariance of smoothness ``spec["nu"]``.

The Matern covariance ``sig 2^(1-nu)/Gamma(nu) s^nu K_nu(s)``, ``s =
sqrt(2 nu) d / l``, has in two dimensions the spectral density of a
bivariate Student t with ``2 nu`` degrees of freedom and scale ``1 / l``:
``omega = z / (l sqrt(chi2_(2 nu) / (2 nu)))``, ``z`` standard normal in the
plane. The chi-square is drawn as grid_field draws its one degree of
freedom, a squared normal from the same generator at the same place, plus
the other ``2 nu - 1`` degrees (a gamma variate, from numpy's generator on
the same seed; for ``2 nu < 1`` the squared normal is scaled by a beta
variate instead), so ``nu = 0.5`` gives grid_field's field exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.datasets.grid_field import grid

__all__ = ["make"]


def _chi2_rest(nu: float, chi: torch.Tensor,
               seed_seq: np.random.SeedSequence) -> torch.Tensor:
    """``chi2_(2 nu)`` from the one-degree draws ``chi``: the rest added,
    or ``chi`` scaled down."""
    rng = np.random.default_rng(seed_seq)
    k = chi.shape[0]
    if nu > 0.5:
        rest = 2.0 * rng.gamma(nu - 0.5, 1.0, k)
        return chi + torch.as_tensor(rest, dtype=chi.dtype, device=chi.device)
    if nu < 0.5:
        frac = rng.beta(nu, 0.5 - nu, k)
        return chi * torch.as_tensor(frac, dtype=chi.dtype, device=chi.device)
    return chi


def make(spec: dict, seed_seq: np.random.SeedSequence, device) -> tuple:
    """``(locs [N, 2] float64, y [N] float64 with NaN where missing)``."""
    locs = grid(int(spec["side"]))
    n = len(locs)
    nu = float(spec["nu"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed_seq.generate_state(1, np.uint64)[0] >> 1))
    k = int(spec["features"])
    f64 = dict(dtype=torch.float64, device=dev)
    z = torch.randn(k, 2, generator=gen, **f64)
    chi = _chi2_rest(nu, torch.randn(k, generator=gen, **f64) ** 2, seed_seq)
    omega = z / (torch.sqrt(chi / (2.0 * nu))[:, None] * float(spec["l"]))
    phase = 2.0 * np.pi * torch.rand(k, generator=gen, **f64)
    amp = torch.randn(k, generator=gen, **f64) * np.sqrt(
        2.0 * float(spec["sig"]) / k)
    pts = torch.as_tensor(locs, **f64)
    field = torch.zeros(n, **f64)
    step = 1 << 16
    for i in range(0, n, step):
        field[i:i + step] = torch.cos(pts[i:i + step] @ omega.T + phase) @ amp
    y = field + np.sqrt(float(spec["noise_var"])) * torch.randn(
        n, generator=gen, **f64)
    missing = torch.rand(n, generator=gen, **f64) < float(spec["missing"])
    y = torch.where(missing, torch.full_like(y, float("nan")), y)
    return locs, y.cpu().numpy()
