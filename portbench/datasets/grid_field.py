"""Locations on a regular grid over the unit square and observations of a
smooth random field plus noise, drawn from the run's seed.

The field is a sum of random Fourier features whose frequencies follow the
spectral density of the exponential covariance ``sig exp(-d / l)`` in two
dimensions (a bivariate Student t with one degree of freedom, scaled by
``1 / l``), so the data look like a draw of the model the sweep fits. Each
location is missing with probability ``missing``. Every seed gives the same
grid, the same number of features and the same work; only the values and
the missing pattern change.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["make"]


def grid(side: int) -> np.ndarray:
    """``side^2`` points of ``linspace(0, 1, side)`` squared, x fastest
    within a row."""
    xx, yy = np.meshgrid(np.linspace(0.0, 1.0, side),
                         np.linspace(0.0, 1.0, side))
    return np.hstack((xx.reshape(-1, 1), yy.reshape(-1, 1)))


def make(spec: dict, seed_seq: np.random.SeedSequence, device) -> tuple:
    """``(locs [N, 2] float64, y [N] float64 with NaN where missing)``."""
    locs = grid(int(spec["side"]))
    n = len(locs)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed_seq.generate_state(1, np.uint64)[0] >> 1))
    k = int(spec["features"])
    f64 = dict(dtype=torch.float64, device=dev)
    z = torch.randn(k, 2, generator=gen, **f64)
    chi = torch.randn(k, generator=gen, **f64) ** 2
    omega = z / (torch.sqrt(chi)[:, None] * float(spec["l"]))
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
