"""Location/grid generators (counterpart of ``pymra_tpu/utils/locations.py``).

Host-side numpy helpers; the arrays they return are identical to the JAX
package's, so both packages plan the same trees from them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gen_locations", "gen_locations_2d", "gen_clusters"]


def gen_locations(n_grid: int, lb: float = 0.0, ub: float = 1.0,
                  random: bool = False, seed: int | None = None) -> np.ndarray:
    """1-D grid of ``n_grid`` points on ``(lb, ub]`` as an ``[n, 1]`` array.

    The deterministic grid is ``linspace(lb, ub, n+1)[1:]`` (it excludes the
    lower bound), as in the reference's ``genLocations``.
    """
    if random:
        rng = np.random.default_rng(seed)
        locs = rng.uniform(lb, ub, n_grid)
    else:
        locs = np.linspace(lb, ub, num=n_grid + 1)[1:]
    return locs.reshape(n_grid, 1)


def gen_locations_2d(nx: int, lbx: float = 0.0, ubx: float = 1.0,
                     ny: int = 0, lby: float = 0.0, uby: float = 1.0
                     ) -> np.ndarray:
    """2-D meshgrid of ``nx * ny`` points as an ``[n, 2]`` array, x varying
    fastest within a y-row (the reference's ``genLocations2d`` order)."""
    if not ny:
        ny = nx
    xx, yy = np.meshgrid(np.linspace(lbx, ubx, num=nx),
                         np.linspace(lby, uby, num=ny))
    return np.hstack((xx.reshape(nx * ny, 1), yy.reshape(nx * ny, 1)))


def gen_clusters(n: int, k: int, seed: int | None = None) -> np.ndarray:
    """``n`` points in ``k`` Gaussian clusters on the unit square (the
    reference's ``genClusters``, seeded explicitly instead of drawing from
    the global RNG)."""
    rng = np.random.default_rng(seed)
    n_per_k = n // k
    points = np.empty((0, 2))
    for _ in range(k):
        pts = rng.normal(loc=rng.uniform(size=2),
                         scale=rng.uniform(low=0.1, high=0.2),
                         size=(n_per_k, 2))
        points = np.vstack((points, pts))
    for _ in range(n - k * n_per_k):
        points = np.vstack((points, rng.uniform(size=2)))
    return points
