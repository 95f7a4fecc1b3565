"""Regenerate the bundled datasets (counterpart of the JAX package's
``data/generate.py``).

Simulates Gaussian random fields with the recipe of the reference's
bundled data (exponential covariance with range 0.1 on a unit grid, ~86%
of locations observed) from the same documented seeds, with numpy alone,
so it writes the committed ``small`` (10 x 10) and ``large`` (100 x 100)
sets bit for bit. The ``large`` set factors a dense 10^4 x 10^4 float64
covariance (~0.8 GB and a few seconds to minutes of host time).

It writes only into the directory the caller names::

    python -m pymra_torch.data.generate OUT_DIR [--sets small large]

which receives ``OUT_DIR/<set>/{locs,y,y_obs}.npy``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from pymra_torch.utils.locations import gen_locations_2d

__all__ = ["RANGE", "ME_SD", "FRAC_OBS", "SEED", "SETS", "generate"]

RANGE = 0.1
ME_SD = 1e-2
FRAC_OBS = 0.86
SEED = 20260817
#: the bundled sets: name -> grid side; each is simulated from SEED + side
SETS = {"small": 10, "large": 100}


def _simulate(nx: int, seed: int):
    """``(locs [n, 2], y [n], y_obs [n])`` on an ``nx x nx`` grid: the
    field, and the noisy observations with NaN where unobserved."""
    locs = gen_locations_2d(nx)
    n = len(locs)
    rng = np.random.default_rng(seed)
    d = np.sqrt(
        ((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1)
    )
    cov = np.exp(-d / RANGE)
    chol = np.linalg.cholesky(cov + 1e-10 * np.eye(n))
    y = chol @ rng.standard_normal(n)
    y_noisy = y + ME_SD * rng.standard_normal(n)
    obs_idx = rng.choice(n, size=int(round(n * FRAC_OBS)), replace=False)
    y_obs = np.full(n, np.nan)
    y_obs[obs_idx] = y_noisy[obs_idx]
    return locs, y, y_obs


def generate(out_dir: str, sets=tuple(SETS)) -> dict:
    """Write each named set under ``out_dir/<name>/``; returns ``{name:
    (N, observed)}``."""
    counts = {}
    for name in sets:
        nx = SETS[name]
        out = os.path.join(out_dir, name)
        os.makedirs(out, exist_ok=True)
        locs, y, y_obs = _simulate(nx, SEED + nx)
        np.save(os.path.join(out, "locs.npy"), locs)
        np.save(os.path.join(out, "y.npy"), y)
        np.save(os.path.join(out, "y_obs.npy"), y_obs)
        counts[name] = (len(locs), int(np.isfinite(y_obs).sum()))
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", help="directory that receives the sets")
    parser.add_argument("--sets", nargs="+", choices=list(SETS),
                        default=list(SETS))
    args = parser.parse_args(argv)
    for name, (n, obs) in generate(args.out_dir, args.sets).items():
        print(f"{name}: N={n}, observed={obs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
