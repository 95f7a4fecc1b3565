"""Parameter sets of a traffic mix, drawn from the run's seed.

A mix names, for each covariance parameter, a distribution:
``["log_normal", mu, sd]`` (the log of the parameter is normal),
``["log_uniform", lo, hi]`` or ``["const", value]``. Each call gets ``C``
sets; a pool of calls is drawn before the window and the window cycles
through it, so every seed runs the same number and shape of calls.
"""
from __future__ import annotations

import numpy as np

__all__ = ["draw"]


def _draw_one(rng: np.random.Generator, dist: list, shape) -> np.ndarray:
    kind, *args = dist
    if kind == "log_normal":
        return np.exp(rng.normal(args[0], args[1], shape))
    if kind == "log_uniform":
        return np.exp(rng.uniform(np.log(args[0]), np.log(args[1]), shape))
    if kind == "const":
        return np.full(shape, float(args[0]))
    raise ValueError(f"unknown set distribution {kind!r}")


def draw(mix: dict, rng: np.random.Generator, calls: int) -> dict:
    """``{param: [calls, C] float64}`` for the mix's ``sets``, in the
    sorted order of the parameters' names."""
    shape = (calls, int(mix["C"]))
    return {k: _draw_one(rng, mix["sets"][k], shape)
            for k in sorted(mix["sets"])}
