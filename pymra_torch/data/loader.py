"""Bundled-dataset loader (counterpart of ``pymra_tpu/data/loader.py``).

The datasets ship once, as ``.npy`` files under ``pymra_tpu/data/{small,
large}/``. They are read here by path, so loading them does not import the
JAX package.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["load_data", "data_dir"]


def data_dir(size: str) -> str:
    if size not in ("small", "large"):
        raise ValueError("size has to be 'small' or 'large'")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "pymra_tpu", "data", size)


def load_data(size: str = "small", include_truth: bool = False):
    """Load a bundled dataset.

    Returns ``(y, locs, y_obs)`` when ``include_truth`` else ``(locs,
    y_obs)``; ``y_obs`` holds NaN at the unobserved locations.
    """
    dirname = data_dir(size)
    y_obs = np.load(os.path.join(dirname, "y_obs.npy"))
    locs = np.load(os.path.join(dirname, "locs.npy"))
    if include_truth:
        y = np.load(os.path.join(dirname, "y.npy"))
        return y, locs, y_obs
    return locs, y_obs
