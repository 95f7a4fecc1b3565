"""ctypes binding to the native planner core ``csrc/planner.cpp``
(counterpart of ``pymra_tpu/ops/native``).

The library is compiled with ``g++`` on first use into the port's build
directory, with the JAX binding's flags, so both packages run the same
k-means code. Unlike the JAX binding there is no silent fallback: when the
library cannot be built or loaded, :func:`kmeans` raises, because the numpy
Lloyd fallback would plan a different tree.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from pymra_torch.ops import build_shared_library, host_cpu_flags

__all__ = ["load_library", "kmeans"]

_LOCK = threading.Lock()
_LIB = None


def _source_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(repo, "csrc", "planner.cpp")


def load_library() -> ctypes.CDLL:
    """Build (once) and load the planner library; raises ``RuntimeError``."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = _source_path()
        if not os.path.exists(src):
            raise RuntimeError(f"native planner source missing: {src}")
        so, _ = build_shared_library(
            "libpymra_planner", [src],
            ["g++", "-O3", "-march=native", "-shared", "-fPIC"], timeout=120,
            key=host_cpu_flags())
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"loading {so} failed: {e}") from e
        lib.pymra_kmeans.restype = ctypes.c_int
        lib.pymra_kmeans.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def kmeans(points: np.ndarray, k: int, seed: int = 0, max_iter: int = 50):
    """Deterministic kmeans++/Lloyd. Returns (centers [k, d], labels [n])."""
    lib = load_library()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, d = pts.shape
    k = min(k, n)
    centers = np.empty((k, d), dtype=np.float64)
    labels = np.empty(n, dtype=np.int32)
    rc = lib.pymra_kmeans(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d, k,
        max_iter, seed, centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        raise ValueError("pymra_kmeans failed")
    return centers, labels.astype(np.int64)
