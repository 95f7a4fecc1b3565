"""ctypes binding to the native planner core ``csrc/planner.cpp``
(counterpart of ``pymra_tpu/ops/native``).

The library is compiled with ``g++`` on first use into the port's build
directory, with the JAX binding's flags, so both packages run the same
k-means code. Unlike the JAX binding there is no silent fallback: when the
library cannot be built or loaded, :func:`kmeans`, :func:`kmeans_batch` and
:func:`quadrant_split` raise, because the numpy Lloyd fallback would plan a
different tree.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from pymra_torch.ops import build_shared_library, host_cpu_flags

__all__ = ["load_library", "kmeans", "kmeans_batch", "quadrant_split"]

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
        lib.pymra_kmeans_batch.restype = ctypes.c_int
        lib.pymra_kmeans_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pymra_quadrant_split.restype = ctypes.c_int
        lib.pymra_quadrant_split.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _points(points: np.ndarray, d: int | None = None) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or (d is not None and pts.shape[1] != d):
        raise ValueError(f"points: shape {pts.shape}, expected [n, "
                         f"{d if d is not None else 'd'}]")
    return pts


def kmeans(points: np.ndarray, k: int, seed: int = 0, max_iter: int = 50):
    """Deterministic kmeans++/Lloyd. Returns (centers [k, d], labels [n])."""
    lib = load_library()
    pts = _points(points)
    n, d = pts.shape
    k = min(k, n)
    centers = np.empty((k, d), dtype=np.float64)
    labels = np.empty(n, dtype=np.int32)
    rc = lib.pymra_kmeans(_dptr(pts), n, d, k, max_iter, seed,
                          _dptr(centers), _iptr(labels))
    if rc < 0:
        raise ValueError("pymra_kmeans failed")
    return centers, labels.astype(np.int64)


def kmeans_batch(points: np.ndarray, offsets: np.ndarray, k: int,
                 seed: int = 0, max_iter: int = 50):
    """k-means over many concatenated point sets in one native call.

    Args:
      points: [total, d] concatenated sets.
      offsets: [n_sets + 1] prefix offsets delimiting each set; set ``s``
        is seeded with ``seed + s``.

    Returns (centers [n_sets, k, d], labels [total]); a set smaller than
    ``k`` leaves its trailing center rows unwritten, as the JAX binding's.
    """
    lib = load_library()
    pts = _points(points)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    if (offs.ndim != 1 or len(offs) < 1 or offs[0] != 0
            or offs[-1] != len(pts) or np.any(np.diff(offs) < 0)):
        raise ValueError("offsets must rise from 0 to len(points)")
    n_sets = len(offs) - 1
    d = pts.shape[1]
    centers = np.empty((n_sets, k, d), dtype=np.float64)
    labels = np.empty(len(pts), dtype=np.int32)
    rc = lib.pymra_kmeans_batch(
        _dptr(pts), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_sets, d, k, max_iter, seed, _dptr(centers), _iptr(labels))
    if rc < 0:
        raise ValueError("pymra_kmeans_batch failed")
    return centers, labels.astype(np.int64)


def quadrant_split(points: np.ndarray) -> np.ndarray:
    """Mean-quadrant labels (0..3) for a 2-D point set."""
    lib = load_library()
    pts = _points(points, 2)
    labels = np.empty(len(pts), dtype=np.int32)
    rc = lib.pymra_quadrant_split(_dptr(pts), len(pts), _iptr(labels))
    if rc < 0:
        raise ValueError("pymra_quadrant_split failed")
    return labels.astype(np.int64)
