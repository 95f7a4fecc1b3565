"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ctypes. The
build happens at first use, into the git-ignored ``pymra_torch/_build``
directory, so a fresh checkout builds everything on its first call. There
is no fast-math and no flush-to-zero: the kernels' jitter escalation relies
on IEEE ``sqrtf``/``logf`` producing NaN and -inf. ``build_log`` keeps the
compiler's register / shared-memory report (``-Xptxas=-v``).
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

from pymra_torch.ops import build_shared_library

__all__ = ["load_library", "nvcc_path", "NVCC_FLAGS"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOCK = threading.Lock()
_LIB = None
#: compiler output of the build done by this process ("" when the library
#: was already built)
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # a, jit, l, ld, f, batch, p, f0, f1, f2, device, stream
    "pymra_cholesky_jittered": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I,
                                _P],
    # c, kmask, a_oo, jitter, li, ldp, ldq, fp, fq, batch, p, f0, f1, f2,
    # device, stream
    "pymra_leaf_factor": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _F,
                          _F, _F, _I, _P],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels cannot be built")
    return found


def _sources() -> list[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    return sorted(glob.glob(os.path.join(here, "csrc", "*.cu")))


def load_library() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library.

    Raises ``RuntimeError`` when nvcc is missing or the build or the load
    fails: a caller that holds a CUDA tensor gets an error, never a
    fallback.
    """
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so, log = build_shared_library(
            "libpymra_kernels", _sources(), [nvcc_path()] + NVCC_FLAGS,
            timeout=900)
        build_log = log
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"loading {so} failed: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return _LIB

