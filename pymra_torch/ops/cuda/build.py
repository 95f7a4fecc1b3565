"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers it includes) is
compiled by its own ``nvcc`` for Hopper (``sm_90a``) into a shared library
with a plain C interface, all sources at once in parallel, and loaded with
ctypes (on an 8-core host with an H100 about 3 s cold, against 10 s for
one ``nvcc`` over every source: ``tools/build_time.py``). The build
happens at first use, into the git-ignored ``pymra_torch/_build``
directory, so a fresh checkout builds everything on its first call.
There is no fast-math and no flush-to-zero: the kernels' jitter
escalation relies on IEEE ``sqrtf``/``logf`` producing NaN and -inf.
``build_log`` keeps the compiler's register / shared-memory report
(``-Xptxas=-v``).
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading
import types
from concurrent.futures import ThreadPoolExecutor

from pymra_torch.ops import build_shared_library
from pymra_torch.utils import profiling

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
_D = ctypes.c_double
_LL = ctypes.c_longlong
_SIGNATURES = {
    # a, b, dist (the points or the distances; the others null), l, sig,
    # out, table (or null), fallback (or null), f64, nu, sets, pairs, p, q,
    # dim, device, stream
    "pymra_matern": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _I, _LL, _I,
                     _I, _I, _I, _P],
    # a, b, dist, l, sig, g, table (or null), partial, blocks, f64, nu,
    # sets, pairs, p, q, dim, device, stream
    "pymra_matern_pullback": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _D,
                              _I, _LL, _I, _I, _I, _I, _P],
    # nu, table (null: its size), capacity, err
    "pymra_matern_table": [_D, _P, _I, _P],
    # a, jit, l, ld, f, batch, p, tier, f0, f1, f2, device, stream
    "pymra_cholesky_jittered": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                _I, _P],
    # c, kmask, a_oo, jitter, li, ldp, ldq, fp, fq, batch, p, tier, f0, f1,
    # f2, device, stream
    "pymra_leaf_factor": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _F, _F, _I, _P],
    # c, kmask, li, libar, ldpbar, ldqbar (each of the three or null), fp,
    # jitter, cbar, abar, batch, p, tier, device, stream
    "pymra_leaf_pullback": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I,
                            _I, _I, _P],
    # a, l, batch, p, tier, device, stream
    "pymra_cholesky": [_P, _P, _I, _I, _I, _I, _P],
    # l, x, batch, p, tier, device, stream
    "pymra_tri_inv": [_P, _P, _I, _I, _I, _I, _P],
    # l, x, batch, p, device, stream
    "pymra_tri_inv_wide": [_P, _P, _I, _I, _I, _P],
    # l, b, x, batch, p, q, transpose, tier, cols, device, stream
    "pymra_tri_solve": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # l, lbar, ldbar (or null), f (or null), abar, jbar, batch, p, tier,
    # device, stream
    "pymra_chol_pullback": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, jit, ld, f, batch, p, tier, f0, f1, f2, device, stream
    "pymra_chol_logdet": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
    # a, jit, x, ld, f, batch, p, tier, f0, f1, f2, device, stream
    "pymra_chol_inv_logdet": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                              _I, _P],
    # a, jit (or null), l, ld (or null), f (or null), slabs, batch, p,
    # n_factors, f0, f1, f2, grid, device, stream
    "pymra_chol_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
                        _I, _P],
    # device
    "pymra_chol_wide_grid": [_I],
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


def _sources(pattern: str = "*.cu") -> list[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    return sorted(glob.glob(os.path.join(here, "csrc", pattern)))


def _headers_key() -> str:
    """The shared headers' bytes, part of every library's digest: a source
    that includes an edited header is built anew."""
    key = ""
    for hdr in _sources("*.cuh"):
        with open(hdr) as fh:
            key += fh.read()
    return key


def _build_one(src: str) -> tuple[ctypes.CDLL, str]:
    name = "libpymra_" + os.path.splitext(os.path.basename(src))[0]
    so, log = build_shared_library(name, [src], [nvcc_path()] + NVCC_FLAGS,
                                   timeout=900, key=_headers_key())
    try:
        return ctypes.CDLL(so), log
    except OSError as e:
        raise RuntimeError(f"loading {so} failed: {e}") from e


def load_library() -> types.SimpleNamespace:
    """Build (once per source digest) and load the kernel libraries.

    Returns a namespace holding every entry point of ``_SIGNATURES``. The
    build (or the look-up of built libraries) and the loads are the set-up
    span ``pymra.setup.kernels``.
    Raises ``RuntimeError`` when nvcc is missing or a build or load fails:
    a caller that holds a CUDA tensor gets an error, never a fallback.
    """
    global _LIB, build_log
    if _LIB is not None:  # every launch asks: no lock once loaded
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        nvcc_path()  # fail before starting any build
        srcs = _sources()
        with profiling.setup_span("pymra.setup.kernels"), \
                ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            built = list(pool.map(_build_one, srcs))
        build_log = "".join(log for _, log in built)
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            found = [lib for lib, _ in built if hasattr(lib, name)]
            if len(found) != 1:
                raise RuntimeError(f"kernel entry point {name} found in "
                                   f"{len(found)} libraries, expected 1")
            fn = getattr(found[0], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _LIB = types.SimpleNamespace(**fns)
        return _LIB
