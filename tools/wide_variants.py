#!/usr/bin/env python3
"""Where the time of the wide kernels (K8 / KC, ``csrc/chol_wide.cu``; K3
above 64, ``csrc/tri_inv_wide.cu``) goes.

There are no hardware counters on the card's machine (``ncu`` cannot run
there), so this times copies of a kernel with one of its stages left
out, at 4096 x 256 and 64 x 169. Of ``chol_wide.cu``, as K8 (one factor,
no jitter) on healthy members:

* ``shipped``: the kernel as it is (both kernels);
* ``no_chain``: no column steps on the 64-wide diagonal blocks (their
  factor and inverse; the whole-row inverse of a failed block too);
* ``no_downdate``: no float64 downdates of a chunk by the earlier block
  columns' panels (nor their staging through shared memory);
* ``no_panel``: no float64 product of a chunk with L11^-T.

Of ``tri_inv_wide.cu``, on healthy factors:

* ``no_diagonal``: no inversion of the 64-wide diagonal blocks (the core's
  step loop);
* ``no_products``: no block below the diagonal (both products);
* ``no_skip``: the products run every slice, also those whose terms a warp
  knows to be products with zeros above a diagonal block's diagonal.

The left-out stages' outputs are garbage, so only the times mean anything
(K3's variants do not redo a member whose result is not finite). Each copy
is built by nvcc with the package's flags into the git-ignored
``pymra_torch/_build``. Run from the repository root on a machine with an
NVIDIA GPU::

    python3 tools/wide_variants.py
"""
import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymra_torch.ops import BUILD_DIR, build_shared_library  # noqa: E402
from pymra_torch.ops.cuda import build  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.abspath(build.__file__)), "csrc")
#: variant -> (text, replacement) edits of chol_wide.cu, each found once
VARIANTS = {
    "shipped": [],
    "no_chain": [
        ("        for (int j = 0; j < b; ++j) {\n"
         "          const float d = sm.s[j][j]",
         "        for (int j = 0; j < 0; ++j) {\n"
         "          const float d = sm.s[j][j]"),
        ("if (__syncthreads_or(odd)) {", "if (__syncthreads_or(odd) && 0) {")],
    "no_downdate": [("for (int m = 0; m < k; ++m) {",
                     "for (int m = 0; m < 0; ++m) {")],
    "no_panel": [("for (int q = 0; q < b; ++q) {",
                  "for (int q = 0; q < 0; ++q) {")],
}
#: the same for tri_inv_wide.cu; every variant keeps a non-finite result
_K3_KEEP = ("if (__syncthreads_or(bad))", "if (__syncthreads_or(bad) && 0)")
K3_VARIANTS = {
    "shipped": [],
    "no_diagonal": [_K3_KEEP, (
        "    chol_tile::factor<kNB, Mode::kTriInv>(",
        "    if (0) chol_tile::factor<kNB, Mode::kTriInv>(")],
    "no_products": [_K3_KEEP, ("for (int diag = 1; diag < nb; ++diag) {",
                               "for (int diag = nb; diag < nb; ++diag) {")],
    "no_skip": [_K3_KEEP, ("    if (!zeros) {", "    if (true) {")],
}
SHAPES = ((4096, 256), (64, 169))


def variant(kernel, name, edits):
    with open(os.path.join(CSRC, f"{kernel}.cu")) as fh:
        text = fh.read()
    for old, new in edits:
        assert text.count(old) == 1, f"{name}: {old!r} not found once"
        text = text.replace(old, new)
    os.makedirs(os.path.join(BUILD_DIR, "variants"), exist_ok=True)
    path = os.path.join(BUILD_DIR, "variants", f"{kernel}_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    so, _ = build_shared_library(
        f"libvariant_{kernel}_{name}", [path],
        [build.nvcc_path()] + build.NVCC_FLAGS + ["-I", CSRC], timeout=900,
        key=build._headers_key())
    lib = ctypes.CDLL(so)
    for fn in ("pymra_chol_wide", "pymra_chol_wide_grid",
               "pymra_tri_inv_wide"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
    return lib


def k3_main():
    with ThreadPoolExecutor(max_workers=len(K3_VARIANTS)) as pool:
        libs = dict(zip(K3_VARIANTS, pool.map(
            lambda kv: variant("tri_inv_wide", *kv), K3_VARIANTS.items())))
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, p in SHAPES:
        lt = torch.as_tensor(cs.lower_case(rng, b, p), device="cuda")
        out = torch.empty_like(lt)
        line = []
        for name, lib in libs.items():
            def run():
                rc = lib.pymra_tri_inv_wide(lt.data_ptr(), out.data_ptr(), b,
                                            p, 0, stream)
                assert rc == 0, rc
            line.append(f"{name} {cs.time_ms(run):.4f} ms")
        print(f"K3 wide {b}x{p}: " + "; ".join(line), flush=True)


def main():
    cs.phase_device()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: variant("chol_wide", *kv), VARIANTS.items())))
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, p in SHAPES:
        m = torch.as_tensor(cs._spd_batch(rng, b, p).astype(np.float32),
                            device="cuda")
        out = torch.empty_like(m)
        line = []
        for name, lib in libs.items():
            grid = min(b, lib.pymra_chol_wide_grid(0))
            slabs = torch.empty((grid, p, p), dtype=torch.float64,
                                device="cuda")

            def run():
                rc = lib.pymra_chol_wide(
                    m.data_ptr(), None, out.data_ptr(), None, None,
                    slabs.data_ptr(), b, p, 1, 1.0, 1.0, 1.0, grid, 0,
                    stream)
                assert rc == 0, rc
            line.append(f"{name} {cs.time_ms(run):.4f} ms")
        print(f"K8 {b}x{p}: " + "; ".join(line), flush=True)
    k3_main()


if __name__ == "__main__":
    main()
