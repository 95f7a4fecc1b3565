#!/usr/bin/env python3
"""Where the time of the wide kernel (K8 / KC, ``csrc/chol_wide.cu``) goes.

There are no hardware counters on the card's machine (``ncu`` cannot run
there), so this times copies of the kernel with one of its stages left
out, as K8 (one factor, no jitter) on healthy members at 4096 x 256 and
64 x 169:

* ``shipped``: the kernel as it is;
* ``no_chain``: no column steps on the 64-wide diagonal blocks (their
  factor and inverse; the whole-row inverse of a failed block too);
* ``no_downdate``: no float64 downdates of a chunk by the earlier block
  columns' panels (nor their staging through shared memory);
* ``no_panel``: no float64 product of a chunk with L11^-T.

The left-out stages' outputs are garbage, so only the times mean anything.
Each copy is built by nvcc with the package's flags into the git-ignored
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
SHAPES = ((4096, 256), (64, 169))


def variant(name):
    with open(os.path.join(CSRC, "chol_wide.cu")) as fh:
        text = fh.read()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, f"{name}: {old!r} not found once"
        text = text.replace(old, new)
    os.makedirs(os.path.join(BUILD_DIR, "variants"), exist_ok=True)
    path = os.path.join(BUILD_DIR, "variants", f"chol_wide_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    so, _ = build_shared_library(
        f"libvariant_chol_wide_{name}", [path],
        [build.nvcc_path()] + build.NVCC_FLAGS + ["-I", CSRC], timeout=900,
        key=build._headers_key())
    lib = ctypes.CDLL(so)
    lib.pymra_chol_wide.argtypes = build._SIGNATURES["pymra_chol_wide"]
    lib.pymra_chol_wide_grid.argtypes = build._SIGNATURES[
        "pymra_chol_wide_grid"]
    return lib


def main():
    cs.phase_device()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(variant, VARIANTS)))
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


if __name__ == "__main__":
    main()
