#!/usr/bin/env python3
"""Where the time of KP's pullback mode goes (``chol_tile.cuh``'s
``pullback``, launched by ``tri_solve.cu`` at 9 <= P <= 64): the kernel
rebuilt with one change at a time and timed beside the shipped build, for
cards where no hardware profiler runs.

Each variant is a copy of ``csrc/tri_solve.cu`` and ``csrc/chol_tile.cuh``
with the text edits of ``VARIANTS`` (each edit must match exactly once),
built by nvcc with the package's flags into the git-ignored
``pymra_torch/_build``. Variants that compute the same pullback are held
to the shipped build's output (``chip_smoke.compare``); those that leave a
stage out (``no_*``) are timed only. Prints, per variant, the compiler's
register and stack report of the 64-wide instantiation, its size in SASS
instructions (``cuobjdump -sass``) and the ms per
launch (CUDA events over 20 launches after a warm-up, as
``chip_smoke.time_ms``) at 256 x 49 and 16384 x 64 on phase 3b's inputs
(``chip_smoke.chol_case``'s factors, random cotangents). Run from the
repository root on a machine with an NVIDIA GPU::

    python3 tools/pullback_variants.py [--only NAME,...]
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymra_torch.ops import BUILD_DIR, build_shared_library  # noqa: E402
from pymra_torch.ops import linalg as tl  # noqa: E402
from pymra_torch.ops.cuda import build  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.abspath(build.__file__)), "csrc")
SHAPES = ((256, 49), (16384, 64))
#: the pullback kernel's launch bound in tri_solve.cu
BOUND = ("__launch_bounds__(kThreads)\n    chol_pullback_tile(")
LDG = [("? l[i * p + k] : 0.f;", "? __ldg(l + i * p + k) : 0.f;"),
       ("v = lbar[i * p + k];", "v = __ldg(lbar + i * p + k);")]
STORE_UNROLL = ("    if (tid < p) {\n      for (int i = 0; i < p; ++i)",
                "    if (tid < p) {\n#pragma unroll 4\n"
                "      for (int i = 0; i < p; ++i)")
#: name -> ({file: [(old, new), ...]}, computes the same pullback)
VARIANTS = {
    "shipped": ({}, True),
    # the sweeps' scale by the reciprocal's product (an ulp off): the
    # quotient's share of a step
    "reciprocal": ({"chol_tile.cuh": [
        ("pt.x[bn][b] = quotient(pt.x[bn][b] * sc, d, r);",
         "pt.x[bn][b] = pt.x[bn][b] * sc * r;"),
        ("pt.x[a][bn] = quotient(pt.x[a][bn] * sc, d, r);",
         "pt.x[a][bn] = pt.x[a][bn] * sc * r;")]}, False),
    # X's sweep without its multiply-subtracts: their share
    "no_fma_rows": ({"chol_tile.cuh": [
        ("pt.x[a][b] = fmaf(-lv[a], xv[b], pt.x[a][b]);",
         "pt.x[a][b] = pt.x[a][b];")]}, False),
    # the 8 steps of each block unrolled (the compiler's choice without
    # the pragma)
    "unrolled_steps": ({"chol_tile.cuh": [
        ("#pragma unroll 1\n  for (int tc = 0;", "  for (int tc = 0;"),
        ("#pragma unroll 1\n  for (int v = 0; v < kGrid; ++v) {\n"
         "    const int jc", "  for (int v = 0; v < kGrid; ++v) {\n"
         "    const int jc"),
        ("#pragma unroll 1\n  for (int v = 0; v < kGrid; ++v) {\n"
         "    const int tc", "  for (int v = 0; v < kGrid; ++v) {\n"
         "    const int tc")]}, True),
    # L and Lbar read through the read-only path (the loads then need not
    # wait for the stores of L into shared memory)
    "ldg": ({"chol_tile.cuh": LDG}, True),
    # the output rows written four at a time
    "store_unroll": ({"chol_tile.cuh": [STORE_UNROLL]}, True),
    # at least N blocks an SM (registers capped at 65536 / (64 N))
    "blocks_10": ({"tri_solve.cu": [
        (BOUND, BOUND.replace("(kThreads)", "(kThreads, 10)"))]}, True),
    "blocks_12": ({"tri_solve.cu": [
        (BOUND, BOUND.replace("(kThreads)", "(kThreads, 12)"))]}, True),
    # a stage left out: its share of the time
    "no_product": ({"chol_tile.cuh": [
        ("  pb_product<NB, 0>(team, buf, p);\n", "")]}, False),
    "no_rows": ({"chol_tile.cuh": [
        ("  pb_rows<NB, 0>(team, buf, p);\n", "")]}, False),
    "no_cols": ({"chol_tile.cuh": [
        ("  pb_cols<NB, 0>(team, buf, p);\n", "")]}, False),
    # the block's barriers left out (wrong results): the barriers' share
    "no_sync": ({"tri_solve.cu": [
        ("  __device__ __forceinline__ void sync() { __syncthreads(); }",
         "  __device__ __forceinline__ void sync() {}")]}, False),
}


def sass_size(so, key):
    """Instructions of the kernel whose name holds ``key`` in the library
    ``so`` (``cuobjdump -sass``), or None without the tool."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         timeout=300).stdout
    for part in out.split("Function : ")[1:]:
        if part.split(None, 1)[0].find(key) >= 0:
            return len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
    return None


def variant(name):
    """Build the variant ``name``; returns (its pymra_chol_pullback, the
    ptxas report of chol_pullback_tile<8>)."""
    edits, _ = VARIANTS[name]
    where = os.path.join(BUILD_DIR, "pullback_variants", name)
    os.makedirs(where, exist_ok=True)
    for src in ("tri_solve.cu", "chol_tile.cuh", "subwarp.cuh"):
        with open(os.path.join(CSRC, src)) as fh:
            text = fh.read()
        for old, new in edits.get(src, ()):
            assert text.count(old) == 1, f"{name}: {old!r} not once in {src}"
            text = text.replace(old, new)
        with open(os.path.join(where, src), "w") as fh:
            fh.write(text)
    headers = "".join(open(os.path.join(where, h)).read()
                      for h in ("chol_tile.cuh", "subwarp.cuh"))
    so, log = build_shared_library(
        "libpullback_" + name, [os.path.join(where, "tri_solve.cu")],
        [build.nvcc_path()] + build.NVCC_FLAGS, timeout=900, key=headers)
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry" in ln and "chol_pullback_tileILi8E" in ln]
    report = [ln.split("info    :")[-1].strip()
              for i in at for ln in lines[i + 1:i + 3]
              if "stack frame" in ln or "Used" in ln]
    report.append(f"{sass_size(so, 'chol_pullback_tileILi8E')} SASS "
                  "instructions")
    fn = ctypes.CDLL(so).pymra_chol_pullback
    fn.argtypes = build._SIGNATURES["pymra_chol_pullback"]
    fn.restype = ctypes.c_int
    return fn, report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="variants to build, of " + ", ".join(VARIANTS))
    args = parser.parse_args()
    names = ["shipped"] + [n for n in (args.only.split(",") if args.only
                                       else VARIANTS) if n != "shipped"]
    cs.phase_device()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(variant, names)))
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, p in SHAPES:
        m, jit = (torch.as_tensor(x, device="cuda")
                  for x in cs.chol_case(rng, b, p))
        l, _, f = tl.cholesky_jittered(m, jit)
        lbar = torch.randn(b, p, p, device="cuda")
        ldbar = torch.randn(b, device="cuda")
        want = None
        for name in names:
            fn, report = libs[name]
            abar, jbar = torch.empty_like(l), torch.empty_like(f)

            def run():
                rc = fn(l.data_ptr(), lbar.data_ptr(), ldbar.data_ptr(),
                        f.data_ptr(), abar.data_ptr(), jbar.data_ptr(), b,
                        p, tl.tile_tier(p), 0, stream)
                assert rc == 0, rc
            run()
            torch.cuda.synchronize()
            check = ""
            if name == "shipped":
                want = (abar.clone(), jbar.clone())
            elif VARIANTS[name][1]:
                err = cs.compare(f"{name} {b}x{p}", (abar, jbar), want,
                                 per_member=True)
                check = f", max|diff| vs shipped {err:.3g}"
            ms = cs.time_ms(run, reps=20)
            print(f"{name} {b}x{p}x{p}: {ms:.4f} ms a launch{check}; "
                  f"{' | '.join(report)}", flush=True)


if __name__ == "__main__":
    main()
