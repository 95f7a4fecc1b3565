#!/usr/bin/env python3
"""Register budget of the register-tiled K1, K4, K3 and K2 kernels against
their speed: each kernel rebuilt with ``__launch_bounds__(64, N)`` for
several N (at least N resident 64-thread blocks an SM, so at most 65536 /
(64 N) registers a thread), timed at 16384 x 64 beside the shipped build
(whose own bound is left as it is); K3's wide kernel (256-thread blocks,
the core on its diagonal blocks) likewise with ``--wide-blocks`` at 4096 x
256.

Each variant is a copy of ``csrc/leaf_factor.cu``, ``csrc/cholesky.cu``,
``csrc/tri_inv.cu``, ``csrc/cholesky_jittered.cu`` (its core kernel, on
``chip_smoke.chol_case``) or ``csrc/tri_inv_wide.cu`` with only the launch
bound
changed, built by nvcc with the package's flags
into the git-ignored ``pymra_torch/_build``. Prints the compiler's register
and spill report and the ms per call (CUDA events, as
``chip_smoke.time_ms``) of each, and holds each variant's outputs to the
shipped kernel's (they run the same arithmetic). Run from the repository
root on a machine with an NVIDIA GPU::

    python3 tools/tile_variants.py [--blocks 8,10,12] [--wide-blocks 1,3]
                                   [--k2-inline]

With ``--k2-inline`` it also builds K2 with its attempt inlined into the
escalation loop (``__forceinline__`` for the shipped ``__noinline__``), at
each bound.

With ``--scales quotient,division,reciprocal`` it builds instead, at the
shipped launch bound, copies whose ``csrc/chol_tile.cuh`` scales each
column otherwise: ``quotient`` as shipped (the reciprocal's FMA-corrected
quotient), ``division`` IEEE division by the pivot, ``reciprocal`` the
product with its reciprocal; each copy's body of ``quotient`` is replaced
by the text in ``SCALES``. It says of each build whether its outputs are
bit-identical to the division build's.
"""
import argparse
import ctypes
import os
import re
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
BOUND_RE = re.compile(r"__launch_bounds__\(kThreads(, \d+)?\)")
#: the body of chol_tile.cuh's quotient(x, den, r)
QUOTIENT_RE = re.compile(r"(float quotient\([^)]*\) \{\n)(.*?)(\n\})", re.S)
#: column scale -> body of quotient (None: as shipped)
SCALES = {"quotient": None, "division": "  return x / den;",
          "reciprocal": "  return x * r;"}
B, P = 16384, 64
WIDE_B, WIDE_P = 4096, 256
#: the sources built with --blocks (and --scales: all include the core)
TILED = ("leaf_factor.cu", "cholesky.cu", "tri_inv.cu",
         "cholesky_jittered.cu")


def variant(src, blocks, scale=None, inline=False):
    """Build ``src`` with at least ``blocks`` blocks an SM (None: as
    shipped), the core's column scale ``scale`` (a key of ``SCALES``;
    None: as shipped) and, with ``inline``, K2's attempt inlined; returns
    (library, ptxas report)."""
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    assert len(BOUND_RE.findall(text)) == 1, f"{src}: no single bound"
    if blocks is not None:
        text = BOUND_RE.sub(f"__launch_bounds__(kThreads, {blocks})", text)
    tag = f"{os.path.splitext(src)[0]}_mb{blocks or 0}"
    if inline:
        assert text.count("__noinline__") == 1, f"{src}: no single attempt"
        text = text.replace("__noinline__", "__forceinline__")
        tag += "_inline"
    header = ""
    if scale is not None:
        tag += f"_{scale}"
        with open(os.path.join(CSRC, "chol_tile.cuh")) as fh:
            header = fh.read()
        assert len(QUOTIENT_RE.findall(header)) == 1, "no single quotient"
        if SCALES[scale] is not None:
            header = QUOTIENT_RE.sub(
                lambda m: m.group(1) + SCALES[scale] + m.group(3), header)
    # a directory a variant: its own chol_tile.cuh is found first, beside
    # the source that includes it
    where = os.path.join(BUILD_DIR, "variants", tag)
    os.makedirs(where, exist_ok=True)
    path = os.path.join(where, src)
    with open(path, "w") as fh:
        fh.write(text)
    if header:
        with open(os.path.join(where, "chol_tile.cuh"), "w") as fh:
            fh.write(header)
    so, log = build_shared_library(
        "libvariant_" + tag, [path],
        [build.nvcc_path()] + build.NVCC_FLAGS + ["-I", CSRC], timeout=900,
        key=build._headers_key() + header)
    # the report of the 64-wide instantiation (NB = 8; not K2's sub-warp
    # group of 8 lanes; K2's attempt function too), or of the wide kernel:
    # its stack and register lines after its entry
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if ("Compiling entry" in ln or "Function properties" in ln)
          and "group" not in ln
          and ("ILi8E" in ln or "tri_inv_wide_kernel" in ln)]
    report = [ln.split("info    :")[-1].strip()
              for i in at for ln in lines[i + 1:i + 4]
              if "stack frame" in ln or "Used" in ln]
    return ctypes.CDLL(so), report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blocks", default="8,10,12")
    parser.add_argument("--wide-blocks", default="1,3")
    parser.add_argument("--k2-inline", action="store_true")
    parser.add_argument("--scales", default="",
                        help="column scales to build instead, of "
                        + ", ".join(SCALES))
    args = parser.parse_args()
    blocks = [None] + [int(x) for x in args.blocks.split(",")]
    wide_blocks = [None] + [int(x) for x in args.wide_blocks.split(",")]
    cs.phase_device()
    jobs = [(src, n, None) for src in TILED for n in blocks] + [
        ("tri_inv_wide.cu", n, None) for n in wide_blocks]
    if args.k2_inline:
        jobs += [("cholesky_jittered.cu", n, None, True) for n in blocks]
    if args.scales:
        jobs = [(src, None, sc) for src in TILED
                # the division build first: the others are held to it
                for sc in sorted(args.scales.split(","),
                                 key=lambda x: x != "division")]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: variant(*j), jobs)))

    rng = np.random.default_rng(0)
    c, k, a = (torch.as_tensor(x, device="cuda")
               for x in cs.leaf_case(rng, B, P, escalate=True, hard=True))
    m, jit = (torch.as_tensor(x, device="cuda")
              for x in cs.chol_case(rng, B, P))
    low = torch.as_tensor(cs.lower_case(rng, B, P), device="cuda")
    wide = torch.as_tensor(cs.lower_case(rng, WIDE_B, WIDE_P), device="cuda")
    want_leaf = tl.leaf_factor(c, k, a, 1e-3)
    want_chol = tl.cholesky(m)
    want_inv = tl.triangular_inverse_lower(low)
    want_wide = tl.triangular_inverse_lower(wide)
    want_jittered = tl.cholesky_jittered(m, jit)
    stream = torch.cuda.current_stream().cuda_stream
    tier = tl.tile_tier(P)
    divided = {}
    for (src, n, sc, *inline), (lib, report) in libs.items():
        shape = f"{B}x{P}"
        if src == "leaf_factor.cu":
            fn = lib.pymra_leaf_factor
            fn.argtypes = build._SIGNATURES["pymra_leaf_factor"]
            outs = [torch.empty_like(c)] + [
                torch.empty(B, device="cuda") for _ in range(4)]

            def run():
                rc = fn(c.data_ptr(), k.data_ptr(), a.data_ptr(), 1e-3,
                        *[o.data_ptr() for o in outs], B, P, tier,
                        *tl.FACTORS, 0, stream)
                assert rc == 0, rc
            want, fidx = want_leaf, {3, 4}
        elif src == "tri_inv.cu":
            fn = lib.pymra_tri_inv
            fn.argtypes = build._SIGNATURES["pymra_tri_inv"]
            outs = [torch.empty_like(low)]

            def run():
                rc = fn(low.data_ptr(), outs[0].data_ptr(), B, P, tier, 0,
                        stream)
                assert rc == 0, rc
            want, fidx = (want_inv,), set()
        elif src == "tri_inv_wide.cu":
            fn = lib.pymra_tri_inv_wide
            fn.argtypes = build._SIGNATURES["pymra_tri_inv_wide"]
            outs = [torch.empty_like(wide)]
            shape = f"{WIDE_B}x{WIDE_P}"

            def run():
                rc = fn(wide.data_ptr(), outs[0].data_ptr(), WIDE_B, WIDE_P,
                        0, stream)
                assert rc == 0, rc
            want, fidx = (want_wide,), set()
        elif src == "cholesky_jittered.cu":
            fn = lib.pymra_cholesky_jittered
            fn.argtypes = build._SIGNATURES["pymra_cholesky_jittered"]
            outs = [torch.empty_like(m)] + [
                torch.empty(B, device="cuda") for _ in range(2)]

            def run():
                rc = fn(m.data_ptr(), jit.data_ptr(),
                        *[o.data_ptr() for o in outs], B, P, tier,
                        *tl.FACTORS, 0, stream)
                assert rc == 0, rc
            want, fidx = want_jittered, {2}
        else:
            fn = lib.pymra_cholesky
            fn.argtypes = build._SIGNATURES["pymra_cholesky"]
            outs = [torch.empty_like(m)]

            def run():
                rc = fn(m.data_ptr(), outs[0].data_ptr(), B, P, tier, 0,
                        stream)
                assert rc == 0, rc
            want, fidx = (want_chol,), set()
        run()
        torch.cuda.synchronize()
        if sc is None:
            err = cs.compare(f"{src} min blocks {n}", outs, want,
                             factor_idx=fidx)
        else:
            # another rounding of the column: near a failing pivot the
            # factor differs by more than the twin tolerance
            err = max(float((o - w).abs().nan_to_num(0.0).max())
                      for o, w in zip(outs, want))
        ms = cs.time_ms(run)
        same = ""
        if sc is not None:
            mine = [o.clone() for o in outs]
            if sc == "division":
                divided[src] = mine
            if src in divided:
                same = "; bit-identical to the division build: " + str(all(
                    torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
                    for x, y in zip(mine, divided[src])))
        if inline:
            src += " (attempt inlined)"
        print(f"{src} min blocks {n} column scale {sc}: {ms:.4f} ms at "
              f"{shape}, max|diff| vs shipped {err:.3g}{same}; "
              f"{' | '.join(report)}", flush=True)


if __name__ == "__main__":
    main()
