#!/usr/bin/env python3
"""Where a call of K2 ``cholesky_jittered`` spends its host time on the card.

At the main path's interior shapes (``chip_smoke.CHOL_MAIN``: 64 x 4 and
4096 x 8) a launch lasts a few microseconds on the device, so a call's
time is the host's: the wrapper's Python, the autograd Function, the
allocations, the stream lookup and the ctypes binding. This tool times each
of those steps alone with the host clock (``time.perf_counter``), 1000
calls a round after a warm-up, the median of 5 rounds, in microseconds a
call, on ``chip_smoke.clean_case`` inputs; beside them the whole call (also
by CUDA events over 1000 calls, as ``chip_smoke.time_ms`` times 10) and
the library yardstick ``chip_smoke._library_factor``. Steps that launch
synchronize at the end of each round. Alternatives of a step (the stream
lookup, the allocation of ``ld`` and ``f``) are timed side by side, so the
table also says what a cut would save.

Run from the root of a tree on a machine with an NVIDIA GPU::

    python3 tools/host_path.py [--out FILE] [--calls N]

The wrapper timed is the package of the working directory's tree;
``chip_smoke``'s helpers are those of the tree this tool lies in, so one
call can time two trees on the same card: run it from the older tree's
root as ``python3 NEWER/tools/host_path.py``.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# chip_smoke imports the package only when a phase runs: from here on,
# the working directory's
sys.path.insert(0, os.getcwd())

ROUNDS = 5


def host_us(fn, calls: int, sync: bool) -> float:
    """Median over ``ROUNDS`` rounds of ``calls`` calls of ``fn`` of the
    host clock's microseconds a call (with ``sync``, each round ends in a
    synchronization and includes it)."""
    import torch

    for _ in range(max(10, calls // 20)):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if sync:
            torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(per)


def steps(b: int, p: int) -> list:
    """(label, callable, whether it launches) of every step of a K2 call
    at (b, p)."""
    import torch

    from pymra_torch.ops import linalg as tl
    from pymra_torch.ops.cuda import build

    rng = np.random.default_rng(1)
    m, jit = (torch.as_tensor(x, device="cuda")
              for x in cs.clean_case(rng, b, p))
    mg = m.clone().requires_grad_()
    eye = torch.eye(p, device="cuda")
    batch = m.shape[:-2]
    lib = build.load_library()
    fn = lib.pymra_cholesky_jittered
    out = torch.empty_like(m)
    ld, f = torch.empty_like(jit), torch.empty_like(jit)
    dev = m.get_device()
    stream = torch.cuda.current_stream(m.device).cuda_stream
    # the parent's entry point has no width tier (12 arguments)
    tier = ([tl.jittered_tier(p)] if len(fn.argtypes) == 13 else [])
    args = ([m.data_ptr(), jit.data_ptr(), out.data_ptr(), ld.data_ptr(),
             f.data_ptr(), b, p] + tier + list(tl.FACTORS) + [dev, stream])
    cargs = [t(v) for t, v in zip(fn.argtypes, args)]

    def checks():
        tl._check_square("cholesky_jittered: mat", m)
        tl._check("cholesky_jittered: mat", m, m.shape, m.device)
        tl._check("cholesky_jittered: jit", jit, batch, m.device)
        tl._factors(tl.FACTORS)

    def pointers():
        return (m.data_ptr(), jit.data_ptr(), out.data_ptr(), ld.data_ptr(),
                f.data_ptr())

    def unpacked():
        a, c = torch.empty((2,) + batch, dtype=m.dtype, device=m.device)
        return a, c

    return [
        ("call", lambda: tl.cholesky_jittered(m, jit), True),
        ("call, mat requires grad (the gradient path)",
         lambda: tl.cholesky_jittered(mg, jit), True),
        ("forward alone, no autograd Function",
         lambda: tl._cholesky_jittered_fwd(m, jit, tl.FACTORS), True),
        ("library call (chip_smoke._library_factor)",
         lambda: cs._library_factor(m, jit, eye), True),
        ("build.load_library", build.load_library, False),
        ("checks: _check_square, _check x2, _factors", checks, False),
        ("allocation: empty_like(mat)", lambda: torch.empty_like(m), False),
        ("allocation: ld, f as one [2, B] tensor unpacked", unpacked, False),
        ("allocation: ld, f as empty_like(jit) x2",
         lambda: (torch.empty_like(jit), torch.empty_like(jit)), False),
        ("stream: the tree's _where", lambda: tl._where(m), False),
        ("stream: current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(m.device).cuda_stream, False),
        ("stream: _cuda_getCurrentRawStream(index)",
         lambda: torch._C._cuda_getCurrentRawStream(dev), False),
        ("data_ptr x5", pointers, False),
        ("launch: ctypes call, Python ints (conversion, use_device, "
         "cudaLaunchKernel)", lambda: fn(*args), True),
        ("launch: ctypes call, ctypes objects", lambda: fn(*cargs), True),
    ]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the table as JSON here")
    parser.add_argument("--calls", type=int, default=1000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("host_path: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.phase_device()
    res = {"card": card, "tree": os.getcwd()}
    for b, p in cs.CHOL_MAIN:
        timed = steps(b, p)
        rows = {label: host_us(fn, args.calls, sync)
                for label, fn, sync in timed}
        named = {label: fn for label, fn, _ in timed}
        for label in ("call", "library call (chip_smoke._library_factor)"):
            rows[label + ", CUDA events"] = cs.time_ms(named[label],
                                                       args.calls) * 1e3
        res[f"{b}x{p}x{p}"] = rows
        print(f"== K2 cholesky_jittered B={b} P={p}: host us a call")
        for label, us in rows.items():
            print(f"  {us:9.2f}  {label}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
