#!/usr/bin/env python3
"""Kernel timings of ``chip_smoke.py`` alone, for comparing two trees on one
card in one call.

Runs phases 1-3 of ``chip_smoke.py`` (device, build, every kernel against
its twin, timed per call and on the device beside its library call and
bound) and times the backward of ``cholesky_jittered`` as the sweep calls
it, at the interior blocks' shapes; with ``--backward`` also phase 3b,
with ``--n10k`` phase 4 (the N=10^4 objective against its golden). Run
from the root of the tree to time (its ``chip_smoke.py`` and package
are the ones imported) on a machine with an NVIDIA GPU::

    python3 tools/kernel_timing.py [--backward] [--n10k]

"""
import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backward", action="store_true",
                        help="also run phase 3b")
    parser.add_argument("--n10k", action="store_true",
                        help="also run phase 4")
    args = parser.parse_args()
    cs.phase_device()
    cs.phase_build()
    cs.phase_kernels()
    rng = np.random.default_rng(1)
    for b, p in cs.CHOL_MAIN:
        m, jit = cs.chol_case(rng, b, p)
        lbar = rng.standard_normal(m.shape).astype(np.float32)
        t = cs.time_backward(m, jit, lbar, "cuda", cs.time_ms, cs.device_ms)
        print(f"K2 backward B={b} P={p}: {t}")
    if args.backward:
        cs.phase_backward()
    if args.n10k:
        cs.phase_n10k()


if __name__ == "__main__":
    main()
