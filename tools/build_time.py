#!/usr/bin/env python3
"""Cold build time of the CUDA kernels: one ``nvcc`` per source, all at
once (what ``pymra_torch/ops/cuda/build.py`` does), against one ``nvcc``
over every source into a single library.

Each build goes into a fresh temporary directory, so nothing is cached;
the two ways alternate, ``--reps`` times each. Run from the repository
root on a machine with ``nvcc``::

    python3 tools/build_time.py [--reps 2]
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pymra_torch.ops as ops  # noqa: E402
from pymra_torch.ops.cuda import build  # noqa: E402


def per_source() -> float:
    build._LIB = None
    t0 = time.perf_counter()
    build.load_library()
    return time.perf_counter() - t0


def one_library() -> float:
    t0 = time.perf_counter()
    so, _ = ops.build_shared_library(
        "libpymra_all", build._sources(), [build.nvcc_path()]
        + build.NVCC_FLAGS, timeout=900)
    lib = ctypes.CDLL(so)
    missing = [n for n in build._SIGNATURES if not hasattr(lib, n)]
    if missing:
        raise SystemExit(f"single library lacks {missing}")
    return time.perf_counter() - t0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; {os.cpu_count()} CPU cores; "
          f"{len(build._sources())} sources")
    times = {"one nvcc per source, in parallel": [],
             "one nvcc, one library": []}
    root = ops.BUILD_DIR
    os.makedirs(root, exist_ok=True)
    for _ in range(args.reps):
        for name, fn in (("one nvcc, one library", one_library),
                         ("one nvcc per source, in parallel", per_source)):
            with tempfile.TemporaryDirectory(dir=root) as tmp:
                ops.BUILD_DIR = tmp
                times[name].append(fn())
    ops.BUILD_DIR = root
    for name, ts in times.items():
        print(f"{name}: " + ", ".join(f"{t:.2f} s" for t in ts))


if __name__ == "__main__":
    main()
