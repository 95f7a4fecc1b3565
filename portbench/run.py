"""Run one cell of the benchmark of ``pymra_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. Prints the
numbers compared with their limits as the last lines of standard error and
one JSON object as the last line of standard output; exits non-zero, with
no result, where there is no card, too few cards, no program to measure,
or modules of JAX loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from portbench.harness import run

    return run(a.workload, a.seed, a.seconds, bool(a.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
