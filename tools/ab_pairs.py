#!/usr/bin/env python3
"""Alternating pairs of ``tools/profile_gradient.py`` runs on two trees.

Runs each tree's own ``tools/profile_gradient.py`` (one process per run, so
each builds, plans and warms up as a user's process does) in ``--pairs``
pairs, alternating which tree runs first, on one GPU; then prints, per
cell and metric, each tree's median over its runs of the per-run medians,
the quartiles of those, and how many pairs each tree won. Run from the
repository root on a machine with an NVIDIA GPU::

    python3 tools/ab_pairs.py PARENT_DIR CHANGE_DIR [--pairs 10]
        [--cells n1m] [--reps 3] [--budget-s 2400] [--out DIR]

``--budget-s`` stops starting new pairs once that many seconds have gone.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

METRICS = ("ms_forward", "ms_value_and_grad", "ms_value_and_grad_host_params")


def run(tree, tag, args):
    out = os.path.join(os.path.abspath(args.out), f"{tag}.json")
    log = os.path.join(os.path.abspath(args.out), f"{tag}.txt")
    with open(log, "w") as fh:
        rc = subprocess.run(
            [sys.executable, "tools/profile_gradient.py", "--cells",
             args.cells, "--reps", str(args.reps), "--out", out],
            cwd=tree, stdout=fh, stderr=subprocess.STDOUT).returncode
    if rc:
        raise SystemExit(f"ab_pairs: {tag} exited {rc}, see {log}")
    with open(out) as fh:
        return json.load(fh)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--cells", default="n1m")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--budget-s", type=float, default=2400.0)
    parser.add_argument("--out", default="chiprun_out/ab_pairs")
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.monotonic()
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        if time.monotonic() - t0 > args.budget_s:
            print(f"budget spent after {i} pairs")
            break
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            runs[side].append(run(getattr(args, side), f"{side}{i}", args))
        print(f"pair {i} ({order[0]} first) done at "
              f"{time.monotonic() - t0:.0f} s", flush=True)
    summary = {"card": runs["parent"][0]["card"], "pairs": len(runs["change"])}
    print(summary["card"])
    for cell in (k for k in runs["parent"][0] if k != "card"):
        for metric in METRICS:
            per = {side: [r[cell][metric]["median"] for r in rs]
                   for side, rs in runs.items()}
            wins = sum(c < p for p, c in zip(per["parent"], per["change"]))
            row = {"change_wins": wins}
            for side, xs in per.items():
                q1, med, q3 = np.percentile(xs, [25, 50, 75])
                row[side] = {"median": float(med), "q1": float(q1),
                             "q3": float(q3), "runs": xs}
            summary[f"{cell} {metric}"] = row
            print(f"{cell} {metric}: parent {row['parent']['median']:.3f} "
                  f"(IQR {row['parent']['q1']:.3f}-{row['parent']['q3']:.3f})"
                  f", change {row['change']['median']:.3f} (IQR "
                  f"{row['change']['q1']:.3f}-{row['change']['q3']:.3f}); "
                  f"change faster in {wins} of {len(per['change'])} pairs")
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)


if __name__ == "__main__":
    main()
