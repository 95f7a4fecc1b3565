"""Readings that the limits of the comparison are set from, for one cell,
in one process on the card:

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3

For each seed the cell's data and sets are drawn as a run draws them, the
program makes the answers of the run's checked calls through the timed
path itself (the same batched call, all ``C`` sets), and the plain float64
reference, with the configuration's jitter, recomputes them: the numbers
a run compares (side ``program``, the "lower" readings). For the first
``--control-seeds`` seeds the control takes the program's place: the same
reference computed in float32 with TF32 matmuls, the step below the
float32 with TF32 off that the configuration states (side ``control``,
the "upper" readings). Prints one JSON line per reading and a summary
line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sets", type=int, default=0,
                   help="check this many sets a seed instead of the mix's")
    p.add_argument("--dump", default="",
                   help="write every set's readings to this JSON-lines file")
    a = p.parse_args(argv)
    rows = []
    for row in readings(a.workload, a.seeds, a.control_seeds, a.first_seed,
                        a.device, a.sets, a.dump):
        print(json.dumps(row), flush=True)
        rows.append(row)
    keys = [k for k in rows[-1] if k not in ("seed", "side", "reference_s")]
    summary = {}
    for side in ("program", "control"):
        for key in keys:
            vals = [r[key] for r in rows if r.get("side") == side]
            if vals:
                summary[f"{side}.{key}"] = {"min": min(vals),
                                            "max": max(vals), "n": len(vals)}
    print(json.dumps({"summary": summary,
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


def readings(workload: str, seeds: int, control_seeds: int,
             first_seed: int = 7_000_000_001, dev: str = "cuda",
             n_sets: int = 0, dump_to: str = ""):
    """Yield the plan's reading, then per seed the program's numbers and,
    for the first ``control_seeds`` seeds, the control's."""
    import numpy as np
    import torch

    from portbench import harness as h
    from portbench.reference.mra import tf32
    from portbench.reference.planner import plan_tree

    spec = h.load_json(h.ROOT, "BENCHMARK.json")
    cell = h.by_name(spec["workloads"], workload, "workload")
    cfg = h.load_json(h.HERE, "configs", cell["config"] + ".json")
    mix = h.load_json(h.HERE, "traffic", cell["traffic"] + ".json")
    kind = h.module("traffic", mix["kind"])
    sets = h.module("traffic", "sets")
    refmod = h.module("reference", cfg["reference"])
    C = int(mix["C"])
    chunk = int(cfg["reference_chunk"])
    model = tree = None
    for k in range(seeds):
        seed = first_seed + 7919 * k
        data_ss, sets_ss, check_ss = h._seeds(seed)
        locs, y = h.module("datasets", cfg["data"]["kind"]).make(
            cfg["data"], data_ss, dev)
        if model is None:
            t = time.perf_counter()
            model = h.build_model(cfg, locs, dev)
            plan_s = time.perf_counter() - t
            t = time.perf_counter()
            tree = plan_tree(locs, cfg["r"], cfg["M"], cfg["J"],
                             seed=cfg["planner_seed"])
            yield {"plan_s": plan_s, "frozen_plan_s": time.perf_counter() - t,
                   "plan_mismatch": h.plan_mismatches(model.plan, tree)}
        runner = kind.Runner(model, y, cfg, dev)
        pool = sets.draw(mix, np.random.default_rng(sets_ss),
                         int(mix["pool_calls"]))
        within = int(mix["check"]["within_calls"])
        picks = np.random.default_rng(check_ss).choice(
            within * C, size=n_sets or int(mix["check"]["sets"]),
            replace=False)
        checks = sorted((int(q) // C, int(q) % C) for q in picks)
        got = []
        for ci in sorted({ci for ci, _ in checks}):
            kept = kind.Runner.keep(runner.call(h._row(pool, ci))[2])
            got += [kind.Runner.pick(kept, c) for cj, c in checks
                    if cj == ci]
            del kept
        del runner
        if dev != "cpu":
            torch.cuda.empty_cache()
        lv = np.array([pool["l"][ci, c] for ci, c in checks])
        sv = np.array([pool["sig"][ci, c] for ci, c in checks])
        t = time.perf_counter()
        want = kind.reference_outputs(
            refmod.Reference(tree, y, cfg["R"], device=dev,
                             jitter=cfg["jitter"]), lv, sv, chunk)
        ref_s = time.perf_counter() - t
        if dump_to:
            dump(dump_to, seed, "program", lv, sv, got, want)
        yield {"seed": seed, "side": "program", "reference_s": ref_s,
               **kind.compare(got, want)}
        if k < control_seeds:
            with tf32(True):
                low = kind.reference_outputs(
                    refmod.Reference(tree, y, cfg["R"], device=dev,
                                     dtype=torch.float32,
                                     jitter=cfg["jitter"]), lv, sv, chunk)
            if dump_to:
                dump(dump_to, seed, "control", lv, sv, low, want)
            yield {"seed": seed, "side": "control", **kind.compare(low, want)}
        if dev != "cpu":
            torch.cuda.empty_cache()


def dump(path, seed, side, lv, sv, got, want):
    """Each set's numbers: the values themselves where they are scalars,
    the largest, 99th-percentile and root-mean-square errors of a map."""
    import numpy as np

    with open(path, "a") as fh:
        for i, (g, w) in enumerate(zip(got, want)):
            row = {"seed": seed, "side": side, "l": float(lv[i]),
                   "sig": float(sv[i])}
            for k, v in w.items():
                if k not in g:
                    continue
                if np.ndim(v) == 0 or np.size(v) <= 4:
                    row[k] = [np.asarray(g[k]).tolist(),
                              np.asarray(v).tolist()]
                else:
                    e = np.abs(g[k] - v) / np.max(np.abs(v))
                    row[k] = {"max": float(e.max()),
                              "p99": float(np.quantile(e, 0.99)),
                              "rms": float(np.sqrt(np.mean(e * e)))}
            fh.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    sys.exit(main())
