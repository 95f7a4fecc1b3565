"""One run of one benchmark cell of ``pymra_torch``.

Everything that belongs to one cell is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json`` (its data maker
``datasets/<kind>.py`` and its plain reference ``reference/<name>.py``),
the traffic mix ``traffic/<traffic>.json`` (read by the general generator
``traffic/sets.py`` and run by its kind, ``traffic/<kind>.py``), the
limits of the comparison ``limits/<cell>.json``, and each metric's reader
``metrics/<name before the first dot>.py``. A new cell, configuration,
traffic mix or metric is new files and entries.

A run: set-up (the data from the seed, the model's plan and upload, the
parameter sets drawn before the window, the warm-up calls of the cell's own
shapes), then a closed loop of calls for ``--seconds`` (each call starts
when the previous one's results are back), then with ``--trace 1`` a
profiled stretch of a few more calls, then the check: the program's state is
freed, the tree is planned again by the frozen planner and held to the
program's, and the plain reference recomputes a sample of the window's
answers, drawn from the seed, to compare them. Last, once every module the
run imports is loaded, a run that holds a module of JAX or of the JAX
package ends with no result.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time

import numpy as np

__all__ = ["run", "forbidden_modules", "ROOT"]

#: the checkout's root: the directory that holds ``BENCHMARK.json``
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pymra_tpu")


class RunError(Exception):
    """A run that cannot go on; the message goes to standard error."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(*parts) -> dict:
    path = os.path.join(*parts)
    if not os.path.isfile(path):
        raise RunError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def module(package: str, name: str):
    """``portbench.<package>.<name>``, the file ``<package>/<name>.py``."""
    if not os.path.isfile(os.path.join(HERE, package, name + ".py")):
        raise RunError(f"missing file portbench/{package}/{name}.py")
    return importlib.import_module(f"portbench.{package}.{name}")


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def build_model(cfg: dict, locs, device):
    """The system under test: the port's planned model on the card."""
    import torch

    from pymra_torch import MRAModel, PlanConfig

    r, M, J = cfg["r"], cfg["M"], cfg["J"]
    return MRAModel(
        locs, r=r, M=M, J=J, dtype=getattr(torch, cfg["dtype"]),
        jitter=cfg["jitter"], device=device,
        config=PlanConfig(r=r, M=M, J=J, seed=cfg["planner_seed"],
                          kmeans_impl="native"))


def plan_mismatches(plan, tree) -> int:
    """Nodes whose level, partition or knots differ between the program's
    plan and the frozen planner's tree (0 when they are the same tree)."""
    bad = abs(len(plan.levels) - len(tree.levels))
    for g, nodes in zip(plan.levels, tree.levels):
        ints = [nd for nd in nodes if not nd.leaf]
        leaves = [nd for nd in nodes if nd.leaf]
        bad += abs(g.n_int - len(ints)) + abs(g.n_leaf - len(leaves))
        for i, nd in enumerate(ints[:g.n_int]):
            bad += not np.array_equal(np.asarray(g.int_knot_gidx[i]),
                                      nd.knots)
        for i, nd in enumerate(leaves[:g.n_leaf]):
            mask = np.asarray(g.leaf_loc_mask[i], dtype=bool)
            row = np.asarray(g.leaf_loc_gidx[i])[mask]
            own = row[np.asarray(g.leaf_is_knot[i], dtype=bool)[mask]]
            bad += not (np.array_equal(row, nd.locs)
                        and np.array_equal(own, nd.knots))
    return int(bad)


def tree_shape(tree) -> dict:
    """Per-level counts of the tree, for the yardstick's counts."""
    levels = []
    for m, nodes in enumerate(tree.levels):
        leaves = [nd for nd in nodes if nd.leaf]
        per_parent = {}
        for nd in leaves:
            per_parent[id(nd.parent)] = per_parent.get(id(nd.parent), 0) + 1
        counts = set(per_parent.values())
        levels.append({
            "n_int": sum(1 for nd in nodes if not nd.leaf),
            "n_leaf": len(leaves),
            "P": max((len(nd.locs) for nd in leaves), default=0),
            "c": counts.pop() if len(counts) == 1 else 0})
    return {"r": tree.r, "M": tree.M, "levels": levels}


def _seeds(seed: int):
    import numpy.random as npr

    return npr.SeedSequence(seed % (1 << 64)).spawn(3)


def _row(pool: dict, i: int) -> dict:
    n = len(next(iter(pool.values())))
    return {k: v[i % n] for k, v in pool.items()}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None, fault=None,
        out=sys.stdout, err=sys.stderr) -> int:
    """Run one cell once and print its result line; returns the exit code.

    ``device="cpu"`` and ``fault`` are for the tests: the CPU path skips
    the look for a card, and ``fault(runner)`` breaks the timed path."""
    t0 = time.perf_counter() if t0 is None else t0
    try:
        return _run(workload, seed, seconds, trace, device, t0, fault, out,
                    err)
    except RunError as e:
        print(f"portbench: {e}", file=err)
        return e.code


def _run(workload, seed, seconds, trace, device, t0, fault, out, err):
    spec = load_json(ROOT, "BENCHMARK.json")
    cell = by_name(spec["workloads"], workload, "workload")
    import torch

    cuda = device != "cpu"
    if cuda:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False: this "
                           "benchmark measures the card and has no other "
                           "path", 3)
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} found", 3)
        device = "cuda:0"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", cell["name"] + ".json")
    kind = module("traffic", mix["kind"])
    sets = module("traffic", "sets")
    data_ss, sets_ss, check_ss = _seeds(seed)

    # ---- set-up: data, plan and upload, sets, warm-up -------------------
    locs, y = module("datasets", cfg["data"]["kind"]).make(
        cfg["data"], data_ss, device)
    model = build_model(cfg, locs, device)
    runner = kind.Runner(model, y, cfg, device)
    if fault is not None:
        fault(runner)
    rng = np.random.default_rng(sets_ss)
    pool = sets.draw(mix, rng, int(mix["pool_calls"]))
    warm = sets.draw(mix, rng, int(mix["warmup_calls"]))
    C = int(mix["C"])
    crng = np.random.default_rng(check_ss)
    within = int(mix["check"]["within_calls"])
    picks = crng.choice(within * C, size=int(mix["check"]["sets"]),
                        replace=False)
    checks = sorted((int(p) // C, int(p) % C) for p in picks)
    check_calls = {ci for ci, _ in checks}
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(int(mix["warmup_calls"])):
        runner.call(_row(warm, i))
    sync()
    setup_s = time.perf_counter() - t0

    # ---- the window: a closed loop of calls -----------------------------
    calls, enqueue, kept = [], [], {}
    failed = 0
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        enq, dur, res = runner.call(_row(pool, i))
        calls.append(dur)
        enqueue.append(enq)
        failed += runner.failed(res)
        if i in check_calls:
            kept[i] = runner.keep(res)
        del res
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - start
    n_calls = i
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0

    tr = None
    if trace:
        from portbench.yardstick.trace import own_kernel_names, profile_calls

        tr = profile_calls(lambda j: runner.call(_row(pool, n_calls + j)),
                           int(mix["profile_calls"]), own_kernel_names(ROOT),
                           sync)

    # ---- the check: the program's state freed, then the reference -------
    got, missing = [], 0
    for ci, c in checks:
        if ci in kept:
            got.append(kind.Runner.pick(kept[ci], c))
        else:
            missing += 1
    plan = model.plan
    del runner, model, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from portbench.reference.planner import plan_tree

    t_ref = time.perf_counter()
    tree = plan_tree(locs, cfg["r"], cfg["M"], cfg["J"],
                     seed=cfg["planner_seed"])
    plan_s = time.perf_counter() - t_ref
    numbers = {"plan_mismatch": plan_mismatches(plan, tree)}
    numbers["unchecked_calls"] = missing
    if got:
        ref = module("reference", cfg["reference"]).Reference(
            tree, y, cfg["R"], device=device, jitter=cfg["jitter"])
        want = kind.reference_outputs(
            ref, np.array([pool["l"][ci % len(pool["l"]), c]
                           for ci, c in checks if ci < n_calls]),
            np.array([pool["sig"][ci % len(pool["sig"]), c]
                      for ci, c in checks if ci < n_calls]),
            int(cfg["reference_chunk"]))
        numbers.update(kind.compare(got, want))
    print(f"reference: planner {plan_s:.3f} s, all "
          f"{time.perf_counter() - t_ref:.3f} s; window {n_calls} calls in "
          f"{window_s:.3f} s; set-up {setup_s:.3f} s", file=err)
    correct = (set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))

    # ---- metrics --------------------------------------------------------
    shape = tree_shape(tree)
    ctx = {
        "kind": mix["kind"], "C": C, "cell": cell["name"], "calls": calls,
        "enqueue": enqueue, "window_s": window_s, "n_calls": n_calls,
        "attempted": n_calls * C, "failed": failed, "setup_s": setup_s,
        "peak_bytes": peak_bytes, "trace": tr, "shape": shape,
        "flops_per_set": kind.flops_per_set(shape),
    }
    group = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in group:
        if not reported_in(m, cell["name"]):
            continue
        value = module("metrics", m["name"].split(".")[0]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(max(setup_peak, peak_bytes))}
    line = {"correct": bool(correct), "attempted": n_calls * C,
            "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    # a number that is not finite (a check that could not be made) is null
    line["checks"] = {k: {"value": (numbers[k] if k in numbers
                                    and np.isfinite(numbers[k]) else None),
                          "limit": limits.get(k)}
                      for k in sorted(set(numbers) | set(limits))}
    # after every import the run makes (metric readers and reference
    # included), just before the result
    bad = forbidden_modules()
    if bad:
        raise RunError("modules of JAX or the JAX package are loaded: "
                       + ", ".join(bad), 4)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=err)
    print(json.dumps(line), file=out)
    return 0
