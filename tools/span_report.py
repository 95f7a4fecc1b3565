#!/usr/bin/env python3
"""The program's spans and counters in one benchmark cell, and what
tracing costs.

Run from the root of a checkout (its ``portbench/`` and ``pymra_torch/``
are the ones measured; an older tree without spans is measured too, with
its spans left out)::

    python3 PATH/tools/span_report.py --workload grid1m.grad4 --seed 7 \\
        [--warm 10] [--calls 10] [--profiled 6] [--pairs 10] \\
        [--device cuda] [--out chiprun_out/spans.json]

Sets the cell up as ``portbench/harness.py`` does (data from the seed, the
model, the runner, its parameter sets, the warm-up), runs ``--warm`` more
calls so that the allocator holds what a steady call needs, then times
``--calls`` untraced calls, ``--profiled`` calls under ``torch.profiler``
(``portbench/yardstick/trace.py``'s ``profile_calls``: launches, library
and own kernel time, idle share, and whether any program-made range
reached the device's timeline), as many calls under
``profiling.tracing()`` with no profiler, and ``--pairs`` pairs of an
untraced and a traced call in turn. Each call's time is the harness's:
the enqueue (call to return) and the whole call (results back). Prints
the span table (``profiling.report()``) of the profiled calls and of the
traced ones, and one JSON object last; with ``--out`` the JSON goes to
that file too. Last, the cost of the span sites with tracing off, timed
in a loop: the facade's entry and exit, and one span site's test.
"""
import argparse
import json
import os
import statistics
import sys
import time
import timeit

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _median_ms(xs):
    return statistics.median(xs) * 1e3 if xs else None


def _off_cost(profiling, device):
    """Microseconds of the facade's entry and exit and of one span site's
    test (begin site and end site) with tracing off."""
    if not hasattr(profiling, "facade"):
        return None
    n = 20000

    def facade():
        with profiling.facade(device):
            pass

    def site():
        sp = profiling.begin("x") if profiling.ON else None
        if sp is not None:
            profiling.end(sp)

    def empty():
        pass

    base = min(timeit.repeat(empty, number=n, repeat=5)) / n
    return {"facade_us": (min(timeit.repeat(facade, number=n, repeat=5)) / n
                          - base) * 1e6,
            "site_us": (min(timeit.repeat(site, number=n * 10, repeat=5))
                        / (n * 10) - base) * 1e6}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--warm", type=int, default=10)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--profiled", type=int, default=0,
                   help="profiled calls (0: the cell's own count)")
    p.add_argument("--pairs", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    a = p.parse_args(argv)

    from portbench import harness
    from portbench.yardstick.trace import own_kernel_names, profile_calls
    from pymra_torch.utils import profiling

    cuda = a.device != "cpu"
    device = "cuda:0" if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.by_name(spec["workloads"], a.workload, "workload")
    cfg = harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    mix = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
    kind = harness.module("traffic", mix["kind"])
    sets = harness.module("traffic", "sets")
    data_ss, sets_ss, _ = harness._seeds(a.seed)
    t0 = time.perf_counter()
    locs, y = harness.module("datasets", cfg["data"]["kind"]).make(
        cfg["data"], data_ss, device)
    model = harness.build_model(cfg, locs, device)
    runner = kind.Runner(model, y, cfg, device)
    rng = np.random.default_rng(sets_ss)
    n = a.calls
    ncalls = a.profiled or int(mix["profile_calls"])
    pool = sets.draw(mix, rng, int(mix["warmup_calls"]) + a.warm + n
                     + 2 * ncalls + 2 * a.pairs)
    row = iter(range(1 << 30))
    for _ in range(int(mix["warmup_calls"])):
        runner.call(harness._row(pool, next(row)))
    sync()
    setup_s = time.perf_counter() - t0

    def timed(times):
        def call(_):
            enq, dur, _out = runner.call(harness._row(pool, next(row)))
            times.append((enq, dur))
        return call

    for _ in range(a.warm):
        runner.call(harness._row(pool, next(row)))
    plain = []
    for i in range(n):
        timed(plain)(i)
    has_spans = hasattr(profiling, "spans")
    setup = ([r for r in profiling.spans() if r["call"] is None]
             if has_spans else [])
    profiled = []
    if has_spans:
        profiling.clear()
    tr = profile_calls(timed(profiled), ncalls,
                       own_kernel_names(harness.ROOT), sync)
    prof_table = profiling.report() if has_spans else None
    ctx = {"trace": tr, "C": int(mix["C"]), "setup_s": setup_s}
    metrics = {}
    if has_spans:
        for m in spec["per_layer"]:
            if a.workload in m.get("workloads", [a.workload]):
                reader = harness.module("metrics", m["name"].split(".")[0])
                try:
                    metrics[m["name"]] = reader.read(ctx)
                except KeyError:
                    pass  # a reader of the window's numbers
    traced, trace_table = [], None
    if has_spans:
        profiling.clear()
        with profiling.tracing():
            for i in range(ncalls):
                timed(traced)(i)
        trace_table = profiling.report()
    pairs = []
    if has_spans:
        for i in range(a.pairs):
            off, on = [], []
            timed(off)(i)
            profiling.clear()
            with profiling.tracing():
                timed(on)(i)
            pairs.append((off[0][0], on[0][0]))
    pymra_on_device = sorted({nm for nm in tr.dev_names if "pymra" in nm})
    out = {
        "workload": a.workload, "seed": a.seed,
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "setup_s": setup_s, "spans": has_spans,
        "enqueue_ms": {"plain": _median_ms([e for e, _ in plain]),
                       "profiled": _median_ms([e for e, _ in profiled]),
                       "traced": _median_ms([e for e, _ in traced])},
        "pairs_enqueue_ms": (
            {"untraced": _median_ms([x for x, _ in pairs]),
             "traced": _median_ms([y for _, y in pairs]),
             "traced_minus_untraced": _median_ms([y - x for x, y in pairs])}
            if pairs else None),
        "call_ms": {"plain": _median_ms([d for _, d in plain]),
                    "profiled": _median_ms([d for _, d in profiled]),
                    "traced": _median_ms([d for _, d in traced])},
        "trace": {"launches_per_call": tr.kernel_count() / tr.calls,
                  "library_device_ms_per_set":
                      tr.kernel_us(own=False) / 1e3 / tr.calls / ctx["C"],
                  "own_kernels_device_ms_per_set":
                      tr.kernel_us(own=True) / 1e3 / tr.calls / ctx["C"],
                  "device_idle_pct":
                      100.0 * (1.0 - tr.busy_us() / tr.window_us),
                  "window_ms_per_call": tr.window_us / 1e3 / tr.calls,
                  "clocks": sum(1 for h in tr.host
                                if h[0] == "pymra.clock"),
                  "pymra_on_device": pymra_on_device,
                  "device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()},
        "metrics": metrics,
        "setup_spans": {r["name"]: r["host_ms"] / 1e3 for r in setup},
        "off_cost": _off_cost(profiling, model.device),
    }
    if prof_table:
        print(f"== {a.workload}: spans of the {ncalls} profiled calls")
        print(prof_table)
    if trace_table:
        print(f"== {a.workload}: spans of {ncalls} calls under tracing(), "
              "no profiler")
        print(trace_table)
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
