#!/usr/bin/env python3
"""Where the time of the gradient path goes on the card.

For the cells of ``chip_smoke.py`` — ``n10k`` (bundled ``large``, r=4,
M=4, R=1e-4, l around 2), ``n1m`` (the 1000^2 grid, r=8, M=7, R=1e-2, l
around 0.05), ``dense`` (the ``n10k`` tree under phase 10's correlated
``[N, N]`` R, differentiated through ``MRAModel.sweep``) and ``wide`` (the
1000^2 grid at M=6: 4096 leaves of 256) — this measures, on one GPU:

* ms per likelihood-only forward and per value-and-gradient evaluation of
  ``MRAModel.loglik_fn`` (``dense``: of ``MRAModel.sweep(...).loglik``,
  a dict's parameters copied to the card as ``loglik_fn`` does): the
  median and quartiles of ``--reps``
  repetitions of chip_smoke's CUDA-event timing loop, alternating them;
  the value-and-gradient both with the parameters in a dict (copied to
  the card by ``loglik_fn``) and in a tuple (left on the host, so each
  covariance call's parameter gradient goes back to the host);
* the port's kernel launches per evaluation, forward and
  value-and-gradient, and every device launch (kernels, copies, fills)
  per profiled value-and-gradient evaluation;
* peak device memory of one value-and-gradient evaluation;
* ``torch.profiler`` traces of three value-and-gradient and of three
  likelihood-only evaluations: device time by kernel name, and the
  device's busy share of the wall time.

With ``--batched`` it profiles instead one batched value-and-gradient
evaluation of ``MRAModel.loglik_fn(..., batched=True)`` at each count of
parameter sets in ``BATCHES`` (C sets through one sweep): the port's
kernel launches per batched evaluation, ms per batched evaluation (the
median of ``--reps`` CUDA-event loops), peak memory, and the profiled
wall and device ms, busy share and device launches (``dense`` has no
batch: skipped).

Run from the repository root on a machine with an NVIDIA GPU::

    python3 tools/profile_gradient.py [--reps 5] [--side 1000]
        [--cells n10k,n1m,dense,wide] [--batched] [--out FILE]

It prints a summary and, with ``--out``, writes the numbers as JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymra_torch import MRAModel, PlanConfig, load_data  # noqa: E402
from pymra_torch.ops import linalg as tl  # noqa: E402
from pymra_torch.tree.plan import tpu_shaped_M  # noqa: E402
from pymra_torch.ops.linalg import set_matmul_precision  # noqa: E402
from pymra_torch.utils import gen_locations_2d  # noqa: E402


CELLS = ("n10k", "n1m", "dense", "wide")
#: parameter sets per batched evaluation (``--batched``), by cell
BATCHES = {"n10k": (1, 2, 4, 8), "n1m": (1, 2, 4), "wide": (1, 2, 4)}


def cells(side, names):
    """``(key, name, locs, y, r, M, R, l0)`` of each cell in ``names``."""
    locs, y = load_data("large")
    if "n10k" in names:
        yield "n10k", "N=10^4", locs, y, 4, 4, 1e-4, 2.0
    if "dense" in names:
        yield "dense", "N=10^4 dense R", locs, y, 4, 4, "correlated", 2.0
    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    if "n1m" in names:
        yield ("n1m", f"N={side * side}", locs, y, 8,
               tpu_shaped_M(len(locs), 8), 1e-2, 0.05)
    if "wide" in names:
        yield "wide", f"N={side * side} M=6", locs, y, 8, 6, 1e-2, 0.05


def launches(run):
    cs.reset_counters(tl)
    run()
    torch.cuda.synchronize()
    return {name: cs.launches_of(tl, name) for name, *_ in cs.KERNELS}


def quartiles(xs):
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "runs": [float(x) for x in xs]}


def device_times(prof, n_evals):
    """Self device ms per evaluation by kernel name, their sum, and the
    device activities (kernels, copies, fills) launched per evaluation."""
    by_name = {}
    count = 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in evt.key):
            count += evt.count
            if us:
                by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    total = sum(by_name.values()) / n_evals
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return total, [(k, v / n_evals) for k, v in top], count / n_evals


def profile_cell(name, locs, y, r, M, R, l0, reps, device="cuda"):
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y_dev = torch.as_tensor(y, dtype=torch.float32, device=device)
    if R == "correlated":
        r_dense = cs.correlated_r(locs, device)

        def loglik(builder):
            def f(theta):
                if isinstance(theta, dict):  # to the card, as loglik_fn
                    theta = {k: v.to(device) for k, v in theta.items()}
                return model.sweep(builder(theta), y_dev, r_dense,
                                   compute_posterior=False).loglik
            return f
    else:
        def loglik(builder):
            return model.loglik_fn(y_dev, R, kernel_builder=builder)
    f = loglik(cs.exponential_builder)
    ls = l0 * np.linspace(0.8, 1.2, 11)

    def forward(l):
        with torch.no_grad():
            return f({"l": torch.tensor(l, dtype=torch.float64),
                      "sig": torch.tensor(1.0, dtype=torch.float64)})

    out = {"launches_forward": launches(lambda: forward(l0)),
           "launches_value_and_grad": launches(
               lambda: cs.value_and_grad(f, l0, 1.0))}
    f_host = loglik(lambda th: cs.exponential_builder(dict(th)))

    def host_params(l):
        theta = tuple((k, torch.tensor(v, dtype=torch.float64,
                                       requires_grad=True))
                      for k, v in (("l", l), ("sig", 1.0)))
        f_host(theta).backward()
        return [float(t.grad) for _, t in theta]

    fwd, vg, vg_host = [], [], []
    for _ in range(reps):
        it = iter(ls)
        fwd.append(cs.time_ms(lambda: forward(float(next(it))), reps=10))
        vg.append(cs._grad_timer(f, ls, cs.time_ms))
        it = iter(ls)
        vg_host.append(cs.time_ms(lambda: host_params(float(next(it))),
                                  reps=10))
    out["ms_forward"] = quartiles(fwd)
    out["ms_value_and_grad"] = quartiles(vg)
    out["ms_value_and_grad_host_params"] = quartiles(vg_host)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.value_and_grad(f, l0, 1.0)
    torch.cuda.synchronize()
    out["peak_gib_value_and_grad"] = torch.cuda.max_memory_allocated() / 2**30

    out["profile"] = trace(lambda l: cs.value_and_grad(f, l, 1.0), ls)
    out["profile_forward"] = trace(forward, ls)

    print(f"== {name}")
    print(f"launches per forward {out['launches_forward']}")
    print(f"launches per value-and-gradient "
          f"{out['launches_value_and_grad']}")
    for key in ("ms_forward", "ms_value_and_grad",
                "ms_value_and_grad_host_params"):
        q = out[key]
        print(f"{key}: median {q['median']:.3f} (IQR {q['q1']:.3f}-"
              f"{q['q3']:.3f}) over {reps} runs {q['runs']}")
    print(f"peak memory of one value-and-gradient: "
          f"{out['peak_gib_value_and_grad']:.2f} GiB")
    for what, key in (("value-and-gradient", "profile"),
                      ("likelihood-only forward", "profile_forward")):
        pr = out[key]
        print(f"profiled {what}: wall {pr['wall_ms']:.3f} ms/eval, device "
              f"kernels {pr['device_kernel_ms']:.3f} ms/eval, busy "
              f"{pr['busy_share']:.1%}, {pr['device_launches']:g} device "
              "launches/eval")
        for k, v in pr["top"]:
            print(f"  {v:9.3f} ms/eval  {k[:110]}")
    return out


def profile_batched(name, locs, y, r, M, R, l0, reps, counts,
                    device="cuda"):
    """One batched value-and-gradient evaluation at each C of ``counts``:
    launches, ms (median of ``reps`` loops of 5), peak memory, trace."""
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y_dev = torch.as_tensor(y, dtype=torch.float32, device=device)
    fb = model.loglik_fn(y_dev, R, kernel_builder=cs.exponential_builder,
                         batched=True)
    shifts = np.exp(np.linspace(-0.02, 0.02, 6))
    out = {}
    print(f"== {name}, batched value and gradient")
    for C in counts:
        def run(t=1.0, C=C):
            cs.batched_value_and_grad(fb, {
                "l": list(l0 * t * np.linspace(0.9, 1.1, C)),
                "sig": [1.0] * C})

        rec = {"launches": launches(run)}
        ms = []
        for _ in range(reps):
            it = iter(shifts)
            ms.append(cs.time_ms(lambda: run(float(next(it))), reps=5))
        rec["ms_value_and_grad"] = quartiles(ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["profile"] = trace(run, shifts)
        pr, q = rec["profile"], rec["ms_value_and_grad"]
        print(f"C={C}: {q['median']:.3f} ms per batched evaluation (IQR "
              f"{q['q1']:.3f}-{q['q3']:.3f}), {q['median'] / C:.3f} per "
              f"set; launches {sum(rec['launches'].values())} "
              f"{ {k: v for k, v in rec['launches'].items() if v} }; peak "
              f"{rec['peak_gib']:.2f} GiB; profiled wall "
              f"{pr['wall_ms']:.3f} ms, device kernels "
              f"{pr['device_kernel_ms']:.3f} ms, busy {pr['busy_share']:.1%}"
              f", {pr['device_launches']:g} device launches")
        for k, v in pr["top"][:8]:
            print(f"  {v:9.3f} ms/eval  {k[:110]}")
        out[C] = rec
    return out


def trace(evaluate, ls, n_prof=3):
    """``torch.profiler`` over ``n_prof`` evaluations at the first values
    of ``ls``: wall and device-kernel ms per evaluation, the busy share,
    device launches per evaluation and the 15 largest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cs._spin()
        t0 = time.perf_counter()
        for l in ls[:n_prof]:
            evaluate(float(l))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_prof
        cs._spin()
    busy, top, n_dev = device_times(prof, n_prof)
    return {"wall_ms": wall, "device_kernel_ms": busy,
            "busy_share": busy / wall, "device_launches": n_dev,
            "top": top[:15]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--side", type=int, default=1000)
    parser.add_argument("--cells", default="n10k,n1m",
                        help=f"comma-separated, of {', '.join(CELLS)}")
    parser.add_argument("--batched", action="store_true",
                        help="profile batched evaluations at the counts "
                             "of BATCHES instead")
    parser.add_argument("--out", help="write the numbers as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gradient: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    set_matmul_precision()
    result = {"card": card}
    names = args.cells.split(",")
    unknown = set(names) - set(CELLS)
    if unknown:
        raise SystemExit(f"profile_gradient: unknown cells {sorted(unknown)}")
    for key, *cell in cells(args.side, names):
        if not args.batched:
            result[cell[0]] = profile_cell(*cell, reps=args.reps)
        elif key in BATCHES:
            result[cell[0]] = profile_batched(*cell, reps=args.reps,
                                              counts=BATCHES[key])
        else:
            print(f"== {cell[0]}: no batch (a dense R runs one set)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
