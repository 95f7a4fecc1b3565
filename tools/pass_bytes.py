#!/usr/bin/env python3
"""Bytes and FLOPs of one batched value-and-gradient evaluation, by line.

Runs ``MRAModel.loglik_fn(..., batched=True)`` and its backward on the CPU
for a synthetic grid (``--side`` x ``--side`` points, r=8, M from
``tpu_shaped_M``, R=1e-2, ``--sets`` parameter sets from chip_smoke's
N=10^6 batch) under a ``TorchDispatchMode`` that counts, for every
non-view aten op, the bytes its tensor arguments hold (read) and its
outputs hold (written), by dtype, and the FLOPs of its matrix products
(``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``: 2 per
multiply-add). Each op is keyed to where it comes from:

* a forward op to the innermost frame of ``pymra_torch`` on its Python
  stack (``file:line function``);
* a backward op to its autograd node (``torch._C._current_autograd_node``)
  and the line that made the node in the forward, read from the node's
  traceback under ``torch.autograd.set_detect_anomaly`` (the anomaly
  mode's own NaN checks are not counted), plus the innermost
  ``pymra_torch`` frame of a custom Function's Python backward;
* an op under one of the hand-written kernels' plain twins
  (``ops/linalg.py``'s ``*_ref`` functions) to that twin, counted apart:
  on the card each call is one launch of the kernel, whatever the twin's
  loops do on the CPU.

The leaves' width and batch scale the counts exactly: 512^2 points at 4
sets give 4096 leaves of 64 a set, a quarter of the 1000^2 grid's 16,384.
Timings are not measured: these are counts from shapes. Run from the
repository root::

    python3 tools/pass_bytes.py [--side 256] [--sets 4] [--top 25]
        [--out FILE]

It prints the keys by their elementwise bytes (bytes of ops that are not
matrix products), the matrix products' FLOPs by dtype, and the twins'
calls; ``--out`` writes every key as JSON.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

import chip_smoke as cs  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pymra_torch")
LINALG = os.path.join(PKG, "ops", "linalg.py")
#: matrix products and their multiply-adds from the arguments' shapes
GEMMS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
#: ops the anomaly mode adds after each backward node
ANOMALY = {"isnan", "_is_any_true", "_local_scalar_dense"}


def _nbytes(ts) -> dict:
    out = collections.Counter()
    for t in ts:
        if isinstance(t, torch.Tensor):
            out[str(t.dtype).replace("torch.", "")] += (
                t.numel() * t.element_size())
    return out


def _multiply_adds(name: str, args) -> int:
    t = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("mm", "addmm"):
        a, b = t[-2], t[-1]
        return a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = t[-2], t[-1]
        return a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return t[0].shape[0] * t[0].shape[1]
    return t[0].numel()  # dot


def _site(frames, callers: bool = False) -> str | None:
    """``path:line function`` of the innermost frame inside the package;
    with ``callers``, of the innermost outside ``ops/linalg.py`` where
    there is one (the line that called a wrapper there)."""
    inside = [fr for fr in frames if fr.filename.startswith(PKG)]
    if callers:
        inside = ([fr for fr in inside if fr.filename != LINALG]
                  or inside)
    if not inside:
        return None
    fr = inside[-1]
    return f"{os.path.relpath(fr.filename, PKG)}:{fr.lineno} {fr.name}"


def _twin(frames) -> str | None:
    """The outermost plain twin of a hand-written kernel on the stack."""
    for fr in frames:
        if fr.filename == LINALG and fr.name.endswith("_ref"):
            return fr.name[:-4]
    return None


def _forward_site(node) -> str:
    """The line that made an autograd node, from its anomaly traceback."""
    tb = node.metadata.get("traceback_") if node is not None else None
    if not tb:
        return "?"
    frames = []
    for entry in tb:
        head = entry.strip().splitlines()[0]  # File "...", line N, in fn
        try:
            path = head.split('"')[1]
            line = int(head.split("line ")[1].split(",")[0])
            name = head.rsplit(" in ", 1)[1]
        except (IndexError, ValueError):
            continue
        frames.append(traceback.FrameSummary(path, line, name))
    return _site(frames, callers=True) or "?"


class Counter(TorchDispatchMode):
    """Bytes and matrix-product FLOPs of every non-view op, by key."""

    def __init__(self):
        super().__init__()
        self.keys = collections.defaultdict(lambda: {
            "ops": 0, "read": collections.Counter(),
            "written": collections.Counter(), "gemm_flops": collections.Counter()})
        self.twins = collections.defaultdict(lambda: {
            "ops": 0, "bytes": 0, "gemm_flops": 0})
        self.twin_calls = collections.Counter()
        self.twin_depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        node = torch._C._current_autograd_node()
        if node is not None and name in ANOMALY:
            return out
        frames = traceback.extract_stack()[:-1]
        ins = tree_leaves((args, kwargs or {}))
        outs = tree_leaves(out)
        flops = 2 * _multiply_adds(name, ins) if name in GEMMS else 0
        dt = next((str(t.dtype).replace("torch.", "") for t in ins
                   if isinstance(t, torch.Tensor) and t.is_floating_point()),
                  "other")
        twin = _twin(frames)
        if twin is not None:
            rec = self.twins[twin]
            rec["ops"] += 1
            rec["bytes"] += sum(_nbytes(ins).values()) + sum(
                _nbytes(outs).values())
            rec["gemm_flops"] += flops
            return out
        if node is None:
            key = "fwd " + (_site(frames, callers=True) or "?")
        else:
            key = f"bwd {node.name()} <- {_forward_site(node)}"
            here = _site(frames)
            if here is not None:
                key += f" @ {here}"
        rec = self.keys[key]
        rec["ops"] += 1
        if flops:
            rec["gemm_flops"][dt] += flops
        else:
            rec["read"].update(_nbytes(ins))
            rec["written"].update(_nbytes(outs))
        return out


def count_twin_calls(mode):
    """Wrap every ``*_ref`` twin of ``ops/linalg.py`` to count its calls
    that no other twin makes: on the card, one launch each."""
    from pymra_torch.ops import linalg as tl

    saved = {}
    for name in tl.__all__:
        fn = getattr(tl, name)
        if name.endswith("_ref") and callable(fn):
            def wrapped(*a, _fn=fn, _name=name[:-4], **k):
                if not mode.twin_depth:
                    mode.twin_calls[_name] += 1
                mode.twin_depth += 1
                try:
                    return _fn(*a, **k)
                finally:
                    mode.twin_depth -= 1
            wrapped.cuda_calls = 0
            saved[name] = fn
            setattr(tl, name, wrapped)
    return saved


def run(side: int, sets: int) -> Counter:
    from pymra_torch import MRAModel, PlanConfig
    from pymra_torch.ops import linalg as tl
    from pymra_torch.tree.plan import tpu_shaped_M
    from pymra_torch.utils import gen_locations_2d

    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    model = MRAModel(locs, r=8, M=tpu_shaped_M(len(locs), 8),
                     dtype=torch.float32,
                     config=PlanConfig(r=8, kmeans_impl="native"),
                     device="cpu")
    f = model.loglik_fn(torch.as_tensor(y), 1e-2,
                        kernel_builder=cs.exponential_builder, batched=True)
    theta = {k: torch.tensor(v[:sets], dtype=torch.float64,
                             requires_grad=True)
             for k, v in cs.BATCH_N1M.items()}
    mode = Counter()
    saved = count_twin_calls(mode)
    try:
        with torch.autograd.set_detect_anomaly(True), mode:
            f(theta).sum().backward()
    finally:
        for name, fn in saved.items():
            setattr(tl, name, fn)
    return mode


def report(mode: Counter, top: int) -> dict:
    rows = []
    for key, rec in mode.keys.items():
        elem = sum(rec["read"].values()) + sum(rec["written"].values())
        f64 = rec["read"]["float64"] + rec["written"]["float64"]
        rows.append({"key": key, "ops": rec["ops"], "elementwise_bytes": elem,
                     "elementwise_float64_bytes": f64,
                     "gemm_flops": dict(rec["gemm_flops"])})
    total = sum(r["elementwise_bytes"] for r in rows) or 1
    rows.sort(key=lambda r: -r["elementwise_bytes"])
    print(f"elementwise bytes of the evaluation: {total / 1e9:.3f} GB; "
          "matrix products: "
          f"{sum(sum(r['gemm_flops'].get(d, 0) for r in rows) for d in ('float64',)) / 1e9:.2f}"
          " GFLOP float64, "
          f"{sum(r['gemm_flops'].get('float32', 0) for r in rows) / 1e9:.2f}"
          " GFLOP float32 (the kernels' twins apart)")
    print(f"{'share':>6} {'GB':>8} {'f64 GB':>8} {'ops':>5} "
          f"{'GEMM f64':>9} {'GEMM f32':>9}  key")
    for r in rows[:top]:
        g = r["gemm_flops"]
        print(f"{100 * r['elementwise_bytes'] / total:5.1f}% "
              f"{r['elementwise_bytes'] / 1e9:8.3f} "
              f"{r['elementwise_float64_bytes'] / 1e9:8.3f} {r['ops']:5d} "
              f"{g.get('float64', 0) / 1e9:9.2f} "
              f"{g.get('float32', 0) / 1e9:9.2f}  {r['key']}")
    # by the forward line alone: the forward's ops and every backward
    # node it made
    lines = collections.Counter()
    for r in rows:
        key = r["key"]
        line = key[4:] if key.startswith("fwd ") else key.split(" <- ")[1]
        lines[line.split(" @ ")[0]] += r["elementwise_bytes"]
    print("by forward line (forward and backward):")
    for line, b in lines.most_common(top):
        print(f"{100 * b / total:5.1f}% {b / 1e9:8.3f} GB  {line}")
    twins = {name: {**rec, "calls": mode.twin_calls[name]}
             for name, rec in mode.twins.items()}
    print("hand-written kernels' twins (one launch a call on the card), "
          "counted apart:")
    for name, rec in sorted(twins.items(), key=lambda x: -x[1]["bytes"]):
        print(f"  {name}: {rec['calls']} calls, {rec['ops']} CPU ops")
    return {"rows": rows, "by_forward_line": dict(lines), "twins": twins,
            "elementwise_bytes": total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--sets", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out")
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    mode = run(args.side, args.sets)
    out = report(mode, args.top)
    out.update(side=args.side, sets=args.sets)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
