"""Profiling and tracing (counterpart of ``pymra_tpu/utils/profiling.py``).

  * :class:`PhaseTimer` — accumulate named wall-clock phases (plan / sweep
    / sample), waiting for the card where asked;
  * :func:`chained_throughput` — evaluations per second of a function on
    the card, timed by CUDA events over a chain of dependent evaluations;
  * :func:`trace_annotation` — a named range in ``torch.profiler`` traces
    (and an NVTX range when CUDA is up);
  * :func:`profile_to` — a ``torch.profiler`` trace written to a directory
    (Chrome trace format; view it in Perfetto or ``chrome://tracing``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer", "trace_annotation", "profile_to",
           "chained_throughput"]


def _tensors(obj):
    """The tensors in a nested structure of dicts, lists and tuples."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def synchronize(obj) -> None:
    """Wait until the CUDA devices of ``obj`` (a ``torch.device`` or the
    tensors of a structure) have finished their queued work; CPU tensors
    need no wait."""
    devs = ({obj} if isinstance(obj, torch.device)
            else {t.device for t in _tensors(obj)})
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates wall time per named phase.

    Example::

        timer = PhaseTimer()
        with timer("plan"):
            plan = build_plan(...)
        with timer("sweep", sync=y):
            result = model.sweep(kernel, y, R)
        print(timer.report())

    ``sync`` (the JAX package's ``block_until_ready`` argument) is a tensor,
    a structure of tensors or a ``torch.device``: before the clock stops,
    the host waits for every CUDA device among them to finish all its
    queued work, the phase's included. CPU tensors need no wait.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>16s}: {t:8.3f}s  ({c} calls, "
                         f"{1000 * t / c:.1f} ms/call)")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in self.totals.items()}


def _fold(out, dtype, device) -> torch.Tensor:
    """Sum of every output tensor, one scalar, so no output is unused."""
    acc = torch.zeros((), dtype=dtype, device=device)
    for t in _tensors(out):
        acc = acc + t.detach().sum().to(dtype=dtype, device=device)
    return acc


def chained_throughput(eval_fn, thetas, *args, n_evals: int = 20,
                       perturb: float = 1e-20):
    """Device throughput of ``eval_fn``, in evaluations per second.

    The JAX package compiles ``n`` dependent evaluations into one program;
    here there is no compiler to fool, and PyTorch returns before the card
    finishes. So ``n_evals`` evaluations run back to back, each at
    ``thetas[i] + perturb * acc`` where ``acc`` folds every output of the
    previous ones (a data dependency: no evaluation can start early), and
    CUDA events around the chain time it on the device's clock. On the CPU
    the host clock times it (a CPU number, never a device figure).

    Args:
      eval_fn: ``(theta_scalar, *args) -> tensor or structure of tensors``.
      thetas: 1-D tensor of per-evaluation parameters (length >=
        ``n_evals + 1``).
      n_evals: chain length of the timed measurement.
      perturb: coupling of the dependency; small enough to change nothing.

    Returns:
      dict with ``evals_per_sec``, ``per_eval_s``, ``compile_s`` (the first,
      warm-up evaluation: builds and loads the kernels), ``overhead_s`` (one
      evaluation including the host's wait for it), ``chain_s`` (the chain,
      device-timed on the card), ``n_evals``, ``dispatch_evals_per_sec``
      (the rate at which the host enqueued the chain, reported for
      comparison, never the headline) and ``device`` (where it ran).
    """
    thetas = torch.as_tensor(thetas)
    if thetas.shape[0] < n_evals + 1:
        raise ValueError(f"need {n_evals + 1} thetas, got {thetas.shape[0]}")
    dev = thetas.device
    cuda = dev.type == "cuda"
    dtype = thetas.dtype

    def run(start, n, acc):
        for i in range(start, start + n):
            theta = thetas[i] + perturb * acc
            acc = acc + _fold(eval_fn(theta, *args), dtype, dev)
        return acc

    zero = torch.zeros((), dtype=dtype, device=dev)
    t0 = time.perf_counter()
    float(run(0, 1, zero))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(run(0, 1, zero))
    overhead_s = time.perf_counter() - t0

    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        acc = run(1, n_evals, zero)
        end.record()
        dispatch_s = time.perf_counter() - t0
        float(acc)
        chain_s = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        float(run(1, n_evals, zero))
        chain_s = dispatch_s = time.perf_counter() - t0
    per_eval = max(chain_s, 1e-12) / n_evals
    return {
        "evals_per_sec": 1.0 / per_eval,
        "per_eval_s": per_eval,
        "compile_s": compile_s,
        "overhead_s": overhead_s,
        "chain_s": chain_s,
        "n_evals": n_evals,
        "dispatch_evals_per_sec": n_evals / max(dispatch_s, 1e-12),
        "device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
    }


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in ``torch.profiler`` traces, and an NVTX range when
    CUDA has been initialized."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(logdir: str):
    """Trace the enclosed work with ``torch.profiler`` (the card's activity
    too when CUDA is available) and write it as a Chrome trace into
    ``logdir`` (``trace_<pid>.json``). Yields the profiler, whose
    ``key_averages()`` sums the time by operation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))
