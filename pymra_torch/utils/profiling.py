"""Profiling and tracing (counterpart of ``pymra_tpu/utils/profiling.py``).

  * :class:`PhaseTimer` — accumulate named wall-clock phases (plan / sweep
    / sample), waiting for the card where asked;
  * :func:`chained_throughput` — evaluations per second of a function on
    the card, timed by CUDA events over a chain of dependent evaluations;
  * spans and counters of the port's own work: :func:`trace_annotation`
    (a named span, and an NVTX range when CUDA is up), :func:`tracing`,
    :func:`spans`, :func:`report`;
  * :func:`profile_to` — a ``torch.profiler`` trace written to a directory
    (Chrome trace format, the spans merged in; view it in Perfetto or
    ``chrome://tracing``).

Spans record only while a ``torch.profiler`` records or inside ``with
tracing():``. A facade call (``MRAModel.sweep``, the function of
``MRAModel.loglik_fn``) checks that once at its top and holds the answer
for the call: it opens ``pymra.call``, inside which the sweep opens
``pymra.prep`` (where the observations are prepared per call),
``pymra.pass.A`` to ``pymra.pass.D`` and, inside A, B and C, one
``pymra.pass.<X>.level`` a level (``level`` in the record), inside which
each evaluation of a covariance with no closed form (the general-nu
Matern's Bessel K, :func:`pymra_torch.kernels.matern`) is a ``pymra.cov``
span with its counters ``cov_entries`` (entries times sets) and
``cov_fallback_entries`` (those of them with a positive scaled distance
whose Bessel pair took the series or the continued fraction: on the card
those the kernel's table did not cover, counted by the kernel into a tensor
read with the spans; on the CPU, where the twin has no table, all of them).
The backward of a traced call records ``pymra.bwd`` with ``pymra.bwd.C``,
``pymra.bwd.B`` and ``pymra.bwd.A`` (and ``pymra.bwd.D`` where a posterior
is differentiated) on autograd's thread, under the forward's call id:
while tracing, an identity autograd Function (:func:`mark`) takes a tensor
each pass hands on, and since autograd runs nodes in falling sequence
number its backward runs exactly between the later pass's backward and its
own. One on the parameters of ``loglik_fn`` closes ``pymra.bwd``; else the
end of the backward pass does. A kernel's backward may open a span of its
own inside the open one (:func:`backward_span`: the general-nu Matern's
``pymra.bwd.cov``). The set-up spans ``pymra.setup.plan``,
``pymra.setup.upload`` and ``pymra.setup.kernels`` record always: they
happen once a model.

A span keeps its name, parent, call id and host ends (``time.time_ns``);
on a call on the card a timing event recorded on the current stream at
each end; the port's kernel launches at its ends
(:func:`pymra_torch.ops.cuda.launch.launch_count`); and the escalation
factors ``f`` its jittered kernels returned, reduced to the members with
``f > 1`` only when read. Off, a span site costs the test of :data:`ON`:
no event, no marker, the autograd graph unchanged.

The spans are not profiler ranges: a ``record_function`` that encloses
kernels lands on the profiler's device timeline too, where a reader of the
trace would count it as a kernel. The one profiler range the program opens
is an empty ``pymra.clock`` at the start of each traced call while a
profiler records, with the ``time.time_ns()`` read inside it kept as the
call's anchor: its host event puts the call's spans on the trace's clock.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque, defaultdict

import torch

from pymra_torch.ops.cuda.launch import launch_count as _launches

__all__ = ["PhaseTimer", "trace_annotation", "profile_to",
           "chained_throughput", "tracing", "spans", "report", "clear",
           "CLOCK"]

#: True while a traced call is open: the one test a span site makes
ON = False
#: the empty profiler range at the start of each traced call
CLOCK = "pymra.clock"
#: traced calls kept (and as many set-up spans)
RING = 64


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




# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
#: this thread's open spans, outermost (the call's root) first
_tls = threading.local()
_calls: deque = deque(maxlen=RING)
_setup: deque = deque(maxlen=RING)
_call_ids = itertools.count(1)
_span_ids = itertools.count(1)
_state = {"forced": 0, "open": 0, "last_call": 0}


class _Call:
    """One traced facade call (or top-level annotation): its spans, forward
    and backward, and its clock anchor."""

    __slots__ = ("id", "cuda", "stream", "anchor_ns", "spans", "bwd",
                 "bwd_child")

    def __init__(self, cuda):
        self.id = next(_call_ids)
        _state["last_call"] = self.id
        self.cuda = cuda  # the card's torch.device, or None
        # the call's stream, which autograd runs its backward on too
        self.stream = (torch.cuda.current_stream(cuda) if cuda is not None
                       else None)
        self.anchor_ns = None
        self.spans: list = []
        self.bwd = self.bwd_child = None


class _Span:
    """One span: its ends on the host's clock, on a card's stream (CUDA
    events) and on the launch counters, and the escalation factors kept
    while it was the innermost open span."""

    __slots__ = ("id", "name", "parent", "call", "level", "t0", "t1", "e0",
                 "e1", "l0", "l1", "esc", "device_ms", "own_esc", "counts",
                 "pending")

    def __init__(self, name, parent, call, level=None, counters=True):
        self.id = next(_span_ids)
        self.name, self.parent, self.call, self.level = (name, parent, call,
                                                         level)
        self.esc: list = []
        self.counts: dict = {}
        self.pending: list = []  # (counter, tensor) pairs not read yet
        self.t1 = self.e0 = self.e1 = self.l0 = self.l1 = None
        self.device_ms = self.own_esc = None
        if counters:
            self.l0 = _launches()
        if call is not None:
            if call.stream is not None:
                self.e0 = torch.cuda.Event(enable_timing=True)
                self.e0.record(call.stream)
            call.spans.append(self)
        self.t0 = time.time_ns()

    def close(self) -> None:
        if self.t1 is not None:
            return
        self.t1 = time.time_ns()
        if self.e0 is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record(self.call.stream)
        if self.l0 is not None:
            self.l1 = _launches()


def _open_call(name: str, cuda) -> _Span:
    """A new traced call on this thread, its root span ``name`` open."""
    global ON
    call = _Call(cuda)
    if _profiler_enabled():
        with torch.profiler.record_function(CLOCK):
            call.anchor_ns = time.time_ns()
    root = _Span(name, None, call)
    _tls.open = [root]
    with _lock:
        _calls.append(call)
        _state["open"] += 1
        ON = True
    return root


def _close_call(root: _Span) -> None:
    global ON
    end(root)
    with _lock:
        _state["open"] -= 1
        ON = _state["open"] > 0


def _tracing_now() -> bool:
    return bool(_state["forced"]) or _profiler_enabled()


class facade:
    """``with facade(device):`` around a facade call's body: when a
    profiler records (or inside :func:`tracing`) and no traced call is open
    on this thread, the call is traced, its root span ``pymra.call``."""

    __slots__ = ("device", "root")

    def __init__(self, device=None):
        self.device = device
        self.root = None

    def __enter__(self):
        if _tracing_now() and not getattr(_tls, "open", None):
            dev = self.device
            self.root = _open_call("pymra.call", dev if dev is not None
                                   and dev.type == "cuda" else None)
        return self.root

    def __exit__(self, *exc):
        if self.root is not None:
            _close_call(self.root)
            self.root = None
        return False


def begin(name: str, level: int | None = None):
    """Open the span ``name`` (``level``: a tree level) inside this
    thread's innermost open span; None where no traced call is open on this
    thread. The sweep calls it only where :data:`ON`."""
    stack = getattr(_tls, "open", None)
    if not stack:
        return None
    sp = _Span(name, stack[-1], stack[0].call, level)
    stack.append(sp)
    return sp


def end(sp) -> None:
    """Close ``sp`` and every span still open inside it."""
    stack = getattr(_tls, "open", None)
    while stack:
        top = stack.pop()
        top.close()
        if top is sp:
            return


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` of this thread's innermost open
    span (``cov_entries``: entries times sets of a general-nu Matern
    evaluation, kept with its ``pymra.cov`` span). ``n`` may be a
    one-element integer tensor that a kernel fills (the Matern kernel's
    ``cov_fallback_entries``, beside ``cov_entries``): it is kept as it is
    and added when the spans are read, once the card has finished (no wait
    here)."""
    stack = getattr(_tls, "open", None)
    if stack:
        sp = stack[-1]
        if torch.is_tensor(n):
            sp.pending.append((name, n))
        else:
            sp.counts[name] = sp.counts.get(name, 0) + int(n)


def current_call():
    """This thread's open traced call, or None: what a backward that opens
    a span of its own (:func:`backward_span`) keeps from its forward."""
    stack = getattr(_tls, "open", None)
    return stack[0].call if stack else None


def backward_span(call, name: str):
    """A span ``name`` opened on autograd's thread inside ``call``'s open
    backward span (``pymra.bwd.<X>``, else ``pymra.bwd``): a kernel's
    backward, such as the Matern's ``pymra.bwd.cov``. None where ``call``
    is None; the caller closes it (``.close()``)."""
    if call is None:
        return None
    with _lock:
        return _Span(name, call.bwd_child or call.bwd, call)


def escalations(kernel: str, *fs) -> None:
    """Keep the escalation factors ``fs`` (one tensor per factorization of
    each member) that ``kernel`` selected, with this thread's innermost
    open span; they are compared with 1 only when read (no launch, no
    wait here)."""
    stack = getattr(_tls, "open", None)
    if stack:
        stack[-1].esc.append((kernel, tuple(f.detach() for f in fs)))


class _Boundary(torch.autograd.Function):
    """Identity on its tensors; its backward marks a pass boundary of a
    traced call's backward (:func:`mark`)."""

    @staticmethod
    def forward(ctx, call, label, *tensors):
        ctx.call, ctx.label = call, label
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        _boundary(ctx.call, ctx.label)
        return (None, None) + grads


def mark(label: str | None, *tensors) -> tuple:
    """``tensors``, those that require a gradient passed through one
    identity :class:`_Boundary`, whose backward runs once every later
    operation's backward has run: it closes the open ``pymra.bwd.*`` span
    and opens ``pymra.bwd.<label>`` (``pymra.bwd`` first if the call's
    backward has none open); ``label`` None closes ``pymra.bwd``. Only
    while this thread has a traced call open and autograd records."""
    stack = getattr(_tls, "open", None)
    idx = [i for i, t in enumerate(tensors)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if not stack or not idx or not torch.is_grad_enabled():
        return tensors
    out = list(tensors)
    marked = _Boundary.apply(stack[0].call, label,
                             *(tensors[i] for i in idx))
    for i, t in zip(idx, marked):
        out[i] = t
    return tuple(out)


def _boundary(call: _Call, label: str | None) -> None:
    with _lock:
        child = call.bwd_child
        if label is None:
            if call.bwd is not None:
                if child is not None:
                    child.close()
                call.bwd.close()
                call.bwd = call.bwd_child = None
            return
        name = "pymra.bwd." + label
        if child is not None and child.name == name:
            return
        if call.bwd is None:
            call.bwd = _Span("pymra.bwd", None, call)
            # the end of this backward pass closes what no marker closed
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: _boundary(call, None))
        if child is not None:
            child.close()
        call.bwd_child = _Span(name, call.bwd, call)


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block, with no profiler: its
    facade calls are traced (no clock anchor: no profiler trace to put
    them on)."""
    with _lock:
        _state["forced"] += 1
    try:
        yield
    finally:
        with _lock:
            _state["forced"] -= 1


@contextlib.contextmanager
def setup_span(name: str):
    """A set-up span (host times only), recorded whether or not anything
    is traced."""
    sp = _Span(name, None, None, counters=False)
    try:
        yield sp
    finally:
        sp.close()
        _setup.append(sp)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A span ``name``, and an NVTX range when CUDA has been initialized.

    Inside a traced call it is a child of the innermost open span; outside
    one, while a profiler records or inside :func:`tracing`, it is the root
    of a traced call of its own (anchored like a facade call). Not a
    profiler range (see the module's docstring)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    sp = None
    try:
        if getattr(_tls, "open", None):
            sp = begin(name)
        elif _tracing_now():
            sp = _open_call(name, torch.device(
                "cuda", torch.cuda.current_device()) if nvtx else None)
        yield
    finally:
        if sp is not None:
            (end if sp.parent is not None else _close_call)(sp)
        if nvtx:
            torch.cuda.nvtx.range_pop()


def clear() -> None:
    """Forget every kept span and call."""
    with _lock:
        _calls.clear()
        _setup.clear()


def _resolve(sp: _Span) -> None:
    """Device milliseconds, own escalated members and tensor counters of a
    closed span, once (after the caller synchronized the card)."""
    for name, t in sp.pending:
        sp.counts[name] = sp.counts.get(name, 0) + int(t)
    sp.pending = []
    if sp.device_ms is None:
        if sp.e1 is not None:
            sp.device_ms = sp.e0.elapsed_time(sp.e1)
        elif sp.call is not None and sp.call.cuda is None:
            # a CPU device runs each operation as the host issues it
            sp.device_ms = (sp.t1 - sp.t0) * 1e-6
    if sp.own_esc is None:
        own: dict = defaultdict(int)
        for kernel, fs in sp.esc:
            bad = fs[0] > 1
            for f in fs[1:]:
                bad = bad | (f > 1)
            own[kernel] += int(bad.sum())
        sp.own_esc = dict(own)


def spans() -> list[dict]:
    """Every kept span, set-up spans first, then the last :data:`RING`
    traced calls' spans in the order they opened. Each is a dict:
    ``name``, ``id``, ``parent`` (its id, None for a root: ``pymra.call``,
    ``pymra.bwd``, a top-level annotation or a set-up span), ``call`` (the
    call id, None for a set-up span), ``level``, ``start_ns``/``end_ns``
    (``time.time_ns``; ``end_ns`` None while open), ``host_ms``,
    ``device_ms`` (the card's stream between the span's ends, idle
    included; on the CPU the host's; None while open or for a set-up
    span), ``launches`` (the port's kernel launches inside), ``escalated``
    and ``escalated_by`` (members of the jittered kernels inside that
    selected ``f > 1``, in all and by kernel), ``counts`` (the span's own
    counters, :func:`count`), ``anchor_ns`` (the call's
    clock anchor, None unless a profiler recorded). Synchronizes the cards
    the calls ran on to read their events."""
    with _lock:
        calls = list(_calls)
        setup = list(_setup)
    for dev in {c.cuda for c in calls if c.cuda is not None}:
        torch.cuda.synchronize(dev)
    out = []
    for sp in setup:
        out.append(_record(sp, {}, None))
    for call in calls:
        closed = [sp for sp in call.spans if sp.t1 is not None]
        inclusive: dict = defaultdict(lambda: defaultdict(int))
        for sp in closed:
            _resolve(sp)
            anc = sp
            while anc is not None:
                for k, n in sp.own_esc.items():
                    inclusive[anc.id][k] += n
                anc = anc.parent
        for sp in call.spans:
            out.append(_record(sp, inclusive.get(sp.id, {}), call.anchor_ns))
    return out


def _record(sp: _Span, esc: dict, anchor_ns) -> dict:
    closed = sp.t1 is not None
    return {
        "name": sp.name, "id": sp.id,
        "parent": sp.parent.id if sp.parent is not None else None,
        "call": sp.call.id if sp.call is not None else None,
        "level": sp.level, "start_ns": sp.t0,
        "end_ns": sp.t1, "host_ms": (sp.t1 - sp.t0) * 1e-6 if closed else None,
        "device_ms": sp.device_ms,
        "launches": (sp.l1 - sp.l0 if closed and sp.l0 is not None
                     else None),
        "escalated": sum(esc.values()), "escalated_by": dict(esc),
        "counts": dict(sp.counts), "anchor_ns": anchor_ns,
    }


def report(records: list[dict] | None = None) -> str:
    """A table of the spans (:func:`spans` unless given) by name and level:
    count, total and self host ms (self: minus the part its children
    cover), device stream ms, the port's kernel launches and the escalated
    members, each summed over the spans."""
    records = spans() if records is None else records
    child_ms: dict = defaultdict(float)
    for r in records:
        if r["parent"] is not None and r["host_ms"] is not None:
            child_ms[r["parent"]] += r["host_ms"]
    rows: dict = {}
    for r in records:
        if r["host_ms"] is None:
            continue
        key = (r["name"], r["level"])
        row = rows.setdefault(key, {"n": 0, "host": 0.0, "self": 0.0,
                                    "device": 0.0, "launches": 0, "esc": 0,
                                    "has_device": True})
        row["n"] += 1
        row["host"] += r["host_ms"]
        row["self"] += r["host_ms"] - child_ms[r["id"]]
        if r["device_ms"] is None:
            row["has_device"] = False
        else:
            row["device"] += r["device_ms"]
        row["launches"] += r["launches"] or 0
        row["esc"] += r["escalated"]
    lines = [f"{'span':<24s} {'level':>5s} {'n':>5s} {'host ms':>11s} "
             f"{'self ms':>11s} {'device ms':>11s} {'launches':>9s} "
             f"{'escalated':>9s}"]
    for (name, level), row in rows.items():
        dev = f"{row['device']:11.3f}" if row["has_device"] else f"{'-':>11s}"
        lines.append(
            f"{name:<24s} {'' if level is None else level:>5} {row['n']:5d} "
            f"{row['host']:11.3f} {row['self']:11.3f} {dev} "
            f"{row['launches']:9d} {row['esc']:9d}")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Trace the enclosed work with ``torch.profiler`` (the card's activity
    too when CUDA is available) and write it as a Chrome trace into
    ``logdir`` (``trace_<pid>.json``), the program's spans of the traced
    calls merged in on a track of their own, each call's put on the
    trace's clock by its ``pymra.clock`` anchor. Yields the profiler,
    whose ``key_averages()`` sums the time by operation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    since = _state["last_call"]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        _merge_spans(path, since)


def _merge_spans(path: str, since: int) -> None:
    """Add the spans of the calls after call id ``since`` to the Chrome
    trace at ``path``, the k-th anchored call at the k-th ``pymra.clock``
    event (the anchor's time read inside the range: its middle)."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    clocks = sorted((e for e in events
                     if e.get("name") == CLOCK and e.get("ph") == "X"),
                    key=lambda e: float(e["ts"]))
    with _lock:
        calls = [c for c in _calls if c.id > since and c.anchor_ns]
    records = {r["id"]: r for r in spans()}
    pid, tid = os.getpid(), 0x70796D72
    added = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": "pymra spans"}}]
    for clock, call in zip(clocks, calls):
        offset = (float(clock["ts"]) + 0.5 * float(clock.get("dur", 0.0))
                  - call.anchor_ns * 1e-3)
        for sp in call.spans:
            r = records.get(sp.id)
            if r is None or r["end_ns"] is None:
                continue
            added.append({
                "ph": "X", "cat": "pymra", "name": r["name"], "pid": pid,
                "tid": tid, "ts": r["start_ns"] * 1e-3 + offset,
                "dur": r["host_ms"] * 1e3,
                "args": {k: r[k] for k in ("call", "level", "device_ms",
                                           "launches", "escalated")}})
    events.extend(added)
    with open(path, "w") as fh:
        json.dump(trace, fh)
