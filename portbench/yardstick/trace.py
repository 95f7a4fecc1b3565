"""Reduction of a ``torch.profiler`` trace of a few steady calls to what the
per-layer metrics read: device activities by name and by owner, the busy
union, the idle gaps and what the host was doing in them.

Times are the profiler's, in microseconds on one clock for host and device.
The port's own kernels are told from library kernels by name: the names of
the ``__global__`` functions in the program's CUDA sources.
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np

__all__ = ["own_kernel_names", "Trace", "profile_calls", "STRETCH"]

#: the host span around the profiled calls
STRETCH = "portbench.stretch"
#: the host span around each call
CALL = "portbench.call"

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?([A-Za-z_]\w*)")


def own_kernel_names(root: str) -> list[str]:
    """Every ``__global__`` function of the program's CUDA sources."""
    names = set()
    pattern = os.path.join(root, "pymra_torch", "ops", "cuda", "csrc", "*.cu*")
    for path in glob.glob(pattern):
        with open(path) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return sorted(names)


def short_name(name: str) -> str:
    """A kernel's function name without ``void``, arguments or template
    arguments, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)[:96] or name[:96]


class Trace:
    """Device activities (``name``, ``start``, ``end``) and host operations
    of one profiled stretch of ``calls`` calls."""

    def __init__(self, device_events, host_events, stretch, calls: int,
                 own_names):
        self.calls = calls
        self.t0, self.t1 = stretch
        dev = [e for e in device_events
               if e[2] > self.t0 and e[1] < self.t1]
        self.dev_names = [e[0] for e in dev]
        self.dev_start = np.array([e[1] for e in dev], dtype=np.float64)
        self.dev_end = np.array([e[2] for e in dev], dtype=np.float64)
        self.is_kernel = np.array(
            [not n.startswith(("Memcpy", "Memset")) for n in self.dev_names],
            dtype=bool)
        own = (re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
            map(re.escape, own_names)) + r")(?![A-Za-z0-9_])")
            if own_names else None)
        self.own_of = [own.search(n).group(1) if own and own.search(n)
                       else None for n in self.dev_names]
        self.host = host_events

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def durations(self) -> np.ndarray:
        return self.dev_end - self.dev_start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device activities, clipped to the stretch."""
        order = np.argsort(self.dev_start)
        out = []
        for i in order:
            a = max(self.dev_start[i], self.t0)
            b = min(self.dev_end[i], self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def kernel_count(self) -> int:
        return int(self.is_kernel.sum())

    def kernel_us(self, own: bool | None = None, name: str | None = None
                  ) -> float:
        """Summed device time of the kernels: all, the port's own
        (``own=True``), the library's (``own=False``), or one own kernel by
        name."""
        d = self.durations()
        total = 0.0
        for i, o in enumerate(self.own_of):
            if not self.is_kernel[i]:
                continue
            if name is not None and o != name:
                continue
            if own is True and o is None or own is False and o is not None:
                continue
            total += d[i]
        return float(total)

    def kernel_launches(self, name: str) -> int:
        return sum(1 for i, o in enumerate(self.own_of)
                   if o == name and self.is_kernel[i])

    def device_ops(self, top: int = 10) -> list:
        """``[[name, seconds], ...]``: the device activities that took most
        time in the stretch, summed by short name."""
        acc: dict = {}
        for name, d in zip(self.dev_names, self.durations()):
            key = short_name(name)
            acc[key] = acc.get(key, 0.0) + float(d) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10, longest: int = 500) -> list:
        """``[[what the host was doing, seconds], ...]``: the idle gaps of
        the device in the stretch, the ``longest`` of them attributed to
        the innermost host operation running at their middle and summed by
        its name."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:longest]
        if not gaps:
            return []
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        hd = he - hs
        acc: dict = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            what = ("(Python between operations)" if not len(inside)
                    else self.host[inside[np.argmin(hd[inside])]][0])
            acc[what] = acc.get(what, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]


def profile_calls(call, n: int, own_names, sync) -> Trace:
    """Run ``call(i)`` for ``i < n`` under ``torch.profiler`` (host and
    device activities) inside one host span, synchronise, and reduce the
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            for i in range(n):
                with record_function(CALL):
                    call(i)
            sync()
    device, host, stretch = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in (STRETCH, CALL):
                continue  # the host spans' ranges on the device's timeline
            device.append((e.name, float(tr.start), float(tr.end)))
        elif e.name == STRETCH:
            stretch = (float(tr.start), float(tr.end))
        elif e.name != CALL:
            host.append((e.name, float(tr.start), float(tr.end)))
    if stretch is None:
        raise RuntimeError("the profile holds no stretch span")
    return Trace(device, host, stretch, n, own_names)
