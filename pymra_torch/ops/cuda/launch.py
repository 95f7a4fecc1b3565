"""What every wrapper of a hand-written kernel shares: the stream arguments
and the error check of a launch, and the launch counters that a span of
:mod:`pymra_torch.utils.profiling` reads at its ends.

A wrapper declares its counters with :func:`counter` (each starts at 0,
an attribute of the wrapper that the wrapper raises at each launch);
:func:`launch_count` sums every declared counter, whichever module the
wrapper lives in.
"""
from __future__ import annotations

import torch

__all__ = ["counter", "launch_count", "launched", "ptr", "where"]

#: (wrapper, attribute) of every launch counter declared
_COUNTERS: list[tuple[object, str]] = []


def counter(fn, *attrs: str):
    """Give the wrapper ``fn`` the launch counters ``attrs``, each 0, and
    count them in :func:`launch_count`; returns ``fn``."""
    for attr in attrs:
        setattr(fn, attr, 0)
        _COUNTERS.append((fn, attr))
    return fn


def launch_count() -> int:
    """The kernel launches every wrapper has counted so far."""
    return sum(getattr(fn, attr) for fn, attr in _COUNTERS)


def launched(name: str, rc: int) -> None:
    """Raise where a launch's entry point returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's data pointer, or a null one for None."""
    return None if t is None else t.data_ptr()


def where(t: torch.Tensor) -> tuple[int, int]:
    """``(device index, current stream)`` arguments of a launch: the raw
    handle of the device's current stream, without building a
    ``torch.cuda.Stream`` object for it."""
    index = t.get_device()
    return index, torch._C._cuda_getCurrentRawStream(index)
