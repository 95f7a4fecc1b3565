"""Covariance kernels (counterpart of ``pymra_tpu/kernels.py``).

Batched torch functions of ``(locs1, locs2)`` plus hyper-parameters,
broadcast over leading node dimensions. :class:`Kernel` binds a family to
its hyper-parameters, held as 0-dim tensor buffers of an ``nn.Module``.

Python-number hyper-parameters are stored as float64. A 0-dim tensor does
not promote the dtype of the locations it meets, so a float32 sweep computes
in float32 with the value rounded once to float32 — the same rounding JAX
applies to its weakly typed Python scalars — and a float64 sweep sees the
exact value. A 0-dim CPU tensor also enters a CUDA operation as a scalar,
with no host-to-device copy.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from pymra_torch.ops.distances import dist, sqdist

__all__ = [
    "identity",
    "exponential",
    "matern12",
    "matern32",
    "matern52",
    "matern",
    "gaussian",
    "kanter",
    "determine_radius",
    "Kernel",
    "MatrixKernel",
    "get_kernel",
]


def identity(locs1, locs2=None, l=1.0, sig=1.0, circular=False):
    """White-noise kernel: 1 where the two points coincide, else 0."""
    d = dist(locs1, locs2, circular=circular)
    return sig * (d == 0.0).to(d.dtype)


def exponential(locs1, locs2=None, l=1.0, sig=1.0, circular=False):
    """Exponential kernel ``sig * exp(-d / l)``."""
    d = dist(locs1, locs2, circular=circular)
    return sig * torch.exp(-d / l)


matern12 = exponential


def matern32(locs1, locs2=None, l=1.0, sig=1.0, circular=False):
    """Matern nu=3/2: ``sig * (1 + sqrt(3) d/l) exp(-sqrt(3) d/l)``."""
    d = dist(locs1, locs2, circular=circular)
    s = math.sqrt(3.0) * d / l
    return sig * (1.0 + s) * torch.exp(-s)


def matern52(locs1, locs2=None, l=1.0, sig=1.0, circular=False):
    """Matern nu=5/2: ``sig * (1 + s + s^2/3) exp(-s)``, ``s = sqrt(5) d/l``."""
    d = dist(locs1, locs2, circular=circular)
    s = math.sqrt(5.0) * d / l
    return sig * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def gaussian(locs1, locs2=None, l=1.0, sig=1.0, circular=False):
    """Squared-exponential kernel ``sig * exp(-d^2 / (2 l^2))``."""
    if circular:
        d = dist(locs1, locs2, circular=True)
        d2 = d * d
    else:
        d2 = sqdist(locs1, locs2)
    return sig * torch.exp(-d2 / (2.0 * l * l))


def matern(locs1, locs2=None, l=1.0, sig=1.0, nu=1.5, circular=False):
    """Matern family for the closed-form smoothness values
    ``nu in {0.5, 1.5, 2.5, inf}``."""
    if nu == 0.5:
        return exponential(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == 1.5:
        return matern32(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == 2.5:
        return matern52(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == math.inf:
        return gaussian(locs1, locs2, l=l, sig=sig, circular=circular)
    raise NotImplementedError(
        f"matern: general nu={nu} needs the Bessel-K port of "
        "pymra_tpu/ops/special.py (ROADMAP queue 1, sweep side paths)")


def kanter(locs1, locs2=None, radius=1.0, circular=False):
    """Kanter compact-support taper (reference ``KanterCovFun``); an int
    ``radius`` is an ensemble size converted by :func:`determine_radius`
    with the x-grid spacing."""
    if isinstance(radius, (int, np.integer)) and not isinstance(radius, bool):
        arr = np.asarray(torch.as_tensor(locs1).cpu())
        xs = np.sort(np.unique(arr[:, 0]))
        h = float(xs[1] - xs[0])
        ndim = len(np.unique(arr[:, 1])) if arr.shape[1] > 1 else 1
        radius = determine_radius(int(radius), h, ndim=ndim)

    d = dist(locs1, locs2, circular=circular) / radius
    # guard the removable singularity at d=0; the limit of the expression is 1
    safe = torch.where(d == 0.0, torch.ones_like(d), d)
    pid2 = 2.0 * math.pi * safe
    r = ((1.0 - safe) * torch.sin(pid2) / pid2
         + (1.0 - torch.cos(pid2)) / (math.pi * pid2))
    r = torch.where(d == 0.0, torch.ones_like(r), r)
    # support is d < 1 (the analytic value at d == 1 is exactly 0)
    return torch.where(d >= 1.0, torch.zeros_like(r), r)


def determine_radius(k: int, h: float, ndim: int = 2) -> float:
    """Taper radius giving ~``k`` nonzeros per row on a grid with spacing
    ``h`` (reference MRATools.py:329-388)."""
    if ndim == 1:
        return int(k / 2) * h
    if k == 0:
        raise ValueError("Ensemble size must be strictly positive")
    s = math.floor(math.sqrt(k))
    sf = s - 1 if s % 2 == 0 else s
    if k == sf**2:
        return h * 1.01 * (sf - 1) / 2.0 * math.sqrt(2.0)
    base = (sf - 1) / 2.0

    intervals = [sf**2]
    while intervals[-1] < (sf + 2) ** 2:
        if len(intervals) == 1 or ((sf + 2) ** 2 - intervals[-1] == 4):
            intervals.append(intervals[-1] + 4)
        else:
            intervals.append(intervals[-1] + 8)
    intervals = np.array(intervals)

    ind = int(intervals.searchsorted(k))
    middle = (intervals[ind - 1] + intervals[ind]) / 2.0
    app_ind = ind - 1 if k <= middle else ind
    if app_ind == 0:
        return h * base * math.sqrt(2.0) + h * 0.01
    return h * math.sqrt((base + 1) ** 2 + (app_ind - 1) ** 2) + h * 0.01


_REGISTRY: dict[str, Callable] = {
    "identity": identity,
    "exponential": exponential,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "matern": matern,
    "gaussian": gaussian,
    "kanter": kanter,
}


def get_kernel(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown kernel {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


class MatrixKernel:
    """Dense pre-computed covariance matrix (not ported yet)."""

    def __init__(self, matrix):
        raise NotImplementedError(
            "MatrixKernel (index-mode dense covariance) is a sweep side path "
            "still to be ported (ROADMAP queue 1, sweep side paths)")


def _as_param(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray) or isinstance(v, np.generic):
        return torch.as_tensor(np.asarray(v))
    return torch.tensor(float(v), dtype=torch.float64)


class Kernel(nn.Module):
    """A kernel family bound to its hyper-parameters.

    ``Kernel('matern32', l=0.3, sig=1.0)`` is a callable
    ``(locs1 [..., p, d], locs2 [..., q, d]) -> [..., p, q]``. ``nu`` and
    ``circular`` select code structure and stay plain Python values; every
    other parameter is a tensor buffer (int ``radius`` of ``kanter`` stays
    an int: it is an ensemble size, not a length).
    """

    STATIC_PARAMS = ("nu", "circular")

    def __init__(self, name: str, **params):
        super().__init__()
        self.name = name
        self._fn = get_kernel(name)
        self.static = {k: params.pop(k) for k in list(params)
                       if k in self.STATIC_PARAMS}
        if name == "kanter" and isinstance(params.get("radius"),
                                           (int, np.integer)):
            self.static["radius"] = params.pop("radius")
        self._param_names = tuple(sorted(params))
        for k in self._param_names:
            self.register_buffer(k, _as_param(params[k]))

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._param_names}

    def forward(self, locs1, locs2=None):
        return self._fn(locs1, locs2, **self.params, **self.static)

    def replace(self, **params) -> "Kernel":
        new = dict(self.params)
        new.update(self.static)
        new.update(params)
        return Kernel(self.name, **new)

    def extra_repr(self) -> str:
        return ", ".join([repr(self.name)] + [
            f"{k}={v}" for k, v in {**self.params, **self.static}.items()])
