"""Covariance kernels (counterpart of ``pymra_tpu/kernels.py``).

Batched torch functions of ``(locs1, locs2)`` plus hyper-parameters,
broadcast over leading node dimensions. :class:`Kernel` binds a family to
its hyper-parameters, held as 0-dim tensor buffers of an ``nn.Module``, or
as ``[C]`` buffers for ``C`` parameter sets at once (a chains, particles or
draws axis, the port's form of ``jax.vmap`` over the hyper-parameters): the
family then broadcasts that axis in front of the node dimensions.

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
from pymra_torch.ops.special import matern_cuda, matern_general
from pymra_torch.utils import profiling as _prof

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
    """Matern family: the closed forms for ``nu in {0.5, 1.5, 2.5, inf}``,
    any other smoothness through the Bessel K: on the card one launch of
    the kernel :func:`pymra_torch.ops.special.matern_cuda` for every
    parameter set, on the CPU its twin
    :func:`pymra_torch.ops.special.matern_general`; differentiable in
    ``l`` and ``sig``. ``nu`` must be a Python number: it fixes the Bessel
    recurrence's depth. Inside a traced call
    (:mod:`pymra_torch.utils.profiling`) each Bessel-K evaluation is a span
    ``pymra.cov`` with its entries times sets in the counter
    ``cov_entries``, and those whose Bessel pair took the series or the
    continued fraction in ``cov_fallback_entries`` (on the card those the
    kernel's table did not cover, on the CPU every one with ``s > 0``)."""
    if isinstance(nu, torch.Tensor):
        raise TypeError(
            "matern: nu must be a static Python float — it fixes the Bessel "
            "recurrence depth (differentiate l/sig instead)")
    if nu == 0.5:
        return exponential(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == 1.5:
        return matern32(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == 2.5:
        return matern52(locs1, locs2, l=l, sig=sig, circular=circular)
    if nu == math.inf:
        return gaussian(locs1, locs2, l=l, sig=sig, circular=circular)
    sp = _prof.begin("pymra.cov") if _prof.ON else None
    if torch.as_tensor(locs1).is_cuda:
        out = matern_cuda(locs1, locs2, l, sig, float(nu), circular)
    else:
        out = matern_general(dist(locs1, locs2, circular=circular), l, sig,
                             float(nu))
    if sp is not None:
        _prof.count("cov_entries", out.numel())
        _prof.end(sp)
    return out


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


class MatrixKernel(nn.Module):
    """Covariance given as a dense pre-computed ``[N, N]`` matrix.

    The reference's ``isinstance(cov, np.matrix)`` path: sub-blocks are
    gathered from ``matrix`` by location index instead of a kernel being
    evaluated at coordinates. Pair it with an index-mode device plan
    (``MRAModel(..., index_mode=True)``, whose points are ``[..., 1]`` long
    location indices); ``MRATree`` sets that up when ``cov`` is a matrix.
    The matrix is a buffer, kept as given (a tensor is not copied): one
    that ``requires_grad`` receives the gradient of whatever the kernel's
    blocks feed.
    """

    def __init__(self, matrix):
        super().__init__()
        self.register_buffer("matrix", _as_param(matrix))

    #: no hyper-parameter, so no batch of them
    batch_shape = ()

    def forward(self, xi, yi=None):
        if self.matrix.dim() != 2:
            raise NotImplementedError(
                f"MatrixKernel: a [N, N] matrix, got "
                f"{tuple(self.matrix.shape)}; it has no hyper-parameter to "
                "batch, so there is no batched MatrixKernel")
        if yi is None:
            yi = xi
        i = torch.as_tensor(xi)[..., 0].long()
        j = torch.as_tensor(yi)[..., 0].long()
        return self.matrix[i[..., :, None], j[..., None, :]]

    def extra_repr(self) -> str:
        return f"shape={tuple(self.matrix.shape)}"


def _as_param(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray) or isinstance(v, np.generic):
        return torch.as_tensor(np.asarray(v))
    return torch.tensor(float(v), dtype=torch.float64)


def _split_name(name: str) -> tuple[str, dict]:
    """``'matern(nu=0.8)'`` -> ``('matern', {'nu': 0.8})``: a family with
    its smoothness written after it; a plain family name comes back with
    nothing."""
    family, sep, rest = name.partition("(")
    if not sep:
        return name, {}
    key, eq, value = (x.strip() for x in rest.removesuffix(")").partition(
        "="))
    if not rest.endswith(")") or key != "nu" or not eq:
        raise ValueError(f"Kernel name {name!r}: expected "
                         "'family(nu=<number>)'")
    return family.strip(), {"nu": float(value)}


class Kernel(nn.Module):
    """A kernel family bound to its hyper-parameters.

    ``Kernel('matern32', l=0.3, sig=1.0)`` is a callable
    ``(locs1 [..., p, d], locs2 [..., q, d]) -> [..., p, q]``. ``nu`` and
    ``circular`` select code structure and stay plain Python values; every
    other parameter is a tensor buffer (int ``radius`` of ``kanter`` stays
    an int: it is an ensemble size, not a length). The smoothness may also
    be written in the name, so that one string names a covariance (as a
    configuration file does): ``Kernel('matern(nu=0.8)', l=0.3)`` is
    ``Kernel('matern', nu=0.8, l=0.3)``.

    A parameter of shape ``[C]`` makes the kernel batched
    (:attr:`batch_shape` ``(C,)``): the call returns ``[C, ..., p, q]``,
    one covariance per parameter set, 0-dim parameters shared by all.
    """

    STATIC_PARAMS = ("nu", "circular")

    def __init__(self, name: str, **params):
        super().__init__()
        name, named = _split_name(name)
        self.name = name
        self._fn = get_kernel(name)
        self.static = {k: params.pop(k) for k in list(params)
                       if k in self.STATIC_PARAMS}
        both = set(named) & set(self.static)
        if both:
            raise ValueError(f"Kernel {name!r}: {sorted(both)} given both in "
                             "the name and as arguments")
        self.static.update(named)
        if name == "kanter" and isinstance(params.get("radius"),
                                           (int, np.integer)):
            self.static["radius"] = params.pop("radius")
        self._param_names = tuple(sorted(params))
        for k in self._param_names:
            self.register_buffer(k, _as_param(params[k]))

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._param_names}

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """``(C,)`` when a parameter has a leading ``[C]`` axis, else
        ``()``. Every batched parameter must have the same one axis."""
        shapes = {tuple(v.shape) for v in self.params.values() if v.dim()}
        if not shapes:
            return ()
        if len(shapes) > 1 or len(next(iter(shapes))) != 1:
            raise ValueError(
                f"Kernel {self.name!r}: batched parameters need one common "
                f"[C] axis, got shapes "
                f"{ {k: tuple(v.shape) for k, v in self.params.items()} }")
        return shapes.pop()

    def forward(self, locs1, locs2=None):
        params = self.params
        batch = self.batch_shape
        if batch:
            # [C] -> [C, 1, ..., 1]: the axis goes in front of the nodes.
            # Rounded to the locations' dtype and moved to their device
            # first, as a 0-dim parameter meets them: a [C] tensor would
            # otherwise promote a float32 sweep to float64
            locs1 = torch.as_tensor(locs1)
            nd = max(locs1.dim(), 0 if locs2 is None
                     else torch.as_tensor(locs2).dim())
            to = dict(device=locs1.device)
            if locs1.is_floating_point():
                to["dtype"] = locs1.dtype
            params = {k: v.to(**to).reshape(batch + (1,) * nd) if v.dim()
                      else v for k, v in params.items()}
        return self._fn(locs1, locs2, **params, **self.static)

    def replace(self, **params) -> "Kernel":
        new = dict(self.params)
        new.update(self.static)
        new.update(params)
        return Kernel(self.name, **new)

    def extra_repr(self) -> str:
        return ", ".join([repr(self.name)] + [
            f"{k}={v}" for k, v in {**self.params, **self.static}.items()])
