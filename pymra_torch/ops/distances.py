"""Pairwise-distance primitives (counterpart of ``pymra_tpu/ops/distances.py``).

Batched and broadcastable over leading node dimensions. For spatial points
(d <= 4) the squared distance is summed from direct coordinate differences:
the ``|a|^2 + |b|^2 - 2 a.b`` expansion loses all float32 significance when
points are ~1e-3 apart on a unit domain, which is what fine-grid leaf blocks
are made of.
"""
from __future__ import annotations

import torch

__all__ = ["sqdist", "dist"]


def _as2d(x: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x[:, None] if x.ndim == 1 else x


def sqdist(locs1: torch.Tensor, locs2: torch.Tensor | None = None
           ) -> torch.Tensor:
    """``[..., n, d]`` x ``[..., m, d]`` -> ``[..., n, m]`` squared distances."""
    a = _as2d(locs1)
    self_pair = locs2 is None
    b = a if self_pair else _as2d(locs2)
    d = a.shape[-1]
    if d <= 4:
        # one [..., n, m] temporary per coordinate instead of a
        # [..., n, m, d] difference tensor; same summation order
        out = None
        for k in range(d):
            diff = a[..., :, None, k] - b[..., None, :, k]
            out = diff * diff if out is None else out + diff * diff
        return out
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    d2 = torch.clamp(a2 + b2 - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)
    if self_pair:
        # exact zeros on the diagonal (cancellation leaves ~eps residue,
        # which would break kernels that test d == 0)
        n = a.shape[-2]
        d2 = d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))
        d2 = 0.5 * (d2 + d2.transpose(-1, -2))
    return d2


def dist(locs1: torch.Tensor, locs2: torch.Tensor | None = None,
         circular: bool = False) -> torch.Tensor:
    """Euclidean distance matrix; with ``circular=True`` the 1-D
    unit-interval wrap-around metric ``min(|a-b|, 1-|a-b|)``."""
    if circular:
        a = _as2d(locs1)[..., :, 0]
        b = a if locs2 is None else _as2d(locs2)[..., :, 0]
        diff = torch.abs(a[..., :, None] - b[..., None, :])
        return torch.minimum(diff, 1.0 - diff)
    return torch.sqrt(sqdist(locs1, locs2))
