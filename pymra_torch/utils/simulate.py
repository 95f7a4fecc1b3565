"""Gaussian-random-field simulators (counterpart of
``pymra_tpu/utils/simulate.py``).

``simulate_grf`` and ``make_observations`` draw from an explicit
``torch.Generator`` (the reference seeds numpy's global RNG; the JAX
package takes a key). ``simulate_grf_grid`` is numpy only and identical to
the JAX package's.
"""
from __future__ import annotations

import torch

__all__ = ["simulate_grf", "simulate_grf_grid", "make_observations"]


def simulate_grf(generator: torch.Generator, locs, covfn, mean=0.0,
                 jitter: float = 0.0, device="cuda") -> torch.Tensor:
    """Draw one sample of a GRF with covariance ``covfn`` at ``locs``.

    Dense Cholesky of the covariance times standard normals. ``covfn`` may
    be a callable ``locs -> cov`` (e.g. a :class:`pymra_torch.kernels.Kernel`),
    a dense covariance matrix, or a pre-computed Cholesky factor wrapped in
    a tuple ``("chol", L)``. ``locs``, the covariance and its factor go to
    ``device``: the card unless the caller asks for ``"cpu"`` (without a
    GPU it raises, as :class:`pymra_torch.MRAModel` does). The normals are
    drawn on the host from ``generator``, so a seed gives the same field on
    every device.

    Returns a ``[n]`` vector on ``device``.
    """
    # imported here: the sweep imports this package (its profiling), and
    # the model imports the sweep
    from pymra_torch.tree.model import _device

    dev = _device(device)
    if isinstance(covfn, tuple) and covfn[0] == "chol":
        chol = torch.as_tensor(covfn[1], device=dev)
    else:
        locs = torch.as_tensor(locs, device=dev)
        cov = (covfn(locs) if callable(covfn)
               else torch.as_tensor(covfn, device=dev))
        if jitter:
            cov = cov + jitter * torch.eye(cov.shape[0], dtype=cov.dtype,
                                           device=dev)
        chol = torch.linalg.cholesky(cov)
    z = torch.randn(chol.shape[0], generator=generator, dtype=chol.dtype)
    return chol @ z.to(dev) + mean


def make_observations(generator: torch.Generator, x, me_scale,
                      frac_obs: float = 1.0):
    """Add measurement error and knock out a fraction of values as missing:
    ``y = x + sqrt(R) * eps`` with a random subset observed and the rest
    NaN (the observation pattern of the reference's test scripts).

    Returns ``(y_obs, obs_mask)``; ``y_obs`` is NaN at missing entries.
    """
    x = torch.as_tensor(x).reshape(-1)
    n = x.shape[0]
    eps = torch.randn(n, generator=generator, dtype=x.dtype).to(x.device)
    y = x + me_scale ** 0.5 * eps
    n_obs = int(round(n * frac_obs))
    perm = torch.randperm(n, generator=generator)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[perm[:n_obs]] = True
    mask = mask.to(x.device)
    y_obs = torch.where(mask, y, torch.full_like(y, float("nan")))
    return y_obs, mask


def simulate_grf_grid(seed, nx, covfn, ny=0, lbx=0.0, ubx=1.0,
                      lby=0.0, uby=1.0, dtype="float32"):
    """Exact stationary-GRF sample on a regular 2-D grid in O(N log N).

    Circulant embedding: the grid covariance is nested-block-Toeplitz, so
    embedding it in a doubly-circulant matrix on a ``2nx x 2ny`` torus
    diagonalizes it by the 2-D DFT. One FFT of the base row gives the
    eigenvalues; one inverse FFT of spectrally-scaled complex normals gives
    TWO independent samples (real and imaginary parts); the ``ny x nx``
    corner is an exact draw of the field. Dense Cholesky is O(N^3),
    infeasible beyond ~2*10^4 points; this generates N=10^6 fields exactly.

    The embedding uses the torus minimum-image distance; for points inside
    the corner that equals the true distance, so the restriction is exact
    whenever the eigenvalues come out non-negative (tiny negative values
    from float round-off are clipped; a warning is raised if the clipped
    mass is material).

    Args:
      seed: integer seed (numpy RNG; host-side sampling).
      nx, ny: grid size, matching :func:`gen_locations_2d` (row order:
        x fastest).
      covfn: isotropic covariance of distance, e.g. a
        :class:`pymra_torch.kernels.Kernel` (called with two point sets) or
        a callable ``d -> cov(d)``.

    Returns:
      ``[nx * ny]`` numpy array in ``gen_locations_2d`` row order.
    """
    import warnings

    import numpy as np

    if not ny:
        ny = nx
    dx = (ubx - lbx) / (nx - 1) if nx > 1 else 1.0
    dy = (uby - lby) / (ny - 1) if ny > 1 else 1.0
    mx, my = 2 * nx, 2 * ny
    ix = np.minimum(np.arange(mx), mx - np.arange(mx)) * dx
    iy = np.minimum(np.arange(my), my - np.arange(my)) * dy
    d = np.sqrt(ix[None, :] ** 2 + iy[:, None] ** 2)  # [my, mx]
    # Kernel-style callable of two point sets vs plain ``d -> cov(d)``:
    # only an arity mismatch (TypeError) on the probe call falls back to
    # the distance form — any other failure inside a Kernel must surface,
    # not be silently re-tried with a distance matrix (wrong base row).
    try:
        covfn(np.zeros((1, 2)), np.zeros((1, 2)))
        two_point_sets = True
    except TypeError:
        two_point_sets = False
    if two_point_sets:
        base = np.asarray(
            covfn(np.stack([d.ravel(), np.zeros(d.size)], -1),
                  np.zeros((1, 2)))
        ).reshape(d.shape)
    else:
        base = np.asarray(covfn(d))
    lam = np.fft.fft2(base).real
    neg = lam < 0
    if neg.any():
        mass = -lam[neg].sum() / lam[~neg].sum()
        if mass > 1e-6:
            warnings.warn(
                f"circulant embedding clipped {mass:.2e} negative spectral "
                "mass; sample is approximate (enlarge the embedding)"
            )
        lam = np.maximum(lam, 0.0)
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((my, mx)) + 1j * rng.standard_normal((my, mx))
    f = np.fft.fft2(np.sqrt(lam / (mx * my)) * e)
    sample = f.real[:ny, :nx]  # one of the two independent draws
    return sample.reshape(-1).astype(dtype)
