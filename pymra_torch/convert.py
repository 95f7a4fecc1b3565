"""Carry kernels and device plans across from the JAX package, as numpy.

The JAX package's objects are taken apart on its side (``np.asarray`` of
each array) and rebuilt here, so this module imports neither JAX nor
``pymra_tpu``. Running both packages on the very same plan and
hyper-parameters is how the tests hold the port to the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pymra_torch.kernels import Kernel
from pymra_torch.tree.sweep import device_plan_from_numpy

__all__ = ["kernel_from_numpy", "device_plan_from_numpy"]


def kernel_from_numpy(name: str, params: Mapping[str, np.ndarray],
                      static: Mapping | None = None) -> Kernel:
    """The port's :class:`Kernel` from a JAX ``Kernel``'s ``name``,
    ``{k: np.asarray(v) for k, v in kernel.params.items()}`` and
    ``kernel.static``."""
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    return Kernel(name, **tensors, **dict(static or {}))
