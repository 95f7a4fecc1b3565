"""Process groups and device meshes over ``torch.distributed`` (counterpart
of ``pymra_tpu/parallel/mesh.py``).

The reference's only parallelism is a per-subtree process fork joined by
pickling nodes over a Pipe (pyMRA/MRANode.py:64-116). Here every rank is
one process, and a named mesh over the ranks is PyTorch's own
:class:`torch.distributed.device_mesh.DeviceMesh` (``Mesh`` below): the
leaf axis of the tree plan is split over a ``"data"`` axis (each rank runs
its window of subtrees, :mod:`pymra_torch.parallel.sharded`) and chains
over a ``"chain"`` axis (:mod:`pymra_torch.parallel.chains`).
``mesh.get_group("data")`` is the process group the sweep sums over.

Multi-host placement: the ``"data"`` axis carries a collective at every
level of every evaluation, the ``"chain"`` axis nothing until the draws
are gathered. :func:`make_multihost_mesh` therefore puts the cross-host
axes outermost, so a data group holds ranks of one host (NVLink) and only
chain traffic crosses hosts.

Backends: ``nccl`` on CUDA, ``gloo`` on the CPU, by default. NCCL refuses
two ranks on one card, so several ranks time-sliced on one GPU need
``backend="gloo"``, named by the caller (gloo stages CUDA tensors through
the host and covers ``all_reduce`` and ``broadcast``, all the port uses on
CUDA tensors). The code never picks gloo for CUDA by itself.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["Mesh", "make_mesh", "make_multihost_mesh",
           "initialize_distributed", "DEFAULT_TIMEOUT"]

Mesh = DeviceMesh

#: every process group's collective timeout: a rank that stops answering
#: fails the others after this long instead of hanging them
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(backend: str | None = None, *,
                           device_type: str = "cuda",
                           init_method: str | None = None,
                           store: dist.Store | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> None:
    """Join the default process group (idempotent: a second call returns).

    With no ``init_method`` and no ``store`` the rendezvous is torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); otherwise pass ``world_size`` and ``rank`` with an
    ``init_method`` (``"tcp://host:port"``, ``"file:///path"``) or a
    ``store`` (a ``torch.distributed.FileStore``, say). ``backend``
    defaults to ``nccl`` for ``device_type="cuda"`` and ``gloo`` for
    ``"cpu"``. On CUDA the rank's current device becomes ``LOCAL_RANK``
    (else the rank) modulo the visible cards. ``timeout`` bounds every
    collective of the group.
    """
    if dist.is_initialized():
        return
    backend = backend or _default_backend(device_type)
    kwargs: dict = {"backend": backend, "timeout": timeout}
    if store is not None:
        kwargs["store"] = store
    elif init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def make_mesh(shape: dict[str, int] | None = None, device_type: str = "cuda",
              backend: str | None = None) -> DeviceMesh:
    """A named mesh over every rank of the default group.

    ``shape`` maps axis name -> size, e.g. ``{"chain": 2, "data": 4}``,
    row-major over the ranks (rank ``c * 4 + d`` sits at ``(c, d)``); the
    sizes multiply to the world size. Default: ``{"data": world_size}``.
    Joins the default group first if needed (:func:`initialize_distributed`
    from the environment, with ``backend``); a group already joined with
    another backend than a ``backend`` named here is refused.
    """
    if not dist.is_initialized():
        initialize_distributed(backend, device_type=device_type)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the {backend!r} asked for")
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def make_multihost_mesh(ici_shape: dict[str, int] | None = None,
                        dcn_shape: dict[str, int] | None = None,
                        device_type: str = "cuda",
                        backend: str | None = None) -> DeviceMesh:
    """A (hosts x cards) mesh with the cross-host axes outermost.

    Args:
      ici_shape: axis name -> size within one host, e.g. ``{"data": 4}``.
        Defaults to ``{"data": LOCAL_WORLD_SIZE}`` (torchrun's ranks per
        host; the visible cards without torchrun).
      dcn_shape: axis name -> size across hosts, e.g. ``{"chain": 2}``.
        Defaults to ``{"chain": world_size / ranks per host}``. Names must
        not overlap ``ici_shape``'s.

    torchrun numbers ranks host by host, so with the cross-host axes first
    in the row-major layout every group of a within-host axis lies on one
    host. On one host this is :func:`make_mesh` over
    ``{**dcn_shape, **ici_shape}``.
    """
    if not dist.is_initialized():
        initialize_distributed(backend, device_type=device_type)
    world = dist.get_world_size()
    if ici_shape is None:
        local = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            torch.cuda.device_count() if device_type == "cuda" else world))
        ici_shape = {"data": min(local, world)}
    if dcn_shape is None:
        dcn_shape = {"chain": world // math.prod(ici_shape.values())}
    overlap = set(ici_shape) & set(dcn_shape)
    if overlap:
        raise ValueError(f"axis names used in both ici and dcn: {overlap}")
    return make_mesh({**dcn_shape, **ici_shape}, device_type, backend)
