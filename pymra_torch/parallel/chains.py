"""Chain parallelism over the ranks of a mesh axis (counterpart of
``pymra_tpu/parallel/chains.py``).

HMC and NUTS chains are independent: each rank of the ``"chain"`` axis
runs its share of the chains (with a ``"data"`` axis beside it on a
sharded log-density, :func:`pymra_torch.parallel.sharded.
sharded_loglik_fn`: one chain after another, or, with ``batched=True``
there and in the sampler, all of the rank's chains in lockstep through one
batched sharded sweep a step, the JAX package's ``vmap`` over chains
inside ``shard_map`` over the data), and the draws are gathered at the
end. A rank's
chains draw what the same chains draw in one process: the samplers derive
one generator per chain from the caller's
(``pymra_torch.infer._flat.chain_generators``), and
:func:`shard_generators` hands each rank its chains' generators.

The chain axis's collectives are a broadcast and a sum; both run on gloo
for CPU tensors and on NCCL for CUDA ones (the draws are moved to the
mesh's device type for them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from pymra_torch.infer._flat import chain_generators
from pymra_torch.parallel.mesh import Mesh

__all__ = ["shard_chains", "replicate", "gather_chains", "shard_generators"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _axis(mesh: Mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _window(n: int, index: int, size: int) -> slice:
    if n % size:
        raise ValueError(f"{n} chains do not split over {size} ranks")
    k = n // size
    return slice(index * k, (index + 1) * k)


def shard_chains(pytree, mesh: Mesh, axis: str = "chain"):
    """This rank's slice of every leaf's leading (chains) axis: rank ``i``
    of ``axis`` takes chains ``[i k, (i + 1) k)``, ``k = chains / size``."""
    _, index, size = _axis(mesh, axis)
    return _map(lambda t: t[_window(t.shape[0], index, size)], pytree)


def shard_generators(generator: torch.Generator, n_chains: int, mesh: Mesh,
                     axis: str = "chain") -> list[torch.Generator]:
    """The per-chain generators of this rank's chains (see
    :func:`shard_chains`), as a sampler would derive them for all
    ``n_chains`` from ``generator``: pass the list as the sampler's
    ``generator``."""
    _, index, size = _axis(mesh, axis)
    return chain_generators(generator, n_chains)[_window(n_chains, index,
                                                         size)]


def _collective_device(mesh: Mesh) -> torch.device:
    return torch.device(mesh.device_type if mesh.device_type != "cuda"
                        else f"cuda:{torch.cuda.current_device()}")


def replicate(pytree, mesh: Mesh):
    """Every leaf broadcast from the mesh's first rank to all its ranks."""
    src = int(mesh.mesh.reshape(-1)[0])
    dev = _collective_device(mesh)

    def bcast(t):
        buf = t.detach().to(dev).contiguous().clone()
        dist.broadcast(buf, src=src)
        return buf.to(t.device)

    return _map(bcast, pytree)


def gather_chains(pytree, mesh: Mesh, axis: str = "chain"):
    """Every rank's chains of every leaf, concatenated in rank order on
    every rank of ``axis`` (the inverse of :func:`shard_chains`). Each
    rank's block is placed in a zero buffer and the buffers are summed:
    exact, since every entry has one owner."""
    group, index, size = _axis(mesh, axis)
    dev = _collective_device(mesh)

    def gather(t):
        k = t.shape[0]
        buf = t.new_zeros((k * size,) + tuple(t.shape[1:]), device=dev)
        buf[index * k:(index + 1) * k] = t.detach().to(dev)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)

    return _map(gather, pytree)
