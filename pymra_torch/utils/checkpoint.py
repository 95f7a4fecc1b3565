"""Checkpoint / resume subsystem (counterpart of
``pymra_tpu/utils/checkpoint.py``).

  * :func:`save_plan` / :func:`load_plan` — a :class:`TreePlan` in one
    ``.npz``, in the JAX package's layout: a plan saved by either package
    loads in the other. Planning a 10^6-location tree takes tens of seconds
    on the host; loading it is quick and gives the same tree everywhere
    (the ranks of a sharded run receive their plan this way).
  * :func:`save_pytree` / :func:`load_pytree` — nested dicts, lists, tuples
    and named tuples of tensors or arrays (sampler states, draws, fitted
    parameters) in one ``.npz``. The structure is stored as JSON beside the
    arrays, so a checkpoint loads with no template and nothing is pickled.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_plan", "load_plan", "save_pytree", "load_pytree"]

_LEVEL_FIELDS = ("int_knot_gidx", "int_parent", "int_path", "leaf_loc_gidx",
                 "leaf_loc_mask", "leaf_is_knot", "leaf_parent", "leaf_path")


def save_plan(path, plan) -> None:
    """Serialize a :class:`pymra_torch.tree.plan.TreePlan`.

    Saves the padded level arrays and the location coordinates: everything
    the sweep needs. The host-side ``NodeRec`` records (read only by the
    tree-walking diagnostics) are not saved; a loaded plan has empty
    ``nodes`` lists.
    """
    arrays = {"locs": np.asarray(plan.locs)}
    meta = {"r": int(plan.r), "M": int(plan.M), "J": int(plan.J),
            "n_levels": len(plan.levels)}
    for m, g in enumerate(plan.levels):
        for f in _LEVEL_FIELDS:
            arrays[f"l{m}_{f}"] = np.asarray(getattr(g, f))
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_plan(path):
    """Load a plan saved by :func:`save_plan` (or the JAX package's)."""
    from pymra_torch.tree.plan import LevelGroup, PlanConfig, TreePlan

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        levels = [LevelGroup(level=m, **{f: data[f"l{m}_{f}"]
                                         for f in _LEVEL_FIELDS})
                  for m in range(meta["n_levels"])]
        locs = data["locs"]
    return TreePlan(
        locs=locs, r=meta["r"], M=meta["M"], J=meta["J"], levels=levels,
        nodes=[[] for _ in range(meta["n_levels"])],
        config=PlanConfig(r=meta["r"], M=meta["M"], J=meta["J"]),
    )


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _encode_structure(obj, leaves: list) -> dict:
    """Encode a pytree's structure as JSON, collecting its leaves.

    Containers: dict (str/int/float/bool keys), list, tuple, None. A named
    tuple is recorded as a plain tuple (its class cannot be stored without
    pickling; pass ``like=`` to :func:`load_pytree` to get it back).
    Everything else is a leaf. The encoding is the JAX package's, so
    either package reads the other's checkpoints.
    """
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        return {"t": "dict",
                "items": [[k, _encode_structure(v, leaves)]
                          for k, v in obj.items()]}
    if isinstance(obj, tuple):
        return {"t": "tuple",
                "items": [_encode_structure(v, leaves) for v in obj]}
    if isinstance(obj, list):
        return {"t": "list",
                "items": [_encode_structure(v, leaves) for v in obj]}
    leaves.append(obj)
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode_structure(spec: dict, leaves: list):
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode_structure(v, leaves) for k, v in spec["items"]}
    if t == "tuple":
        return tuple(_decode_structure(v, leaves) for v in spec["items"])
    if t == "list":
        return [_decode_structure(v, leaves) for v in spec["items"]]
    return leaves[spec["i"]]


def _unflatten_like(like, leaves):
    """Refill ``like``'s structure (named tuples included) with ``leaves``
    in :func:`_encode_structure`'s order."""
    it = iter(leaves)

    def fill(obj):
        if obj is None:
            return None
        if isinstance(obj, dict):
            return {k: fill(v) for k, v in obj.items()}
        if _is_namedtuple(obj):
            return type(obj)(*(fill(v) for v in obj))
        if isinstance(obj, tuple):
            return tuple(fill(v) for v in obj)
        if isinstance(obj, list):
            return [fill(v) for v in obj]
        return next(it)

    out = fill(like)
    if next(it, None) is not None:
        raise ValueError("checkpoint holds more leaves than the template")
    return out


def _to_numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_pytree(path, tree) -> None:
    """Checkpoint a pytree of tensors or arrays to ``.npz``.

    Tensors are saved as their CPU values (device and ``requires_grad`` are
    not kept). :func:`load_pytree` restores the container structure with no
    template; named tuples come back as plain tuples.
    """
    leaves: list = []
    structure = _encode_structure(tree, leaves)
    arrays = {f"leaf_{i}": _to_numpy(v) for i, v in enumerate(leaves)}
    np.savez_compressed(path, __structure__=json.dumps(structure), **arrays)


def load_pytree(path, like=None):
    """Load a :func:`save_pytree` checkpoint, leaves as CPU tensors.

    ``like`` (optional) refills a template's structure instead, which
    brings named-tuple classes back.
    """
    with np.load(path, allow_pickle=False) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                  for i in range(n)]
        structure = (json.loads(str(data["__structure__"]))
                     if "__structure__" in data.files else None)
    if like is not None:
        return _unflatten_like(like, leaves)
    if structure is not None:
        return _decode_structure(structure, leaves)
    return leaves  # the JAX package's first checkpoints carried no structure
