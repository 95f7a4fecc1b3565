"""Frozen copy of the MRA planner's rules, as far as the benchmark's
configurations reach them.

The tree of a multi-resolution approximation is decided from the locations
alone (Katzfuss 2017; the reference pyMRA's ``MRANode``): a node with no
levels left, or with at most ``max(r, J)`` unused locations, is a leaf and
keeps every location of its domain; any other node picks ``r`` knots among
its unused locations and splits its domain. The rules copied here are the
ones the benchmark's trees use:

* knots: more than ``random_threshold`` unused locations -> ``r`` of them at
  random (``numpy.random.default_rng(seed).choice(n, r, replace=False)``,
  one generator drawn from in depth-first order), returned sorted;
* splits: a domain of more than ``coord_split_threshold`` locations -> the
  four mean-quadrants (``x <= mean``, ``y <= mean``; empty ones dropped) in
  the order (low, low), (low, high), (high, low), (high, high).

The k-means rules (small nodes) are not copied: a tree that reaches them
raises, so a configuration that needs them needs a reference of its own.
Nothing here imports the program under test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Node", "Tree", "plan_tree"]


@dataclasses.dataclass
class Node:
    level: int
    locs: np.ndarray  # global indices of the domain's locations, sorted
    knots: np.ndarray  # interior: its r knots; leaf: its unused locations
    parent: "Node | None"
    leaf: bool
    children: list = dataclasses.field(default_factory=list)

    def chain(self) -> np.ndarray:
        """The ancestors' knots, coarsest level first (this node's own
        knots not included)."""
        out = []
        cur = self.parent
        while cur is not None:
            out.append(cur.knots)
            cur = cur.parent
        return (np.concatenate(out[::-1]) if out
                else np.empty(0, dtype=np.int64))


@dataclasses.dataclass
class Tree:
    locs: np.ndarray
    r: int
    M: int
    J: int
    levels: list  # per level, nodes in depth-first order


def plan_tree(locs: np.ndarray, r: int, M: int, J: int = 4, seed: int = 0,
              coord_split_threshold: int = 100,
              random_threshold: int = 100) -> Tree:
    """Plan the tree of ``locs`` ``[N, 2]`` with ``r`` knots a node and
    ``M`` levels below the root."""
    locs = np.asarray(locs, dtype=np.float64)
    if locs.ndim != 2 or locs.shape[1] != 2:
        raise ValueError("the frozen planner takes [N, 2] locations")
    rng = np.random.default_rng(seed)
    levels: list = [[] for _ in range(M + 1)]

    def build(level, node_gidx, avail_gidx, parent):
        if level == M or len(avail_gidx) <= max(r, J):
            nd = Node(level, node_gidx, np.sort(avail_gidx), parent, True)
            levels[level].append(nd)
            return nd
        if len(avail_gidx) <= random_threshold:
            raise NotImplementedError(
                f"a node of {len(avail_gidx)} unused locations picks its "
                "knots by k-means, which the frozen planner does not copy")
        pick = rng.choice(len(avail_gidx), size=r, replace=False)
        knots = np.sort(avail_gidx[pick])
        nd = Node(level, node_gidx, knots, parent, False)
        levels[level].append(nd)
        if len(node_gidx) <= coord_split_threshold:
            raise NotImplementedError(
                f"a node of {len(node_gidx)} locations splits by k-means, "
                "which the frozen planner does not copy")
        new_avail = np.setdiff1d(avail_gidx, knots)
        pts = locs[node_gidx]
        gx = pts[:, 0] <= pts[:, 0].mean()
        gy = pts[:, 1] <= pts[:, 1].mean()
        for g in (gx & gy, gx & ~gy, ~gx & gy, ~gx & ~gy):
            if g.any():
                sub = node_gidx[g]
                nd.children.append(
                    build(level + 1, sub, sub[np.isin(sub, new_avail)], nd))
        return nd

    n = len(locs)
    build(0, np.arange(n), np.arange(n), None)
    return Tree(locs, r, M, J, levels)
