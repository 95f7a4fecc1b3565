"""Host-side static tree planner (counterpart of ``pymra_tpu/tree/plan.py``).

A copy of the JAX package's numpy planner, kept in the port because
importing any ``pymra_tpu`` module imports JAX, and the port must run where
JAX is not installed. It must plan bit-identical trees: the RNG streams and
the call order are the JAX planner's, and ``tests/test_torch_plan.py``
holds every padded array equal. The one difference is ``kmeans_impl='native'``, which
raises when the C++ library cannot be built instead of silently switching to
the numpy Lloyd (a different tree).

The reference interleaves structure discovery (knot selection, domain
partitioning) with numerics inside one recursive constructor
(pyMRA/MRANode.py:23-116). Structure is data-independent metadata, so it is
decided **once on host** (numpy) and emitted as a static, padded "plan" —
per-level index arrays over which the device-side sweep
(:mod:`pymra_torch.tree.sweep`) runs as batched kernels.

Planning semantics mirror the reference:

  * tree-shape defaults and the max-M formula  (pyMRA/MRATree.py:31-50;
    the broken 1-D default ``self.J==r+1`` comparison at MRATree.py:33 is
    fixed to an assignment here)
  * knot selection        (pyMRA/MRANode.py:179-205 ``_getKnotsInds``):
    1-D interior percentiles; 2-D k-means centers snapped to candidate
    locations; seeded random choice above ``random_threshold`` candidates
    (the reference uses the *unseeded* global RNG there — SURVEY quirk #5)
  * domain partitioning   (pyMRA/MRANode.py:213-340): coordinate splits
    (thirds in 1-D / mean-quadrants in 2-D) for nodes larger than
    ``coord_split_threshold``, else J-splits — knots-at-boundaries in the
    exact-screening 1-D ``J == r+1`` mode, k-means clusters otherwise
  * leaf rule             (pyMRA/MRANode.py:34-47): a node with no levels
    left or at most ``max(r, J)`` unused locations becomes a leaf and turns
    every remaining location into a knot.

Nodes of each level are emitted in DFS order, so every subtree occupies a
contiguous range of the leaf axis.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["PlanConfig", "TreePlan", "LevelGroup", "NodeRec", "build_plan",
           "derive_tree_shape"]


# ---------------------------------------------------------------------------
# configuration & shape derivation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Knobs of the planner; defaults reproduce reference behaviour."""

    r: int
    M: int = -1
    J: int = -1
    seed: int = 0
    #: nodes with more locations than this use coordinate splits instead of
    #: J-splits (reference ``self.N > 1e2`` at MRANode.py:57)
    coord_split_threshold: int = 100
    #: knot candidates above this count are sampled randomly instead of via
    #: k-means (reference ``len(notKnots) > 1e2`` at MRANode.py:37)
    random_threshold: int = 100
    #: 'auto' uses sklearn's KMeans (random_state=0) for reference-identical
    #: partitions when True, the native C++ core when False
    use_sklearn: bool = True
    #: k-means implementation: 'auto' (sklearn for reference parity if
    #: available, else native C++), 'sklearn', 'native' (the C++ core in
    #: csrc/planner.cpp — fastest, used for very large plans; raises when
    #: it cannot be built), or 'numpy'
    kmeans_impl: str = "auto"


def derive_tree_shape(n: int, r: int, d: int, M: int = -1, J: int = -1
                      ) -> tuple[int, int]:
    """Resolve (M, J) defaults and clamp M to the max the grid supports.

    Reference: pyMRA/MRATree.py:31-50. The 1-D default is ``J = r + 1`` (the
    reference's ``self.J==r+1`` at MRATree.py:33 is a no-op comparison that
    crashes later — fixed here, SURVEY quirk #1); 2-D default is ``J = 4``.
    ``maxM = floor(log(N*J/r + 1) / log(J)) - 1`` (MRATree.py:41-43).
    """
    if J < 0:
        J = r + 1 if d == 1 else 4
    if J < 2:
        raise ValueError(f"J must be >= 2, got {J}")
    max_m = int(np.log(n * J / r + 1) / np.log(J)) - 1
    max_m = max(max_m, 0)
    if M < 0:
        M = max_m
    elif M > max_m:
        logger.warning(
            "Requested M=%d is too large for N=%d; clamping to M=%d", M, n, max_m
        )
        M = max_m
    return M, J


def tpu_shaped_M(n: int, r: int, d: int = 2, J: int = -1,
                 leaf_target: int = 64) -> int:
    """Pick the resolution depth that lands leaves near ``leaf_target``.

    The reference's depth formula (``derive_tree_shape``) grows M until
    leaves shrink to ~r points. Wider leaves suit batched accelerator
    kernels better (fewer, fuller tiles), and statistically each leaf's
    covariance block is exact, so trading the deepest (least informative —
    Katzfuss 2017 resolution decay) knot level for larger exact blocks
    loses nothing at equal r. The N=10^6 bench tree (1000^2 grid, r=8)
    uses this depth: M=7, leaves of P=64.

    Returns the M whose ``J^M`` leaves average closest to ``leaf_target``
    points, clamped to the reference maximum.
    """
    if J < 0:
        J = r + 1 if d == 1 else 4
    M = max(0, int(round(np.log(max(n / leaf_target, 1.0)) / np.log(J))))
    return min(M, derive_tree_shape(n, r, d, -1, J)[0])


# ---------------------------------------------------------------------------
# k-means (host-side; used for knot selection and J-splits)
# ---------------------------------------------------------------------------

def _kmeans_lloyd(points: np.ndarray, k: int, rng: np.random.Generator,
                  n_iter: int = 50) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic k-means++ / Lloyd's algorithm. Returns (centers, labels)."""
    n = len(points)
    # k-means++ seeding
    centers = np.empty((k, points.shape[1]))
    centers[0] = points[rng.integers(n)]
    d2 = np.sum((points - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(n, 1.0 / n)
        centers[i] = points[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((points - centers[i]) ** 2, axis=1))
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(n_iter):
        dists = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_labels = dists.argmin(axis=1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            sel = labels == j
            if sel.any():
                centers[j] = points[sel].mean(axis=0)
    return centers, labels


def _kmeans(points: np.ndarray, k: int, cfg: PlanConfig
            ) -> tuple[np.ndarray, np.ndarray]:
    impl = cfg.kmeans_impl
    if impl == "auto":
        impl = "sklearn" if cfg.use_sklearn else "native"
    if impl == "sklearn":
        try:
            from sklearn.cluster import KMeans

            # exact reference call signature (MRANode.py:195,316) so planned
            # trees match the reference's on deterministic configs
            km = KMeans(n_clusters=k, random_state=0).fit(points)
            return km.cluster_centers_, km.labels_.astype(np.int64)
        except ImportError:
            impl = "native"
    if impl == "native":
        from pymra_torch.ops import native

        return native.kmeans(points, k, seed=cfg.seed)
    return _kmeans_lloyd(points, k, np.random.default_rng(cfg.seed))


# ---------------------------------------------------------------------------
# host tree records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeRec:
    """Host-side record of one tree node (diagnostics / basis assembly keep
    these; the numeric sweep only sees the padded arrays)."""

    level: int
    index_in_level: int  # DFS position among nodes of this level
    loc_gidx: np.ndarray  # global indices of all locations in this domain
    knot_gidx: np.ndarray  # global indices of this node's knots
    parent: "NodeRec | None"
    children: list = dataclasses.field(default_factory=list)
    is_leaf: bool = False

    @property
    def n_locs(self) -> int:
        return len(self.loc_gidx)

    @property
    def n_knots(self) -> int:
        return len(self.knot_gidx)

    @property
    def node_id(self) -> str:
        """Reference-style node ID: root ``'r'``, child ``j`` (1-based)
        appends ``str(j)`` (pyMRA/MRANode.py node IDs, used by the
        ``MRATree.getB_lk`` / ``getKNode`` diagnostics)."""
        if self.parent is None:
            return "r"
        j = self.parent.children.index(self)
        return self.parent.node_id + str(j + 1)


# ---------------------------------------------------------------------------
# knot selection  (reference _getKnotsInds, MRANode.py:179-205)
# ---------------------------------------------------------------------------

def _select_knots(locs: np.ndarray, avail_gidx: np.ndarray, r: int,
                  cfg: PlanConfig, rng: np.random.Generator) -> np.ndarray:
    """Pick ``r`` knot locations among the available (not-yet-used) ones.

    Returns global indices, ordered by global index (the reference re-orders
    knots to location order at MRANode.py:204).
    """
    avail = locs[avail_gidx]
    n_avail = len(avail_gidx)
    if r >= n_avail:
        return np.sort(avail_gidx)

    if locs.shape[1] == 1:
        # r interior percentiles with nearest-rank interpolation
        vals = avail[:, 0]
        order = np.argsort(vals, kind="stable")
        qs = np.array([100.0 * i / (r + 1) for i in range(1, r + 1)])
        ranks = np.unique(np.round(qs / 100.0 * (n_avail - 1)).astype(int))
        chosen = order[ranks]
        chosen = _top_up(chosen, n_avail, r, order)
        return np.sort(avail_gidx[chosen])

    if n_avail > cfg.random_threshold:
        # the reference uses unseeded np.random.choice here (MRANode.py:191-193,
        # SURVEY quirk #5); we thread an explicit seeded generator
        chosen = rng.choice(n_avail, size=r, replace=False)
        return np.sort(avail_gidx[chosen])

    centers, _ = _kmeans(avail, r, cfg)
    d = ((avail[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    chosen = np.unique(d.argmin(axis=0))
    chosen = _top_up(chosen, n_avail, r, np.argsort(d.min(axis=1)))
    return np.sort(avail_gidx[chosen])


def _top_up(chosen: np.ndarray, n_avail: int, r: int,
            preference: np.ndarray) -> np.ndarray:
    """Ensure exactly ``r`` distinct picks (snapping/rounding can collide)."""
    if len(chosen) >= r:
        return chosen[:r]
    extra = [i for i in preference if i not in set(chosen.tolist())]
    return np.concatenate([chosen, np.array(extra[: r - len(chosen)], dtype=int)])


# ---------------------------------------------------------------------------
# domain partitioning  (reference _getSplits / _getJSplits,
#                       MRANode.py:213-340)
# ---------------------------------------------------------------------------

def _coord_splits(locs: np.ndarray, node_gidx: np.ndarray) -> list[np.ndarray]:
    """Coordinate splits for large nodes: 1-D thirds / 2-D mean-quadrants.

    Reference ``_getSplits`` (MRANode.py:213-242) uses strict inequalities
    that can silently drop boundary points; here boundary points are binned
    closed-below so the children always partition the parent exactly.
    """
    pts = locs[node_gidx]
    if locs.shape[1] == 1:
        lo, hi = np.percentile(pts[:, 0], (33, 66))
        b0 = pts[:, 0] <= lo
        b1 = (~b0) & (pts[:, 0] <= hi)
        b2 = ~(b0 | b1)
        groups = [b0, b1, b2]
    else:
        mx, my = pts[:, 0].mean(), pts[:, 1].mean()
        gx, gy = pts[:, 0] <= mx, pts[:, 1] <= my
        groups = [gx & gy, gx & ~gy, ~gx & gy, ~gx & ~gy]
    return [node_gidx[g] for g in groups if g.any()]


def _j_splits(locs: np.ndarray, node_gidx: np.ndarray, knot_gidx: np.ndarray,
              avail_gidx: np.ndarray, J: int, cfg: PlanConfig
              ) -> list[np.ndarray]:
    """J-way splits for small nodes (reference ``_getJSplits``,
    MRANode.py:289-340).

    In the 1-D exact-screening mode (``J == r+1`` and enough points) the
    domain is cut *at the knots*: each knot becomes the first location of the
    next child — the configuration for which MRA reproduces exact kriging
    under the exponential kernel (exploited by pyMRA/tests/unit-tests.py).
    Otherwise the unused locations are k-means clustered into J groups and
    already-used knots are attached to the nearest cluster center.
    """
    n = len(node_gidx)
    r = len(knot_gidx)
    J_eff = min(J, len(avail_gidx))
    one_d = locs.shape[1] == 1

    if one_d and J_eff == r + 1 and n >= J_eff + r:
        # positions of knots within the (location-sorted) node domain
        order = np.argsort(locs[node_gidx][:, 0], kind="stable")
        sorted_gidx = node_gidx[order]
        knot_pos = np.flatnonzero(np.isin(sorted_gidx, knot_gidx))
        pieces = np.split(np.arange(n), knot_pos)
        return [sorted_gidx[p] for p in pieces if len(p)]

    avail = locs[avail_gidx]
    centers, labels = _kmeans(avail, J_eff, cfg)
    used_gidx = np.setdiff1d(node_gidx, avail_gidx)
    if len(used_gidx):
        d = ((locs[used_gidx][:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        used_labels = d.argmin(axis=1)
    else:
        used_labels = np.empty(0, dtype=np.int64)
    subdomains = []
    for j in range(J_eff):
        inds = np.concatenate(
            [used_gidx[used_labels == j], avail_gidx[labels == j]]
        )
        if len(inds):
            subdomains.append(np.sort(inds))
    if one_d:
        subdomains.sort(key=lambda a: locs[a][:, 0].min())
    return subdomains


# ---------------------------------------------------------------------------
# padded per-level arrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelGroup:
    """Padded static arrays for one tree level.

    Interior nodes carry exactly ``r`` knots; leaf nodes carry all their
    locations (their own knots are the still-unused subset, flagged by
    ``leaf_is_knot``). ``*_path[:, j]`` is the row of the level-``j``
    interior arrays holding the node's ancestor — the static replacement of
    the reference's parent-chain walk ``_getB_lk`` (MRANode.py:346-355).
    Padding uses index ``N`` (one-past-the-end) so device code can scatter
    with ``mode='drop'``.
    """

    level: int
    # interior nodes [n_int, ...]
    int_knot_gidx: np.ndarray  # [n_int, r]
    int_parent: np.ndarray  # [n_int]
    int_path: np.ndarray  # [n_int, level]
    # leaf nodes [n_leaf, ...]
    leaf_loc_gidx: np.ndarray  # [n_leaf, P]
    leaf_loc_mask: np.ndarray  # [n_leaf, P]
    leaf_is_knot: np.ndarray  # [n_leaf, P]
    leaf_parent: np.ndarray  # [n_leaf]
    leaf_path: np.ndarray  # [n_leaf, level]

    @property
    def n_int(self) -> int:
        return self.int_knot_gidx.shape[0]

    @property
    def n_leaf(self) -> int:
        return self.leaf_loc_gidx.shape[0]

    @property
    def leaf_pad(self) -> int:
        return self.leaf_loc_gidx.shape[1]


@dataclasses.dataclass
class TreePlan:
    """The full static tree plan: padded level arrays + host node records."""

    locs: np.ndarray  # [N, d]
    r: int
    M: int
    J: int
    levels: list[LevelGroup]
    nodes: list[list[NodeRec]]  # per level, DFS order (interior + leaves)
    config: PlanConfig

    @property
    def n_locs(self) -> int:
        return len(self.locs)

    @property
    def dim(self) -> int:
        return self.locs.shape[1]

    @property
    def n_leaves(self) -> int:
        return sum(g.n_leaf for g in self.levels)

    def leaf_sizes(self) -> np.ndarray:
        """Number of own knots per leaf (reference leaf-size telemetry,
        pyMRA/MRATree.py:136-157)."""
        sizes = []
        for g in self.levels:
            if g.n_leaf:
                sizes.append(g.leaf_is_knot.sum(axis=1))
        return np.concatenate(sizes) if sizes else np.empty(0, dtype=int)

    def describe(self) -> str:
        lines = [
            f"TreePlan: N={self.n_locs} d={self.dim} r={self.r} "
            f"M={self.M} J={self.J}"
        ]
        for g in self.levels:
            lines.append(
                f"  level {g.level}: {g.n_int} interior, {g.n_leaf} leaves"
                + (f" (pad {g.leaf_pad})" if g.n_leaf else "")
            )
        ls = self.leaf_sizes()
        if len(ls):
            lines.append(
                f"  leaf knots: avg {ls.mean():.1f} min {ls.min()} max {ls.max()}"
            )
        return "\n".join(lines)


def build_plan(locs: np.ndarray, r: int, M: int = -1, J: int = -1,
               seed: int = 0, config: PlanConfig | None = None) -> TreePlan:
    """Plan the MRA tree for ``locs``: the host-side half of tree building.

    Equivalent in role to the structural part of ``MRATree.__init__`` +
    ``Node.__init__`` (pyMRA/MRATree.py:23-73, MRANode.py:23-116) — but runs
    once, deterministically, with no numerics.
    """
    locs = np.asarray(locs, dtype=np.float64)
    if locs.ndim == 1:
        locs = locs[:, None]
    n, d = locs.shape
    if config is None:
        config = PlanConfig(r=r, M=M, J=J, seed=seed)
    M, J = derive_tree_shape(n, r, d, M, J)
    rng = np.random.default_rng(config.seed)

    per_level: list[list[NodeRec]] = [[] for _ in range(M + 1)]

    def build(level: int, node_gidx: np.ndarray, avail_gidx: np.ndarray,
              parent: NodeRec | None) -> NodeRec:
        is_leaf = (level == M) or (len(avail_gidx) <= max(r, J))
        if is_leaf:
            rec = NodeRec(level, len(per_level[level]), node_gidx,
                          np.sort(avail_gidx), parent, is_leaf=True)
            per_level[level].append(rec)
            return rec

        knot_gidx = _select_knots(locs, avail_gidx, r, config, rng)
        rec = NodeRec(level, len(per_level[level]), node_gidx, knot_gidx,
                      parent, is_leaf=False)
        per_level[level].append(rec)

        new_avail = np.setdiff1d(avail_gidx, knot_gidx)
        if len(node_gidx) > config.coord_split_threshold:
            subdomains = _coord_splits(locs, node_gidx)
        else:
            subdomains = _j_splits(locs, node_gidx, knot_gidx, new_avail, J,
                                   config)
        # sanity: children partition the parent domain
        total = np.sort(np.concatenate(subdomains))
        assert np.array_equal(total, np.sort(node_gidx)), (
            "planner split lost/duplicated locations"
        )
        for sub in subdomains:
            child_avail = sub[np.isin(sub, new_avail)]
            child = build(level + 1, sub, child_avail, rec)
            rec.children.append(child)
        return rec

    build(0, np.arange(n), np.arange(n), None)

    # ---- compile padded per-level arrays (DFS order == append order) ----
    levels: list[LevelGroup] = []
    for m in range(M + 1):
        ints = [nd for nd in per_level[m] if not nd.is_leaf]
        leaves = [nd for nd in per_level[m] if nd.is_leaf]

        # interior-row index, referenced by children at level m+1 and by paths
        for i, nd in enumerate(ints):
            nd.index_in_level_int = i

        def parent_row(nd: NodeRec) -> int:
            return -1 if nd.parent is None else nd.parent.index_in_level_int

        def path_rows(nd: NodeRec) -> np.ndarray:
            out = np.empty(m, dtype=np.int64)
            cur = nd.parent
            for j in range(m - 1, -1, -1):
                out[j] = cur.index_in_level_int
                cur = cur.parent
            return out

        int_knot = (np.stack([nd.knot_gidx for nd in ints])
                    if ints else np.empty((0, r), dtype=np.int64))
        int_parent = (np.array([parent_row(nd) for nd in ints], dtype=np.int64)
                      if ints else np.empty(0, dtype=np.int64))
        int_path = (np.stack([path_rows(nd) for nd in ints])
                    if ints else np.empty((0, m), dtype=np.int64))

        if leaves:
            P = max(nd.n_locs for nd in leaves)
            ll = np.full((len(leaves), P), n, dtype=np.int64)
            lm = np.zeros((len(leaves), P), dtype=bool)
            lk = np.zeros((len(leaves), P), dtype=bool)
            for i, nd in enumerate(leaves):
                order = np.sort(nd.loc_gidx)
                ll[i, : nd.n_locs] = order
                lm[i, : nd.n_locs] = True
                lk[i, : nd.n_locs] = np.isin(order, nd.knot_gidx)
            lp = np.array([parent_row(nd) for nd in leaves], dtype=np.int64)
            lpath = np.stack([path_rows(nd) for nd in leaves])
        else:
            ll = np.empty((0, 0), dtype=np.int64)
            lm = np.empty((0, 0), dtype=bool)
            lk = np.empty((0, 0), dtype=bool)
            lp = np.empty(0, dtype=np.int64)
            lpath = np.empty((0, m), dtype=np.int64)

        levels.append(LevelGroup(m, int_knot, int_parent, int_path,
                                 ll, lm, lk, lp, lpath))

    plan = TreePlan(locs, r, M, J, levels, per_level, config)
    logger.debug("%s", plan.describe())
    return plan
