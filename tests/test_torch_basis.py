"""``keep_internals``, the basis matrices, the traversals, ``getB_lk`` and
the drawings in the port, against the JAX package: the cases of
``tests/test_basis.py``.

Tolerances: the JAX test's where the port stands alone (prior and
posterior reconstructions atol 1e-8 / 1e-7, the row sums of squares 1e-8,
``getB_lk`` 1e-9 / 1e-12); the port's basis matrices against the JAX
package's on the same plan and data 1e-10 (float64, the same
assembly); the ``keep_internals`` sweep's posterior against the default
sweep's 1e-10 in float64 and, in float32 (the kernel structure on the
twins: K2 and K3 at the leaves), against the float64 sweep at atol 2e-4 as
the kernel-structure tests hold float32 posteriors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu import kernels as jk
from pymra_tpu.tree.basis import _leaf_order as jax_leaf_order
from pymra_tpu.tree.basis import basis_matrix as jax_basis_matrix
from pymra_torch import Kernel, MRAModel, MRATree
from pymra_torch.ops import linalg as tl
from pymra_torch.tree.basis import basis_matrix
from pymra_torch.tree.sweep import mra_sweep
from pymra_torch.utils import gen_locations_2d

from tests.test_basis import _setup as _jax_setup
from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64
KERN = Kernel("exponential", l=0.3)


def _setup(n=45, r=2, M=2, J=3, me=1e-2, seed=11, dtype=F64):
    """``tests/test_basis.py``'s data (its simulator, its seeds) with the
    port's model, and the JAX package's model on the same locations."""
    locs, _, y, jmodel = _jax_setup(n=n, r=r, M=M, J=J, me=me, seed=seed)
    model = MRAModel(locs, r=r, M=M, J=J, dtype=dtype, device="cpu")
    return np.asarray(locs), np.asarray(y), model, jmodel


def _sigma(locs):
    return KERN(torch.as_tensor(locs)).numpy()


class TestPriorBasis:
    def test_prior_reconstruction_screening(self):
        locs, _, model, _ = _setup()
        B = basis_matrix(model, KERN, times_kc=True)
        np.testing.assert_allclose(B @ B.T, _sigma(locs), atol=1e-8)

    def test_shapes_and_block_structure(self):
        _, _, model, _ = _setup()
        Bs = basis_matrix(model, KERN, group_by_resolution=True)
        assert Bs[0].shape == (45, model.plan.r)
        g1 = model.plan.levels[1]
        assert Bs[1].shape[1] == g1.n_int * model.plan.r + int(
            g1.leaf_is_knot.sum())
        assert sum(b.shape[1] for b in Bs) == 45

    def test_leaf_order_permutation(self):
        _, _, model, _ = _setup()
        B_root = basis_matrix(model, KERN)
        B_leaves = basis_matrix(model, KERN, order="leaves")
        assert sorted(map(tuple, B_root.round(12))) == sorted(
            map(tuple, B_leaves.round(12)))

    @pytest.mark.parametrize("distr", ["prior", "posterior"])
    def test_matches_jax_basis_every_option(self, distr):
        # timesKC both ways and both row orders, on the same plan and data;
        # the JAX package's 'leaves' order is its 'root' matrix with the
        # rows of its _leaf_order (what its basis_matrix applies)
        locs, y, model, jmodel = _setup()
        jkern = jk.Kernel("exponential", l=0.3)
        perm = jax_leaf_order(jmodel.plan)
        for times_kc in (False, True):
            want = jax_basis_matrix(jmodel, jkern, y=y, R=1e-2, distr=distr,
                                    times_kc=times_kc)
            for order, rows in (("root", slice(None)), ("leaves", perm)):
                got = basis_matrix(model, KERN, y=y, R=1e-2, distr=distr,
                                   times_kc=times_kc, order=order)
                np.testing.assert_allclose(got, want[rows], atol=1e-10,
                                           err_msg=f"{times_kc} {order}")


class TestPosteriorBasis:
    def test_posterior_reconstruction_screening(self):
        locs, y, model, _ = _setup(me=1e-2)
        B = basis_matrix(model, KERN, y=y, R=1e-2, distr="posterior",
                         times_kc=True)
        sigma = _sigma(locs)
        h = np.eye(len(locs))[np.isfinite(y)]
        sig_post = np.linalg.inv(np.linalg.inv(sigma) + h.T @ h / 1e-2)
        np.testing.assert_allclose(B @ B.T, sig_post, atol=1e-7)

    def test_posterior_diag_matches_sweep_var(self):
        _, y, model, _ = _setup()
        res = model.sweep(KERN, y, 1e-2)
        B = basis_matrix(model, KERN, y=y, R=1e-2, distr="posterior",
                         times_kc=True)
        np.testing.assert_allclose(np.sum(B * B, axis=1), res.var.numpy(),
                                   atol=1e-8)

    def test_keep_internals_sweep_matches_the_default(self, monkeypatch):
        # float64: the replayed downdates equal the chain contraction; the
        # float32 kernel structure takes K2 (both leaf factors) and K3 and
        # never the fused K1
        _, y, model, _ = _setup()
        base = model.sweep(KERN, y, 1e-2)
        res, internals = mra_sweep(model.dplan, KERN, y, 1e-2,
                                   keep_internals=True)
        assert set(internals) == {"prior_L", "chain_Q", "chain_GG", "leaf",
                                  "interior"}
        for a, b in zip(res, base):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10)
        # 16 grouped leaves of P = 16: the inverse route in float32
        locs = gen_locations_2d(16)
        rng = np.random.default_rng(3)
        y2 = rng.standard_normal(len(locs))
        y2[rng.random(len(locs)) < 0.3] = np.nan
        kw = dict(r=4, M=2, J=4, device="cpu")
        m32 = MRAModel(locs, dtype=torch.float32, **kw)
        assert max(lvl.leaf_locs.shape[1] for lvl in m32.dplan.levels) >= 16
        calls = dict.fromkeys(("leaf_factor_ref", "cholesky_jittered_ref",
                               "triangular_inverse_lower_ref"), 0)
        for name in calls:
            real = getattr(tl, name)

            def count(*a, _real=real, _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(tl, name, count)
        # (the exponential: a smoother field puts both float32 routes,
        # this one and the default, ~4.5e-4 off the float64 mean)
        kern = Kernel("exponential", l=0.2)
        r32, _ = mra_sweep(m32.dplan, kern, y2, 1e-2, jitter=m32.jitter,
                           keep_internals=True)
        assert calls["leaf_factor_ref"] == 0
        assert calls["cholesky_jittered_ref"] and calls[
            "triangular_inverse_lower_ref"]
        r64 = MRAModel(locs, dtype=F64, **kw).sweep(kern, y2, 1e-2)
        np.testing.assert_allclose(float(r32.objective), float(r64.objective),
                                   rtol=1e-4)
        np.testing.assert_allclose(r32.mean.numpy(), r64.mean.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(r32.var.numpy(), r64.var.numpy(),
                                   atol=2e-4)


class TestViz:
    def test_draw_functions_run_headless(self, tmp_path):
        from pymra_torch.utils import viz

        locs, y, model, _ = _setup(n=27, M=1)
        viz.draw_knots(model, fname=tmp_path / "knots.png")
        viz.draw_b_matrix(model, KERN, fname=tmp_path / "b.png")
        viz.draw_sparsity_pattern(model, KERN, fname=tmp_path / "sp.png")
        viz.draw_basis_functions(model, KERN, fname=tmp_path / "bf.png")
        viz.draw_grid_and_obs(model, y, fname=tmp_path / "grid.png")
        for name in ("knots.png", "b.png", "sp.png", "grid.png"):
            assert (tmp_path / name).exists()
        tree = MRATree(locs, 2, KERN, y, 1e-2, M=1, J=3, dtype=F64,
                       device="cpu")
        tree.drawBasisFunctions(fname=tmp_path / "tree_bf.png")
        tree.drawKnots(fname=tmp_path / "tree_knots.png")
        assert (tmp_path / "tree_knots.png").exists()

    def test_get_layout_and_filter(self):
        from pymra_torch.utils.viz import filter_nnz, get_layout

        assert get_layout(0, 3, 2) == (1, 2)
        assert get_layout(1, 3, 2) == (2, 3)
        x = np.array([[0.0, 1e-12], [3.0, -2.0]])
        np.testing.assert_array_equal(filter_nnz(x, tol=1e-10),
                                      [[0, 0], [1, 1]])


class TestAncestorBasisAccessors:
    def _tree(self, cov=KERN):
        locs, y, _, _ = _setup()
        if cov is None:
            cov = _sigma(locs)
        return MRATree(locs, 2, cov, y, 1e-2, M=2, J=3, dtype=F64,
                       device="cpu")

    def test_getknode_walks_path(self):
        tree = self._tree()
        leaf = [nd for nd in tree.model.plan.nodes[2] if nd.is_leaf][0]
        ID = leaf.node_id
        assert ID[0] == "r" and len(ID) == 3
        assert tree.getKNode(ID, 0) is tree.model.plan.nodes[0][0]
        assert tree.getKNode(ID, 2) is leaf
        assert tree.getKNode(ID, 1) is leaf.parent
        bfs, dfs = tree.getNodesBFS(), tree.getNodesDFS()
        assert len(bfs) == len(dfs) == len({id(nd) for nd in bfs})
        assert dfs[0] is bfs[0] and dfs[1] is bfs[0].children[0]
        assert [len(g) for g in tree.getNodesBFS(groupByResolution=True)] \
            == [len(g) for g in tree.model.plan.nodes if g]
        with pytest.raises(ValueError):
            tree.getKNode("x1", 0)

    @pytest.mark.parametrize("matrix", [False, True])
    def test_getb_lk_matches_sweep_chain_blocks(self, matrix):
        # by coordinates, and in index mode with the covariance as a matrix
        tree = self._tree(None if matrix else KERN)
        model, r, m = tree.model, tree.model.plan.r, 2
        _, internals = mra_sweep(model.dplan, tree.cov, tree.obs, 1e-2,
                                 keep_internals=True)
        leaves = [nd for nd in model.plan.nodes[m] if nd.is_leaf]
        for li in (0, len(leaves) - 1):
            leaf = leaves[li]
            Bstack = internals["leaf"][m]["Bstack"][li].numpy()
            for k in range(m):
                want = Bstack[: leaf.n_locs, k * r:(k + 1) * r]
                np.testing.assert_allclose(tree.getB_lk(leaf.node_id, k),
                                           want, atol=1e-9)

    def test_getb_lk_restricted_l(self):
        tree = self._tree()
        leaves = [nd for nd in tree.model.plan.nodes[2] if nd.is_leaf]
        ID = leaves[0].node_id
        full = tree.getB_lk(ID, 0, l=1)
        sub = tree.getB_lk(ID, 0)
        parent = tree.getKNode(ID, 1)
        rows = np.searchsorted(parent.loc_gidx, leaves[0].loc_gidx)
        np.testing.assert_allclose(full[rows], sub, atol=1e-12)

    def test_basis_functions_matrix_of_the_tree(self):
        tree = self._tree()
        B = tree.getBasisFunctionsMatrix("posterior", timesKC=True)
        _, sd = tree.predict()
        np.testing.assert_allclose(np.sum(B * B, axis=1), sd ** 2, atol=1e-8)


def test_keep_internals_stash_is_the_jax_packages():
    # the stashes the basis matrices read, leaf and interior, per level
    _, y, model, jmodel = _setup()
    _, got = mra_sweep(model.dplan, KERN, y, 1e-2, keep_internals=True)
    from pymra_tpu.tree.sweep import mra_sweep as jax_sweep

    _, want = jax_sweep(jmodel.dplan, jk.Kernel("exponential", l=0.3), y,
                        1e-2, keep_internals=True)
    for m, (a, b) in enumerate(zip(got["leaf"], want["leaf"])):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for key in ("Bstack", "L_prior", "L_post"):
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                       atol=1e-10, err_msg=f"{m} {key}")
        for k, blk in a["post_blocks"].items():
            np.testing.assert_allclose(blk.numpy(),
                                       np.asarray(b["post_blocks"][k]),
                                       atol=1e-10)
    for a, b in zip(got["prior_L"], want["prior_L"]):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
