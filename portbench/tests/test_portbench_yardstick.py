"""The benchmark's yardstick and plain reference on the CPU: the counts
pinned at the cells' shapes, the frozen planner and the float64 reference
against the program, and the trace reduction. The control's failure at
the cells' own size and the full-size tree need the card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import plan_mismatches, tree_shape
from portbench.reference.mra import Reference
from portbench.reference.planner import plan_tree
from portbench.yardstick.flops import sweep_flops, value_and_grad_flops
from portbench.yardstick.roofline import bound_ms, leaf_factor_work
from portbench.yardstick.trace import Trace, own_kernel_names, short_name

from conftest import ROOT


def quadtree(r, M, P):
    """The shape of a full quadtree: ``4^m`` interior nodes above ``4^M``
    leaves of up to ``P`` locations, four to a parent."""
    levels = [{"n_int": 4 ** m, "n_leaf": 0, "P": 0, "c": 0}
              for m in range(M)]
    levels.append({"n_int": 0, "n_leaf": 4 ** M, "P": P, "c": 4})
    return {"r": r, "M": M, "levels": levels}


GRID1M = quadtree(8, 7, 64)


def test_counts_pinned_at_the_cells_shapes():
    # grid1m.grad4: value and gradient of one set
    assert value_and_grad_flops(GRID1M) == pytest.approx(204966544512.0)
    # grid1m.post4: likelihood and posterior of one set (87.3 GFLOP, the
    # repository's cost model at this tree)
    assert sweep_flops(GRID1M, posterior=True) == pytest.approx(
        87276318080.0)
    # K1 at 4 x 16384 leaves of 64
    assert leaf_factor_work(4 * 16384, 64) == (2182086656.0, 17179869184.0)
    assert bound_ms(*leaf_factor_work(4 * 16384, 64)) == pytest.approx(
        0.6513691510447761)


def _tiny_case(seed=5):
    from portbench.datasets.grid_field import make

    spec = {"side": 48, "missing": 0.1, "features": 64, "l": 0.05,
            "sig": 1.0, "noise_var": 0.01}
    locs, y = make(spec, np.random.SeedSequence(seed), "cpu")
    return locs, y, plan_tree(locs, 4, 3)


def test_frozen_planner_is_the_programs_tree():
    from pymra_torch import MRAModel, PlanConfig

    locs, _, tree = _tiny_case()
    model = MRAModel(locs, r=4, M=3, J=4, dtype=torch.float64, device="cpu",
                     config=PlanConfig(r=4, M=3, J=4, kmeans_impl="native"))
    assert plan_mismatches(model.plan, tree) == 0
    # another planner seed picks other knots: the count sees it
    other = plan_tree(locs, 4, 3, seed=1)
    assert plan_mismatches(model.plan, other) > 0


@pytest.mark.parametrize("jitter", [0.0, 1e-6, 1e-3])
def test_reference_agrees_with_the_program_in_float64(jitter):
    """The plain reference and the program's float64 sweep (its plain
    structure on the CPU) are one model, with the configuration's jitter
    as without: log-likelihood, gradient and posterior agree to rounding.
    (At 1e-3 the jitter moves the log-likelihood by up to 14 units.)"""
    from pymra_torch import Kernel, MRAModel, PlanConfig

    locs, y, tree = _tiny_case()
    model = MRAModel(locs, r=4, M=3, J=4, dtype=torch.float64, device="cpu",
                     jitter=jitter,
                     config=PlanConfig(r=4, M=3, J=4, kmeans_impl="native"))
    sets = {"l": [0.05, 0.08, 0.03], "sig": [1.0, 0.7, 1.3]}
    ref = Reference(tree, y, 1e-2, jitter=jitter)
    lr = torch.tensor(sets["l"], dtype=torch.float64, requires_grad=True)
    sr = torch.tensor(sets["sig"], dtype=torch.float64, requires_grad=True)
    want = ref.sweep(lr, sr, posterior=True)
    want["loglik"].sum().backward()
    f = model.loglik_fn(y, 1e-2, batched=True, kernel_builder=lambda th:
                        Kernel("exponential", l=th["l"], sig=th["sig"]))
    th = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in sets.items()}
    got = f(th)
    got.sum().backward()
    np.testing.assert_allclose(got.detach(), want["loglik"].detach(),
                               rtol=1e-10)
    np.testing.assert_allclose(th["l"].grad, lr.grad, rtol=1e-8)
    np.testing.assert_allclose(th["sig"].grad, sr.grad, rtol=1e-8)
    res = model.sweep(Kernel("exponential", **{
        k: torch.tensor(v, dtype=torch.float64) for k, v in sets.items()}),
        y, 1e-2)
    np.testing.assert_allclose(res.objective, want["objective"].detach(),
                               rtol=1e-10)
    np.testing.assert_allclose(res.mean, want["mean"].detach(), atol=1e-9)
    np.testing.assert_allclose(res.var, want["var"].detach(), atol=1e-9)


def test_trace_reduction():
    dev = [("void leaf_factor_kernel<64>(float const*)", 10.0, 14.0),
           ("ampere_sgemm_64x64_nn", 12.0, 20.0),
           ("Memcpy DtoH (Device -> Pageable)", 30.0, 31.0),
           ("void chol_pullback_tile<64>(float const*)", 40.0, 42.0)]
    host = [("aten::mm", 5.0, 22.0), ("aten::copy_", 21.0, 33.0),
            ("autograd::engine", 0.0, 50.0)]
    tr = Trace(dev, host, (0.0, 50.0), 2, ["leaf_factor_kernel",
                                            "chol_pullback_tile"])
    assert tr.kernel_count() == 3
    assert tr.busy_us() == pytest.approx(10 + 1 + 2)
    assert tr.kernel_us(own=True) == pytest.approx(6.0)
    assert tr.kernel_us(own=False) == pytest.approx(8.0)
    assert tr.kernel_us(name="leaf_factor_kernel") == pytest.approx(4.0)
    assert tr.kernel_launches("chol_pullback_tile") == 1
    assert tr.device_ops()[0] == ["ampere_sgemm_64x64_nn", 8e-6]
    gaps = dict(tr.idle_gaps())
    # gaps 0-10 (mm at 5), 20-30 (copy_ at 25), 31-40 and 42-50
    # (the engine)
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["autograd::engine"] == pytest.approx(17e-6)
    assert short_name("void a::b<3, c<d>>(int)") == "a::b"


def test_own_kernel_names_come_from_the_programs_sources():
    names = own_kernel_names(ROOT)
    assert "leaf_factor_kernel" in names and "chol_pullback_tile" in names
    assert all(n.isidentifier() for n in names)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["grid1m.grad4", "grid1m.post4"])
def test_control_fails_where_the_program_passes(card, workload):
    """At the cell's own size on the card, one seed: the program's numbers
    lie under the cell's limits and the control's (the float64 reference,
    with the configuration's jitter, computed in float32 with TF32
    matmuls) go over one of them. The dozen-seed readings the limits were
    set from: ``portbench/calibrate.py``."""
    from portbench import harness
    from portbench.calibrate import readings

    limits = harness.load_json(harness.HERE, "limits", workload + ".json")
    rows = list(readings(workload, seeds=1, control_seeds=1,
                         first_seed=2 ** 31 + 977))
    assert rows[0]["plan_mismatch"] == 0
    side = {r["side"]: r for r in rows[1:]}
    for k, v in side["program"].items():
        if k in limits:
            assert v <= limits[k], (k, v)
    control = side["control"]
    assert any(control[k] > limits[k] for k in control if k in limits)


@pytest.mark.card
def test_grid1m_tree_shape(card):
    from portbench import harness

    cfg = harness.load_json(harness.HERE, "configs", "grid1m.json")
    locs, _ = harness.module("datasets", "grid_field").make(
        dict(cfg["data"], features=8), np.random.SeedSequence(0), "cuda")
    assert tree_shape(plan_tree(locs, cfg["r"], cfg["M"], cfg["J"])) \
        == GRID1M
