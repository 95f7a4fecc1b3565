"""The port's utilities against the JAX package's on the same inputs:
scoring, logging, profiling, the sweep's cost accounting, the native
planner's batch calls, plan and pytree checkpoints (interchangeable
between the packages) and the sampler checkpoint-resume recipe."""
import json
import logging
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu.ops import native as jax_native
from pymra_tpu.parallel.sharded import int_shard_level as jax_int_shard_level
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_tpu.tree.sweep import make_device_plan as jax_make_device_plan
from pymra_tpu.utils import accounting as jax_accounting
from pymra_tpu.utils import checkpoint as jax_checkpoint
from pymra_tpu.utils import scoring as jax_scoring
from pymra_torch import Kernel, MRAModel, PlanConfig, build_plan, load_data
from pymra_torch.infer import hmc
from pymra_torch.ops import native
from pymra_torch.parallel.sharded import int_shard_level
from pymra_torch.tree.sweep import make_device_plan
from pymra_torch.utils import (
    PhaseTimer,
    checkpoint,
    configure_logging,
    gen_locations_2d,
    get_logger,
    health,
    kl_divergence,
    logscore,
    mse,
    profiling,
    rmse,
)
from pymra_torch.utils.accounting import sweep_cost

from tests.torch_fixtures import jax_native_planner  # noqa: F401

F64 = torch.float64


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _gaussians(seed, n=7):
    rng = np.random.default_rng(seed)
    a0, a1 = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    return (rng.normal(size=n), rng.normal(size=n), a0 @ a0.T + n * np.eye(n),
            a1 @ a1.T + n * np.eye(n))


def test_scoring_matches_the_jax_package():
    mu0, mu1, s0, s1 = _gaussians(3)
    rng = np.random.default_rng(4)
    pred, true = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    obs = rng.normal(size=7)
    obs[[1, 4]] = np.nan
    pairs = [
        (rmse(pred, true), jax_scoring.rmse(pred, true)),
        (rmse(torch.as_tensor(pred)), jax_scoring.rmse(pred)),
        (mse(pred, true), jax_scoring.mse(pred, true)),
        (kl_divergence(mu0, mu1, s0, s1),
         jax_scoring.kl_divergence(mu0, mu1, s0, s1)),
        (logscore(obs, mu0, s0), jax_scoring.logscore(obs, mu0, s0)),
    ]
    for ours, ref in pairs:
        assert ours.dtype == F64 and ours.shape == ()
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-12)
    assert float(kl_divergence(mu0, mu0, s0, s0)) == pytest.approx(
        0.0, abs=1e-12)


def test_scoring_differentiates():
    mu0, mu1, s0, s1 = _gaussians(5)
    m = torch.tensor(mu0, requires_grad=True)
    kl_divergence(m, mu1, s0, s1).backward()
    # d KL / d mu0 = Sigma1^-1 (mu0 - mu1)
    np.testing.assert_allclose(m.grad.numpy(),
                               np.linalg.solve(s1, mu0 - mu1), rtol=1e-10)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_configure_is_idempotent_and_reads_the_flag(monkeypatch):
    root = logging.getLogger("pymra_torch")
    saved = (root.level, list(root.handlers), root.propagate)
    try:
        log1 = configure_logging(level="DEBUG")
        log2 = configure_logging(level="INFO")
        assert log1 is log2 is root
        assert len(root.handlers) == 1 and root.level == logging.INFO
        monkeypatch.setenv("PYMRA_LOG_LEVEL", "WARNING")
        configure_logging()
        assert root.level == logging.WARNING and len(root.handlers) == 1
        assert get_logger("tree.plan").name == "pymra_torch.tree.plan"
        assert get_logger() is root
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        root.propagate = saved[2]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_phase_timer_and_chained_throughput_on_the_cpu():
    timer = PhaseTimer()
    with timer("phase_a"):
        sum(range(1000))
    x = torch.ones(8)
    with timer("phase_b", sync=x):
        x = x * 2
    with timer("phase_b", sync=torch.device("cpu")):
        pass
    rep = timer.report()
    assert "phase_a" in rep and "phase_b" in rep
    d = timer.as_dict()
    assert d["phase_a"]["calls"] == 1 and d["phase_b"]["calls"] == 2

    calls = []

    def eval_fn(theta, scale):
        calls.append(float(theta))
        return {"a": theta * scale, "b": [torch.ones(3) * theta]}

    out = profiling.chained_throughput(
        eval_fn, torch.linspace(1.0, 2.0, 6, dtype=F64), 2.0, n_evals=5)
    assert out["device"] == "cpu" and out["n_evals"] == 5
    assert out["evals_per_sec"] > 0 and out["chain_s"] > 0
    # two single evaluations at thetas[0], then the chain over thetas[1:],
    # each shifted by perturb * (the folded outputs so far)
    assert len(calls) == 7 and calls[:2] == [1.0, 1.0]
    np.testing.assert_allclose(calls[2:], np.linspace(1.0, 2.0, 6)[1:],
                               rtol=1e-12)
    with pytest.raises(ValueError, match="thetas"):
        profiling.chained_throughput(eval_fn, torch.zeros(3), 1.0, n_evals=5)


def test_trace_annotation_and_profile_to_write_a_trace(tmp_path):
    profiling.clear()
    with profiling.profile_to(str(tmp_path / "trace")) as prof:
        with profiling.trace_annotation("pymra-test-region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as fh:
        trace = json.load(fh)
    # the span is merged into the Chrome trace, at its anchor's place; it
    # is not a profiler range (only the empty anchor is)
    events = trace["traceEvents"]
    clock, = [e for e in events if e.get("name") == profiling.CLOCK]
    span, = [e for e in events if e.get("name") == "pymra-test-region"]
    assert span["cat"] == "pymra" and span["ph"] == "X"
    assert span["ts"] >= float(clock["ts"]) - 1.0
    mm, = [e for e in events if e.get("name") == "aten::mm"]
    assert span["ts"] <= float(mm["ts"]) <= span["ts"] + span["dur"]
    keys = {e.key for e in prof.key_averages()}
    assert "pymra-test-region" not in keys and profiling.CLOCK in keys
    assert [s["name"] for s in profiling.spans()] == ["pymra-test-region"]
    profiling.clear()


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def _plan(which):
    if which == "large":
        locs, _ = load_data("large")
        return build_plan(locs, 4, M=4,
                          config=PlanConfig(r=4, kmeans_impl="native"))
    return build_plan(gen_locations_2d(64), 4, M=4, J=4)


@pytest.mark.parametrize("which", ["large", "grid64"])
def test_sweep_cost_equals_the_jax_package(which, tmp_path):
    plan = _plan(which)
    ours = make_device_plan(plan, dtype=torch.float32, device="cpu")
    # the JAX package's device plan of the same host plan, through its
    # own loader of the port's plan file
    checkpoint.save_plan(tmp_path / "plan.npz", plan)
    ref = jax_make_device_plan(jax_checkpoint.load_plan(tmp_path / "plan.npz"))
    crits = [10 ** 9]
    for n in (2, 4, 8):
        crit = int_shard_level(ours, n)
        assert crit == jax_int_shard_level(ref, n)
        crits.append(crit)
    assert min(crits) <= plan.M  # the set case shards interior levels
    for crit in sorted(set(crits)):
        for post in (True, False):
            a = sweep_cost(ours, compute_posterior=post, int_shard_from=crit)
            b = jax_accounting.sweep_cost(ref, compute_posterior=post,
                                          int_shard_from=crit)
            assert a._fields == b._fields
            for name in a._fields:
                assert getattr(a, name) == getattr(b, name), name


# ---------------------------------------------------------------------------
# native planner batch calls
# ---------------------------------------------------------------------------

def test_kmeans_batch_and_quadrant_split_bit_equal_the_jax_binding():
    rng = np.random.default_rng(7)
    pts = rng.random((500, 2))
    offsets = np.array([0, 37, 150, 151 + 99, 500])
    for k in (3, 5):
        c_ours, l_ours = native.kmeans_batch(pts, offsets, k, seed=3)
        c_ref, l_ref = jax_native.kmeans_batch(pts, offsets, k, seed=3)
        np.testing.assert_array_equal(c_ours, c_ref)
        np.testing.assert_array_equal(l_ours, l_ref)
        assert l_ours.dtype == np.int64 and c_ours.shape == (4, k, 2)
    # set s of a batch is the single-set k-means seeded with seed + s
    c1, l1 = native.kmeans(pts[37:150], 5, seed=4)
    np.testing.assert_array_equal(c1, c_ours[1])
    np.testing.assert_array_equal(l1, l_ours[37:150])
    q_ours = native.quadrant_split(pts)
    np.testing.assert_array_equal(q_ours, jax_native.quadrant_split(pts))
    assert set(np.unique(q_ours)) == {0, 1, 2, 3}
    with pytest.raises(ValueError, match="offsets"):
        native.kmeans_batch(pts, np.array([0, 600]), 3)
    with pytest.raises(ValueError, match="points"):
        native.quadrant_split(rng.random((10, 3)))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _level_arrays(plan):
    return [{f: np.asarray(getattr(g, f)) for f in checkpoint._LEVEL_FIELDS}
            for g in plan.levels]


def test_plan_files_interchange_both_ways(tmp_path):
    from pymra_tpu.tree.plan import build_plan as jax_build_plan

    locs = gen_locations_2d(12)
    ours = build_plan(locs, 4, M=2, J=4)
    ref = jax_build_plan(locs, 4, M=2, J=4)
    checkpoint.save_plan(tmp_path / "ours.npz", ours)
    jax_checkpoint.save_plan(tmp_path / "ref.npz", ref)
    into_jax = jax_checkpoint.load_plan(tmp_path / "ours.npz")
    into_ours = checkpoint.load_plan(tmp_path / "ref.npz")
    for a, b in ((into_jax, ref), (into_ours, ours)):
        assert (a.r, a.M, a.J, a.n_locs) == (b.r, b.M, b.J, b.n_locs)
        np.testing.assert_array_equal(a.locs, b.locs)
        for la, lb in zip(_level_arrays(a), _level_arrays(b)):
            for f in la:
                np.testing.assert_array_equal(la[f], lb[f])
    assert into_ours.nodes == [[] for _ in into_ours.levels]
    # a loaded plan sweeps to the same numbers in either package
    rng = np.random.default_rng(2)
    y = rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > 0.7] = np.nan
    kern = Kernel("matern32", l=0.4, sig=1.2)
    res = MRAModel(locs, 4, plan=into_ours, dtype=F64,
                   device="cpu").sweep(kern, y, 1e-3)
    want = MRAModel(locs, 4, plan=ours, dtype=F64, device="cpu").sweep(
        kern, y, 1e-3)
    from pymra_tpu import kernels as jax_kernels

    jres = JaxMRAModel(locs, r=4, plan=into_jax).sweep(
        jax_kernels.Kernel("matern32", l=0.4, sig=1.2), y, 1e-3)
    assert float(res.objective) == float(want.objective)
    np.testing.assert_array_equal(res.mean.numpy(), want.mean.numpy())
    np.testing.assert_allclose(float(res.objective), float(jres.objective),
                               rtol=1e-12)


class Pair(NamedTuple):
    first: object
    second: object


def _tree():
    return {
        "params": {"l": torch.tensor(0.3, dtype=F64), "sig": torch.ones(4)},
        "trace": [torch.zeros(2, 2), (torch.arange(3), None)],
        7: torch.tensor(1.5),
        "pair": Pair(torch.tensor([True, False]), {"x": np.arange(2.0)}),
    }


def test_pytree_roundtrips_with_and_without_a_template(tmp_path):
    tree = _tree()
    path = tmp_path / "state.npz"
    checkpoint.save_pytree(path, tree)
    loaded = checkpoint.load_pytree(path)
    assert set(loaded) == {"params", "trace", 7, "pair"}
    assert isinstance(loaded["trace"], list)
    inner = loaded["trace"][1]
    assert isinstance(inner, tuple) and inner[1] is None
    assert torch.equal(inner[0], torch.arange(3))
    assert loaded["params"]["l"].dtype == F64
    assert float(loaded["params"]["l"]) == 0.3
    # a named tuple comes back as a plain tuple ...
    assert type(loaded["pair"]) is tuple
    assert torch.equal(loaded["pair"][0], torch.tensor([True, False]))
    # ... and as itself through a template
    like = checkpoint.load_pytree(path, like=tree)
    assert isinstance(like["pair"], Pair)
    assert torch.equal(like["pair"].second["x"],
                       torch.arange(2.0, dtype=F64))
    assert torch.equal(like["params"]["sig"], torch.ones(4))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(path, like={"one": 0})


def test_pytree_files_interchange_both_ways(tmp_path):
    tree = {"a": np.arange(5.0), "b": [np.ones((2, 3)), (np.int64(4), None)]}
    jax_checkpoint.save_pytree(tmp_path / "ref.npz", tree)
    ours = checkpoint.load_pytree(tmp_path / "ref.npz")
    assert torch.equal(ours["a"], torch.arange(5.0, dtype=F64))
    assert isinstance(ours["b"][1], tuple) and ours["b"][1][1] is None
    checkpoint.save_pytree(tmp_path / "ours.npz",
                           {k: v for k, v in _tree().items() if k != 7})
    back = jax_checkpoint.load_pytree(tmp_path / "ours.npz")
    np.testing.assert_array_equal(np.asarray(back["params"]["sig"]),
                                  np.ones(4))
    assert back["trace"][1][1] is None
    with np.load(tmp_path / "ours.npz") as data:
        assert json.loads(str(data["__structure__"]))["t"] == "dict"


def test_sampler_checkpoint_resume(tmp_path):
    # tests/test_aux.py::test_sampler_checkpoint_resume on the port: keep
    # the draws on disk mid-run, lose the process, reload and continue
    def logp(theta):
        return -0.5 * torch.sum(theta["x"] ** 2)

    res1 = hmc(logp, {"x": torch.zeros(2, 3, dtype=F64)},
               torch.Generator().manual_seed(0), num_warmup=50,
               num_samples=30)
    assert health.check_samples(res1.samples).ok
    path = tmp_path / "run.npz"
    checkpoint.save_pytree(path, res1)
    restored = checkpoint.load_pytree(path, like=res1)
    assert type(restored) is type(res1)
    for a, b in zip(restored, res1):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    init2 = health.resume_state(restored.samples)
    assert init2["x"].shape == (2, 3)
    res2 = hmc(logp, init2, torch.Generator().manual_seed(1), num_warmup=20,
               num_samples=30)
    rep = health.check_samples(res2.samples)
    assert rep.ok, str(rep)
    assert bool(((res2.samples["x"][:, -1] - init2["x"]).abs() > 1e-6).any())

