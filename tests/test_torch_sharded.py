"""The port's sharded sweep over gloo worlds of 2 and 4 CPU processes,
held to the JAX package's ``sharded_sweep`` (``shard_map`` over the
conftest's virtual CPU devices) and to the port's serial sweep, float64
on the same inputs; the gradient with the cross-rank mean inside the
port; chains over ranks against local chains.

The ranks live in ``tests/torch_sharded_worker.py`` (spawned processes,
a file store under ``tmp_path``, one torch thread each); each world runs
all its cases once, so its processes pay their imports once.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_tpu import kernels as jax_kernels
from pymra_tpu.parallel import make_mesh as jax_make_mesh
from pymra_tpu.parallel import sharded_sweep as jax_sharded_sweep
from pymra_tpu.parallel.sharded import int_shard_level as jax_int_shard_level
from pymra_tpu.parallel.sharded import (
    pad_plan_for_sharding as jax_pad_plan_for_sharding,
)
from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import Kernel
from pymra_torch.infer import hmc
from pymra_torch.parallel import pad_plan_for_sharding
from pymra_torch.parallel.sharded import int_shard_level

from tests import torch_sharded_worker as W
from tests.torch_fixtures import jax_native_planner  # noqa: F401

WORLD2 = ["matern256", "pad30", "crit4096", "grad:grad144", "kgrad:grad144",
          "grad:crit4096", "f32", "chains", "refuse", "batch:crit4096",
          "bgrad:crit4096"]
WORLD4 = ["crit4096", "grad:crit4096", "mesh", "lockstep"]
#: the float32 kernel structure (the card's sequence of operations, here
#: on the kernels' plain twins) of the critDepth case, sharded against
#: serial: the objective and the posterior (relative to its largest
#: magnitude) within F32_RTOL, the gradient within F32_GRAD_RTOL. The
#: cross-rank sums reorder float32 sums whose terms nearly cancel:
#: measured here, the objective moved by 1.1e-7, the posterior not at
#: all, the gradient in sig by 3.0e-5
F32_RTOL = 1e-5
F32_GRAD_RTOL = 3e-4


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return W.run_world(2, str(tmp_path_factory.mktemp("world2")), WORLD2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return W.run_world(4, str(tmp_path_factory.mktemp("world4")), WORLD4)


def _jax_model(name):
    locs, y, r, M, J, kern, params = W.case_data(name)
    return (JaxMRAModel(locs, r=r, M=M, J=J), y,
            jax_kernels.Kernel(kern, **params))


def _serial(name):
    m, y = W.model(name)
    kern, params = W.case_data(name)[5:]
    return m, y, m.sweep(Kernel(kern, **params), y, W.R)


@pytest.mark.parametrize("name,n", [("matern256", 2), ("pad30", 2),
                                    ("crit4096", 2), ("crit4096", 4)])
def test_sharded_sweep_matches_jax_and_serial(name, n, request):
    ranks = request.getfixturevalue(f"world{n}")
    jm, y, jk = _jax_model(name)
    mesh = jax_make_mesh({"data": n})
    # jitted: one XLA program (eager shard_map takes ~10x longer here)
    ref = jax.jit(lambda dp, k, yy: jax_sharded_sweep(dp, k, yy, W.R, mesh))(
        jm.dplan, jk, y)
    _, _, serial = _serial(name)
    for o in ranks:
        got = o[name]
        assert float(got["objective"]) == float(ranks[0][name]["objective"])
        for want in (ref, serial):
            np.testing.assert_allclose(float(got["objective"]),
                                       float(want.objective), rtol=1e-12)
            np.testing.assert_allclose(got["mean"].numpy(),
                                       np.asarray(want.mean), atol=1e-11)
            np.testing.assert_allclose(got["var"].numpy(),
                                       np.asarray(want.var), atol=1e-11)
        assert got["crit"] == jax_int_shard_level(jm.dplan, n)
    if name == "crit4096":
        # interior levels 2-3 shard at both rank counts
        assert ranks[0][name]["crit"] == 2


@pytest.mark.parametrize("name", list(W.CASES))
def test_padded_plan_metadata_equals_jax(name):
    m, _ = W.model(name)
    jm = _jax_model(name)[0]
    for n in (2, 3, 4, 8):
        ours = pad_plan_for_sharding(m.dplan, n)
        ref = jax_pad_plan_for_sharding(jm.dplan, n)
        assert int_shard_level(m.dplan, n) == jax_int_shard_level(jm.dplan, n)
        assert ours.int_shard_from == ref.int_shard_from
        assert ours.shard_groups == ref.shard_groups
        assert ours.groups == ref.groups
        assert ours.iota_groups == ref.iota_groups
        for a, b in zip(ours.levels, ref.levels):
            for f in ("int_knots", "int_parent", "leaf_locs", "leaf_loc_gidx",
                      "leaf_loc_mask", "leaf_is_knot", "leaf_path",
                      "leaf_parent"):
                assert tuple(getattr(a, f).shape) == getattr(b, f).shape, f
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), np.asarray(getattr(b, f)))
        # a replicated [N] map, as the JAX code builds it
        assert ours.post_inv.shape == (m.dplan.n_locs,)
        np.testing.assert_array_equal(ours.post_inv.numpy(),
                                      np.asarray(ref.post_inv))


@pytest.mark.parametrize("case,n", [("grad:grad144", 2),
                                    ("kgrad:grad144", 2),
                                    ("grad:crit4096", 2),
                                    ("grad:crit4096", 4)])
def test_sharded_gradient_matches_serial(case, n, request):
    # each rank's gradient as backward left it: no reduction by the caller
    ranks = request.getfixturevalue(f"world{n}")
    name = case.split(":")[1]
    m, y = W.model(name)
    kern, params = W.case_data(name)[5:]
    f = m.loglik_fn(y, W.R, kernel_builder=W.builder(kern))
    th = W.theta(params)
    value = f(th)
    value.backward()
    for o in ranks:
        got = o[case]
        np.testing.assert_allclose(float(got["value"]), value.item(),
                                   rtol=1e-12)
        for p in params:
            np.testing.assert_allclose(float(got["grad"][p]),
                                       float(th[p].grad), rtol=1e-9)


def test_float32_kernel_structure_sharded_matches_serial(world2):
    m, y = W.model("crit4096", torch.float32, W.F32_JITTER)
    kern, params = W.case_data("crit4096")[5:]
    serial = m.sweep(Kernel(kern, **params), y, W.R)
    f = m.loglik_fn(y, W.R, kernel_builder=W.builder(kern))
    th = W.theta(params)
    f(th).backward()
    for o in world2:
        got = o["f32"]
        assert got["objective"].dtype == torch.float32
        np.testing.assert_allclose(float(got["objective"]),
                                   float(serial.objective), rtol=F32_RTOL)
        for k in ("mean", "var"):
            want = getattr(serial, k).numpy()
            assert np.max(np.abs(got[k].numpy() - want)) <= (
                F32_RTOL * np.max(np.abs(want)))
        for p in params:
            np.testing.assert_allclose(float(got["grad"][p]),
                                       float(th[p].grad), rtol=F32_GRAD_RTOL)


def test_sharded_chains_match_local_chains(world2):
    local = hmc(W.chain_logp, W.chain_init(8),
                torch.Generator().manual_seed(1), **W.CHAIN_RUN)
    for r, o in enumerate(world2):
        got = o["chains"]
        np.testing.assert_allclose(got["samples"]["x"].numpy(),
                                   local.samples["x"].numpy(), atol=1e-10)
        # rank r ran chains [4r, 4r + 4) with those chains' seeds
        np.testing.assert_allclose(got["local"]["x"].numpy(),
                                   local.samples["x"][4 * r:4 * r + 4].numpy(),
                                   atol=1e-10)
        assert torch.equal(got["replicated"], torch.zeros(3))


def test_chain_by_data_mesh_matches_serial(world4):
    m, y = W.model("grad144")
    f = m.loglik_fn(y, W.R, kernel_builder=W.builder("matern32"))
    serial = hmc(W.mesh_logp(f), W.mesh_init(2),
                 torch.Generator().manual_seed(3), **W.MESH_RUN)
    for r, o in enumerate(world4):
        got = o["mesh"]
        partner = world4[r - r % 2]["mesh"]
        # data partners run in lockstep: bit-identical draws
        for k in got["local"]:
            assert torch.equal(got["local"][k], partner["local"][k])
            np.testing.assert_allclose(got["samples"][k].numpy(),
                                       serial.samples[k].numpy(), atol=1e-8)
        np.testing.assert_allclose(got["log_prob"].numpy(),
                                   serial.log_prob[r // 2:r // 2 + 1].numpy(),
                                   rtol=1e-10)


def test_keep_internals_refused_with_sharded_interiors(world2):
    for o in world2:
        for key in ("error", "batch_error"):
            assert "keep_internals is not supported" in o["refuse"][key]


def _batch_kernel(kern):
    return Kernel(kern, **W.batch_theta(W.BATCH))


def test_sharded_batch_matches_serial_batch(world2):
    # the sets through one sharded sweep: each set bit for bit the sharded
    # sweep of that set alone, the batch within the unbatched case's
    # limits of the serial batched sweep (the cross-rank sums reorder)
    m, y = W.model("crit4096")
    kern = W.case_data("crit4096")[5]
    serial = m.sweep(_batch_kernel(kern), y, W.R)
    for o in world2:
        got = o["batch:crit4096"]
        assert got["mean"].shape == (len(W.BATCH["l"]), m.dplan.n_locs)
        for c, one in enumerate(got["single"]):
            for k in ("objective", "mean", "var"):
                assert torch.equal(got[k][c], one[k]), (c, k)
        np.testing.assert_allclose(got["objective"].numpy(),
                                   serial.objective.numpy(), rtol=1e-12)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(),
                                       getattr(serial, k).numpy(), atol=1e-11)


def test_sharded_batched_loglik_fn_matches_serial_batch(world2):
    # batched=True: [C] values and gradients, each set's as the sharded
    # function of that set alone and the serial batched gradient's
    m, y = W.model("crit4096")
    kern = W.case_data("crit4096")[5]
    f = m.loglik_fn(y, W.R, kernel_builder=W.builder(kern), batched=True)
    th = W.batch_theta(W.BATCH, grad=True)
    value = f(th)
    value.sum().backward()
    for o in world2:
        (got,), singles = (o["bgrad:crit4096"]["batched"],
                           o["bgrad:crit4096"]["single"])
        np.testing.assert_allclose(got["value"].numpy(),
                                   value.detach().numpy(), rtol=1e-12)
        for c, one in enumerate(singles):
            assert float(got["value"][c]) == float(one["value"])
            for p in th:
                np.testing.assert_allclose(float(got["grad"][p][c]),
                                           float(one["grad"][p]), rtol=1e-12)
        for p in th:
            np.testing.assert_allclose(got["grad"][p].numpy(),
                                       th[p].grad.numpy(), rtol=1e-9)


def test_chain_by_data_mesh_lockstep_matches_serial(world4):
    # each chain rank runs its chains as one batch in lockstep over its
    # data group: data partners bit-identical, every chain as the serial
    # lockstep run of all chains draws it
    m, y = W.model("grad144")
    f = m.loglik_fn(y, W.R, kernel_builder=W.builder("matern32"),
                    batched=True)
    k = W.LOCKSTEP_CHAINS
    serial = hmc(W.mesh_logp(f), W.mesh_init(2 * k),
                 torch.Generator().manual_seed(3), batched=True, **W.MESH_RUN)
    for r, o in enumerate(world4):
        got = o["lockstep"]
        partner = world4[r - r % 2]["lockstep"]
        assert got["calls"] == partner["calls"] and max(got["calls"]) == k
        rows = slice(k * (r // 2), k * (r // 2 + 1))
        for p in got["local"]:
            assert torch.equal(got["local"][p], partner["local"][p])
            np.testing.assert_allclose(got["local"][p].numpy(),
                                       serial.samples[p][rows].numpy(),
                                       atol=1e-8)
        np.testing.assert_allclose(got["log_prob"].numpy(),
                                   serial.log_prob[rows].numpy(), rtol=1e-10)
