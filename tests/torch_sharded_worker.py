"""The ranks of ``tests/test_torch_sharded.py``: gloo worlds of CPU
processes that run the port's sharded sweep, gradient and chains on the
cases below and save what they got. Imports torch and the port only, so a
spawned rank pays no JAX import.

Each case's data come from a numpy seed; the test module builds the same
inputs for the JAX package and the port's serial sweep.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

#: a world's join deadline and its collectives' timeout (seconds)
DEADLINE_S = 300
R = 1e-3

#: case -> (locations (grid kind, size), r, M, J, kernel, params, data seed)
CASES = {
    "matern256": (("2d", 16), 4, 2, 4, "matern32", {"l": 0.4, "sig": 1.2}, 0),
    "pad30": (("1d", 30), 2, 3, 3, "exponential", {"l": 0.5, "sig": 1.0}, 3),
    "crit4096": (("2d", 64), 4, 4, 4, "matern32", {"l": 0.3, "sig": 1.1}, 7),
    "grad144": (("2d", 12), 4, 2, 4, "matern32", {"l": 0.4, "sig": 1.0}, 5),
}
#: the float32 kernel structure's jitter (the port's default for float32)
F32_JITTER = 1e-6
#: chains of the chain-axis case (the JAX package's
#: tests/test_aux.py::TestChainSharding) and of the chain x data mesh
CHAIN_RUN = {"num_warmup": 50, "num_samples": 50, "num_leapfrog": 4}
MESH_RUN = {"num_warmup": 5, "num_samples": 5, "num_leapfrog": 3}
#: the batched cases' parameter sets, through one sharded sweep
BATCH = {"l": (0.3, 0.45), "sig": (1.1, 0.9)}
#: chains a rank of the chain axis runs in lockstep (the batched mesh case)
LOCKSTEP_CHAINS = 2


def batch_theta(values, grad=False):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=grad)
            for k, v in values.items()}


def case_data(name):
    """``(locs, y, r, M, J, kernel name, params)`` of a case."""
    from pymra_torch.utils import gen_locations, gen_locations_2d

    (kind, size), r, M, J, kern, params, seed = CASES[name]
    locs = gen_locations_2d(size) if kind == "2d" else gen_locations(size)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(len(locs))
    y[rng.random(len(locs)) > 0.6] = np.nan
    return locs, y, r, M, J, kern, params


def model(name, dtype=torch.float64, jitter=None):
    from pymra_torch import MRAModel

    locs, y, r, M, J, _, _ = case_data(name)
    return MRAModel(locs, r=r, M=M, J=J, dtype=dtype, jitter=jitter,
                    device="cpu"), y


def builder(kern):
    from pymra_torch import Kernel

    return lambda th: Kernel(kern, l=th["l"], sig=th["sig"])


def theta(params):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for k, v in params.items()}


def chain_init(n_chains):
    return {"x": torch.randn(n_chains, 2, generator=torch.Generator()
                             .manual_seed(0), dtype=torch.float64)}


def chain_logp(th):
    return -0.5 * torch.sum(th["x"] ** 2)


def mesh_logp(f):
    """The chain x data case's log density over ``log_l``, ``log_sig``."""
    def logp(th):
        return f({"l": th["log_l"].exp(), "sig": th["log_sig"].exp()})

    return logp


def mesh_init(n_chains):
    g = torch.Generator().manual_seed(2)
    return {"log_l": -0.9 + 0.05 * torch.randn(n_chains, generator=g,
                                               dtype=torch.float64),
            "log_sig": 0.1 * torch.randn(n_chains, generator=g,
                                         dtype=torch.float64)}


def _sweep_case(name, mesh, dtype=torch.float64, jitter=None):
    from pymra_torch import Kernel
    from pymra_torch.parallel import pad_plan_for_sharding, sharded_sweep

    m, y = model(name, dtype, jitter)
    _, _, _, _, _, kern, params = case_data(name)
    n = mesh.size()
    res = sharded_sweep(m.dplan, Kernel(kern, **params), y, R, mesh,
                        jitter=m.jitter)
    return {"objective": res.objective, "mean": res.mean, "var": res.var,
            "crit": pad_plan_for_sharding(m.dplan, n).int_shard_from}


def _grad_case(name, mesh, dtype=torch.float64, jitter=None,
               kernel_theta=False):
    from pymra_torch import Kernel
    from pymra_torch.parallel import sharded_loglik_fn

    m, y = model(name, dtype, jitter)
    _, _, _, _, _, kern, params = case_data(name)
    if kernel_theta:
        # no builder: the Kernel's own buffers receive the gradient
        f = sharded_loglik_fn(m.dplan, y, R, mesh, jitter=m.jitter)
        k = Kernel(kern, **{p: torch.tensor(v, dtype=torch.float64,
                                            requires_grad=True)
                            for p, v in params.items()})
        value = f(k)
        value.backward()
        return {"value": value.detach(),
                "grad": {p: getattr(k, p).grad for p in params}}
    f = sharded_loglik_fn(m.dplan, y, R, mesh, jitter=m.jitter,
                          kernel_builder=builder(kern))
    th = theta(params)
    value = f(th)
    value.backward()
    return {"value": value.detach(), "grad": {p: th[p].grad for p in th}}


def _batch_sweep_case(name, mesh):
    """The sharded sweep of the sets ``BATCH`` batched, and of each set
    alone on the same ranks."""
    from pymra_torch import Kernel
    from pymra_torch.parallel import sharded_sweep

    m, y = model(name)
    kern = case_data(name)[5]

    def run(values):
        res = sharded_sweep(m.dplan, Kernel(kern, **batch_theta(values)), y,
                            R, mesh, jitter=m.jitter)
        return {"objective": res.objective, "mean": res.mean,
                "var": res.var}

    return {**run(BATCH), "single": [
        run({k: v[c] for k, v in BATCH.items()})
        for c in range(len(BATCH["l"]))]}


def _batch_grad_case(name, mesh):
    """``sharded_loglik_fn(..., batched=True)``: the sets' values and the
    gradient of their sum, and each set alone."""
    from pymra_torch.parallel import sharded_loglik_fn

    m, y = model(name)
    kern = case_data(name)[5]
    out = {}
    for batched in (True, False):
        f = sharded_loglik_fn(m.dplan, y, R, mesh, jitter=m.jitter,
                              kernel_builder=builder(kern), batched=batched)
        sets = ([BATCH] if batched else
                [{k: v[c] for k, v in BATCH.items()}
                 for c in range(len(BATCH["l"]))])
        runs = []
        for values in sets:
            th = batch_theta(values, grad=True)
            value = f(th)
            value.sum().backward()
            runs.append({"value": value.detach(),
                         "grad": {k: t.grad for k, t in th.items()}})
        out["batched" if batched else "single"] = runs
    return out


def _chains_case(mesh, n_chains=8):
    from pymra_torch.infer import hmc
    from pymra_torch.parallel.chains import (
        gather_chains,
        replicate,
        shard_chains,
        shard_generators,
    )

    gen = torch.Generator().manual_seed(1)
    res = hmc(chain_logp, shard_chains(chain_init(n_chains), mesh, "chain"),
              shard_generators(gen, n_chains, mesh, "chain"), **CHAIN_RUN)
    rank = torch.distributed.get_rank()
    return {"samples": gather_chains(res.samples, mesh, "chain"),
            "local": res.samples,
            "replicated": replicate({"v": torch.full((3,), float(rank))},
                                    mesh)["v"]}


def _mesh_case(mesh, name="grad144"):
    from pymra_torch.infer import hmc
    from pymra_torch.parallel.chains import (
        gather_chains,
        shard_chains,
        shard_generators,
    )
    from pymra_torch.parallel.sharded import sharded_loglik_fn

    m, y = model(name)
    kern = case_data(name)[5]
    f = sharded_loglik_fn(m.dplan, y, R, mesh, axis="data", jitter=m.jitter,
                          kernel_builder=builder(kern))
    chains = mesh.size(0)
    gen = torch.Generator().manual_seed(3)
    res = hmc(mesh_logp(f), shard_chains(mesh_init(chains), mesh, "chain"),
              shard_generators(gen, chains, mesh, "chain"), **MESH_RUN)
    return {"local": res.samples, "log_prob": res.log_prob,
            "samples": gather_chains(res.samples, mesh, "chain")}


def _mesh_lockstep_case(mesh, name="grad144"):
    """The chain x data mesh with each chain rank's chains in lockstep:
    one batched sharded evaluation of all of them a leapfrog step."""
    from pymra_torch.infer import hmc
    from pymra_torch.parallel.chains import shard_chains, shard_generators
    from pymra_torch.parallel.sharded import sharded_loglik_fn

    m, y = model(name)
    kern = case_data(name)[5]
    f = sharded_loglik_fn(m.dplan, y, R, mesh, axis="data", jitter=m.jitter,
                          kernel_builder=builder(kern), batched=True)
    calls = []

    def logp(th):
        calls.append(th["log_l"].shape[0])
        return mesh_logp(f)(th)

    chains = LOCKSTEP_CHAINS * mesh.size(0)
    gen = torch.Generator().manual_seed(3)
    res = hmc(logp, shard_chains(mesh_init(chains), mesh, "chain"),
              shard_generators(gen, chains, mesh, "chain"), batched=True,
              **MESH_RUN)
    return {"local": res.samples, "log_prob": res.log_prob, "calls": calls}


def _refuse_case(mesh):
    """keep_internals on a rank's slice with sharded interior levels: the
    JAX package's refusal, raised before any collective, with one set and
    with a batch of them."""
    from pymra_torch import Kernel
    from pymra_torch.parallel.sharded import local_plan, pad_plan_for_sharding
    from pymra_torch.tree.sweep import mra_sweep

    m, y = model("crit4096")
    group = mesh.get_group("data")
    n = mesh.size()
    local = local_plan(pad_plan_for_sharding(m.dplan, n),
                       torch.distributed.get_rank(group), n)
    out = {}
    batch = torch.tensor([0.3, 0.4], dtype=torch.float64)
    for key, l in (("error", 0.3), ("batch_error", batch)):
        try:
            mra_sweep(local, Kernel("matern32", l=l), y, R, axis_name=group,
                      keep_internals=True)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def _rank_main(rank, n_ranks, tmp, cases):
    import torch.distributed as dist

    from pymra_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(
        "gloo", device_type="cpu",
        store=dist.FileStore(os.path.join(tmp, "store"), n_ranks),
        world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    data = make_mesh({"data": n_ranks}, device_type="cpu")
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        if case in CASES:
            out[case] = _sweep_case(case, data)
        elif case.startswith("grad:"):
            out[case] = _grad_case(case[5:], data)
        elif case.startswith("kgrad:"):
            out[case] = _grad_case(case[6:], data, kernel_theta=True)
        elif case == "f32":
            out[case] = {**_sweep_case("crit4096", data, torch.float32,
                                       F32_JITTER),
                         **_grad_case("crit4096", data, torch.float32,
                                      F32_JITTER)}
        elif case == "chains":
            out[case] = _chains_case(make_mesh({"chain": n_ranks},
                                               device_type="cpu"))
        elif case.startswith("batch:"):
            out[case] = _batch_sweep_case(case[6:], data)
        elif case.startswith("bgrad:"):
            out[case] = _batch_grad_case(case[6:], data)
        elif case == "refuse":
            out[case] = _refuse_case(data)
        elif case in ("mesh", "lockstep"):
            run = _mesh_case if case == "mesh" else _mesh_lockstep_case
            out[case] = run(make_mesh({"chain": 2, "data": n_ranks // 2},
                                      device_type="cpu"))
        else:
            raise ValueError(f"unknown case {case!r}")
        out[case]["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_world(n_ranks: int, tmp: str, cases: list) -> list:
    """Run ``cases`` on a gloo world of ``n_ranks`` spawned CPU processes
    (``chip_smoke.run_ranks``: a rank that fails or outlives the deadline
    fails the world); returns each rank's results."""
    import chip_smoke

    chip_smoke.run_ranks(_rank_main, n_ranks, tmp, (cases,), DEADLINE_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(n_ranks)]
