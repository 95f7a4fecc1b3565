"""The per-layer metrics that read the program's own spans and counters,
through the harness on the CPU at the tiny cells, and on a program that
keeps no spans."""
from __future__ import annotations

import io
import json
import math
import os
import re

import numpy as np
import pytest

from conftest import make_checkout

SEED = 2 ** 31 + 4099
HOST = ("fwd_host_ms", "bwd_host_ms", "plan_s")
STREAM = ("leaf_pass_device_ms", "posterior_pass_device_ms", "bwd_device_ms")
NEW = HOST + STREAM + ("sweep_idle_pct", "escalated_members_per_call")


@pytest.fixture
def spans_tiny(tmp_path, monkeypatch):
    """The harness at a tiny checkout that also reads ``plan_s`` in the
    tiny cells."""
    from portbench import harness

    dst = make_checkout(str(tmp_path))
    path = os.path.join(dst, "BENCHMARK.json")
    spec = json.load(open(path))
    for m in spec["per_layer"]:
        if m["name"] == "plan_s":
            m["workloads"] += ["tiny.grad4", "tiny.post4"]
    json.dump(spec, open(path, "w"))
    monkeypatch.setattr(harness, "ROOT", dst)
    monkeypatch.setattr(harness, "HERE", os.path.join(dst, "portbench"))
    return harness, spec


def _run(harness, workload):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, SEED, 1.0, True, device="cpu", out=out,
                     err=err)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    # a traced run's line holds the per-layer metrics; its set-up time is
    # on standard error
    setup_s = float(re.search(r"set-up ([0-9.]+) s", err.getvalue())[1])
    return {k: v["value"] for k, v in line["metrics"].items()}, setup_s


@pytest.mark.parametrize("workload", ["tiny.grad4", "tiny.post4"])
def test_span_metrics_read_the_traced_calls(spans_tiny, workload):
    """Every new entry of the cell reports a finite value; on the CPU the
    stream times are the spans' host times (the host runs each operation
    as it issues it); the planner is a part of the set-up, the program's
    idle share a part of the device's."""
    from pymra_torch.utils import profiling

    harness, spec = spans_tiny
    got, setup_s = _run(harness, workload)
    want = {m["name"] for m in spec["per_layer"]
            if m["name"].split(".")[0] in NEW and workload in m["workloads"]}
    kind = workload.split(".")[1][:4]
    assert want == {n for n in want if n.endswith("." + kind)} | {"plan_s"}
    assert set(got) >= want
    for name in want:
        assert math.isfinite(got[name]) and got[name] >= 0, name
    assert 0 < got["plan_s"] <= setup_s
    assert got[f"sweep_idle_pct.{kind}"] <= got[f"device_idle_pct.{kind}"]
    assert got[f"escalated_members_per_call.{kind}"] == 0

    # the traced calls' spans, as the readers took them
    recs = profiling.spans()
    roots = [r for r in recs if r["name"] == "pymra.call"][-3:]
    ids = {r["call"] for r in roots}
    mine = [r for r in recs if r["call"] in ids]
    fwd = np.median([r["host_ms"] for r in roots])
    assert got[f"fwd_host_ms.{kind}"] == pytest.approx(fwd, rel=1e-12)
    leaf = [r["host_ms"] for r in mine if r["name"] == "pymra.pass.B"]
    assert got[f"leaf_pass_device_ms.{kind}"] == pytest.approx(
        np.mean(leaf), rel=1e-12)
    if kind == "grad":
        bwd = [r["host_ms"] for r in mine if r["name"] == "pymra.bwd"]
        assert len(bwd) == 3 and got["bwd_host_ms.grad"] == pytest.approx(
            np.median(bwd), rel=1e-12)
    else:
        assert not [r for r in mine if r["name"].startswith("pymra.bwd")]
        post = [r["host_ms"] for r in mine if r["name"] == "pymra.pass.D"]
        assert got["posterior_pass_device_ms.post"] == pytest.approx(
            np.mean(post), rel=1e-12)
    plan, = [r for r in recs if r["name"] == "pymra.setup.plan"][-1:]
    assert got["plan_s"] == pytest.approx(plan["host_ms"] / 1e3, rel=1e-12)


def test_span_metrics_read_nothing_without_spans(monkeypatch):
    """A program that keeps no spans (an older tree's) reads as nothing:
    every new reader returns None and raises nothing, also with a trace."""
    from portbench import harness
    from portbench.yardstick.trace import Trace
    from pymra_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    tr = Trace([("k", 1.0, 2.0)], [("pymra.clock", 0.5, 0.6)], (0.0, 3.0),
               1, [])
    for name in NEW:
        reader = harness.module("metrics", name)
        assert reader.read({"trace": tr, "setup_s": 1.0}) is None, name
        assert reader.read({"trace": None, "setup_s": 1.0}) is None, name
