"""The benchmark's harness on the CPU: its files found by name, its
contract, its result line, its refusals, and its check catching a broken
timed path."""
from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, make_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 4099


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def run_line(harness, workload, trace, fault=None, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, 1.0, trace, device="cpu", fault=fault,
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_every_named_file_is_found():
    from portbench import harness

    s = spec()
    for c in s["configs"]:
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"]
        harness.module("datasets", cfg["data"]["kind"])
        harness.module("reference", cfg["reference"])
    for w in s["workloads"]:
        mix = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
        kind = harness.module("traffic", mix["kind"])
        for attr in ("Runner", "reference_outputs", "compare",
                     "flops_per_set"):
            assert hasattr(kind, attr)
        limits = harness.load_json(harness.HERE, "limits",
                                   w["name"] + ".json")
        assert limits["plan_mismatch"] == 0
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.module("metrics",
                                       m["name"].split(".")[0]).read)


def test_spec_keeps_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    layers = set()
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        layers.add(m["layer"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert layers == {"facade and sweep", "library ops",
                      "hand-written kernels", "device"}
    configs = {c["name"] for c in s["configs"]}
    for w in s["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        assert 1 <= len(w["why"]) <= 200
        reported = [m for m in s["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) > 1
        assert any(w["name"] in m["workloads"] for m in s["per_layer"])
    assert len(json.dumps(s)) < 64 * 1024


def test_forbidden_modules_match_whole_top_level_names():
    from portbench.harness import forbidden_modules

    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "pymra_tpu", "pymra_tpu.tree.sweep", "pymra_torch",
              "pymra_torch.tree", "jaxtyping", "pymra_tpu_extra", "flaxen"]
    assert forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "pymra_tpu",
        "pymra_tpu.tree.sweep"]
    assert forbidden_modules(["pymra_torch", "portbench.harness"]) == []


@pytest.mark.parametrize("workload", ["tiny.grad4", "tiny.post4"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny, workload, trace):
    line, err = run_line(tiny, workload, trace)
    keys = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    if trace:
        keys.add("breakdown")
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line) == keys and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0, err[-1500:]
    assert line["attempted"] > 0
    s = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
    group = s["per_layer"] if trace else s["end_to_end"]
    want = {m["name"] for m in group if workload in m.get("workloads",
                                                           [workload])}
    # on the CPU the device's own readings are absent
    device_only = {"peak_mem_gib", "launches_per_call", "k1_roofline",
                   "library_device_ms_per_set",
                   "own_kernels_device_ms_per_set"}
    assert want - {n for n in want if n.split(".")[0] in device_only} \
        <= set(line["metrics"]) <= want
    assert line["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "(limit " in t for t in tail)


def _wrap_grad(runner, fn):
    f = runner.f
    runner.f = lambda theta: fn(f, theta)


def _half(f, theta):
    C = len(theta["l"])
    v = f({k: t[:C // 2] for k, t in theta.items()})
    return torch.cat([v, v.mean().expand(C - C // 2)])


def _rolled(f, theta):
    return f({k: t.roll(1) for k, t in theta.items()})


def _stale(runner):
    finish, first = runner.finish, []

    def stale(pending):
        out = finish(pending)
        if not first:
            first.append(out)
        return first[0]

    runner.finish = stale


class _Sweep:
    """The posterior runner's model with its sweep broken."""

    def __init__(self, model, how):
        self.model, self.how = model, how

    def sweep(self, kern, y, R):
        from pymra_torch import Kernel

        p = kern.params
        C = len(p["l"])
        if self.how == "rolled":
            return self.model.sweep(Kernel(kern.name, **{
                k: v.roll(1) for k, v in p.items()}), y, R)
        res = self.model.sweep(Kernel(kern.name, **{
            k: v[:C // 2] for k, v in p.items()}), y, R)

        def fill(t):
            return torch.cat([t, t.mean(0, keepdim=True).expand(
                (C - C // 2,) + t.shape[1:])])

        return type(res)(*(fill(t) for t in res))


def _fault(workload, how):
    def apply(runner):
        if how == "stale":
            _stale(runner)
        elif workload == "tiny.grad4":
            _wrap_grad(runner, _half if how == "half" else _rolled)
        else:
            runner.model = _Sweep(runner.model, how)
    return apply


@pytest.mark.parametrize("workload", ["tiny.grad4", "tiny.post4"])
@pytest.mark.parametrize("how", ["stale", "half", "rolled"])
def test_broken_timed_path_is_not_correct(tiny, workload, how):
    """A call that returns its first answer again, half of the batch
    computed and the rest filled with its mean, and each set's answer made
    with its neighbour's parameters: ``correct`` comes out false. (One
    card: there is no exchange between cards to leave out.)"""
    line, _ = run_line(tiny, workload, False, fault=_fault(workload, how))
    assert line["correct"] is False
    bad = [k for k, v in line["checks"].items()
           if v["value"] is None or v["value"] > v["limit"]]
    assert bad and "plan_mismatch" not in bad


def test_no_card_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from portbench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("grid1m.grad4", SEED, 1.0, False, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
    assert "cuda" in err.getvalue().lower()
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "grid1m.post4",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_added_files_are_found_without_an_edit(tmp_path):
    """A new configuration, traffic mix, limits file and metric reader are
    found by name from new entries alone: no file that is there changes."""
    extra = {"name": "tiny2.grad8", "config": "tiny2", "traffic": "grad8",
             "chips": 1, "why": "test"}
    dst = make_checkout(str(tmp_path), [extra])
    pb = os.path.join(dst, "portbench")
    before = {}
    for d, _, files in os.walk(pb):
        for f in files:
            p = os.path.join(d, f)
            before[p] = open(p, "rb").read()
    cfg = json.load(open(os.path.join(pb, "configs", "tiny.json")))
    cfg["name"] = "tiny2"
    json.dump(cfg, open(os.path.join(pb, "configs", "tiny2.json"), "w"))
    mix = json.load(open(os.path.join(pb, "traffic", "tgrad4.json")))
    mix["C"] = 8
    json.dump(mix, open(os.path.join(pb, "traffic", "grad8.json"), "w"))
    json.dump({"plan_mismatch": 0, "unchecked_calls": 0,
               "loglik_abs_err": 0.3, "grad_err": 5e-3},
              open(os.path.join(pb, "limits", "tiny2.grad8.json"), "w"))
    with open(os.path.join(pb, "metrics", "calls_in_window.py"), "w") as fh:
        fh.write("def read(ctx):\n    return float(ctx['n_calls'])\n")
    s = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    s["configs"].append({"name": "tiny2", "source": "test",
                         "file": "portbench/configs/tiny2.json",
                         "reduced": [], "why": "test"})
    s["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "facade and sweep",
                           "moves": "grad_sets_per_s",
                           "workloads": ["tiny2.grad8"]})
    s["end_to_end"][0]["workloads"].append("tiny2.grad8")
    json.dump(s, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    code = ("import sys; sys.path.insert(0, %r); sys.path.append(%r); "
            "from portbench.harness import run; "
            "sys.exit(run('tiny2.grad8', %d, 1.0, True, device='cpu'))"
            % (dst, ROOT, SEED))
    proc = subprocess.run([sys.executable, "-c", code], cwd=dst,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] % 8 == 0
    assert line["metrics"]["calls_in_window"]["value"] >= 1
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


PLANTS = {
    # a metric reader that loads a module of JAX when it reads
    "metrics": ("metrics/planted.py",
                "import sys, types\n\n\ndef read(ctx):\n"
                "    sys.modules['jax.planted'] = types.ModuleType("
                "'jax.planted')\n    return 1.0\n"),
    # a reference that loads one when it is built, after the window
    "reference": ("reference/planted.py",
                  "import sys, types\n\n"
                  "from portbench.reference.mra import Reference as _R\n\n\n"
                  "class Reference(_R):\n"
                  "    def __init__(self, *a, **k):\n"
                  "        sys.modules['pymra_tpu.planted'] = "
                  "types.ModuleType('pymra_tpu.planted')\n"
                  "        super().__init__(*a, **k)\n"),
}


@pytest.mark.parametrize("where", sorted(PLANTS))
def test_a_module_of_jax_loaded_after_the_window_ends_the_run(tmp_path,
                                                              where):
    """The look for modules of JAX comes after every import a run makes: a
    metric reader or a reference that loads one ends the run with no
    result, its name on standard error."""
    dst = make_checkout(str(tmp_path))
    pb = os.path.join(dst, "portbench")
    rel, code = PLANTS[where]
    with open(os.path.join(pb, rel), "w") as fh:
        fh.write(code)
    if where == "metrics":
        s = json.load(open(os.path.join(dst, "BENCHMARK.json")))
        s["end_to_end"].append({"name": "planted", "unit": "n",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.grad4"]})
        json.dump(s, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    else:
        cfg_path = os.path.join(pb, "configs", "tiny.json")
        cfg = json.load(open(cfg_path))
        cfg["reference"] = "planted"
        json.dump(cfg, open(cfg_path, "w"))
    code = ("import sys; sys.path.insert(0, %r); sys.path.append(%r); "
            "from portbench.harness import run; "
            "sys.exit(run('tiny.grad4', %d, 1.0, False, device='cpu'))"
            % (dst, ROOT, SEED))
    proc = subprocess.run([sys.executable, "-c", code], cwd=dst,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr[-3000:]
    assert "planted" in proc.stderr.strip().splitlines()[-1]


def test_seed_fixes_the_inputs(tiny):
    a, _ = run_line(tiny, "tiny.grad4", False, seed=SEED)
    b, _ = run_line(tiny, "tiny.grad4", False, seed=SEED)
    for k in ("loglik_abs_err", "grad_err"):
        assert a["checks"][k]["value"] == b["checks"][k]["value"]
    assert math.isfinite(a["metrics"]["setup_s"]["value"])
