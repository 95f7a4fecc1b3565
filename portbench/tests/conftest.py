"""Fixtures of the benchmark's own tests (run with ``python -m pytest
portbench/tests``): a tiny checkout on the CPU, and the look for a card,
made inside a fixture so that every worker collects the same tests."""
from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: a 48 x 48 grid, 4 knots a node, 3 levels: 16 deepest interior nodes and
#: 64 leaves of up to 36 locations; every node is large enough for the
#: frozen planner's rules
TINY_CONFIG = {
    "name": "tiny", "source": "test", "covariance": "exponential",
    "data": {"kind": "grid_field", "side": 48, "missing": 0.1,
             "features": 64, "l": 0.05, "sig": 1.0, "noise_var": 0.01},
    "R": 0.01, "r": 4, "J": 4, "M": 3, "planner_seed": 0,
    "dtype": "float32", "jitter": 1e-6, "reference": "mra",
    "reference_chunk": 4,
}
#: limits at the tiny size on the CPU, from the program's readings there
#: against the jittered float64 reference over twelve seeds
#: (loglik_abs_err 0.067, grad_err 1.0e-3, objective_err 1.2e-3,
#: mean_rms_err 4.5e-5, sd_err 4.8e-4 at most), with room
TINY_LIMITS = {
    "tiny.grad4": {"plan_mismatch": 0, "unchecked_calls": 0,
                   "loglik_abs_err": 0.3, "grad_err": 5e-3},
    "tiny.post4": {"plan_mismatch": 0, "unchecked_calls": 0,
                   "objective_err": 5e-3, "mean_rms_err": 2.5e-4,
                   "sd_err": 2.5e-3},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); run on the chip")


def make_checkout(dst: str, extra_cells=()) -> str:
    """A copy of the benchmark under ``dst`` whose ``BENCHMARK.json`` also
    names the tiny cells (and ``extra_cells``), with their files."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    for name, traffic in (("tiny.grad4", "grad4"), ("tiny.post4", "post4")):
        # the same mixes, checking every set of the window's first call (a
        # stale answer is then the warm-up's)
        with open(os.path.join(ROOT, "portbench", "traffic",
                               traffic + ".json")) as fh:
            mix = json.load(fh)
        mix["check"] = {"sets": mix["C"], "within_calls": 1}
        traffic = "t" + traffic
        with open(os.path.join(dst, "portbench", "traffic",
                               traffic + ".json"), "w") as fh:
            json.dump(mix, fh)
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        metric = "grad" if traffic == "tgrad4" else "post"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and (m["name"].endswith("." + metric)
                                     or m["name"].startswith(metric)
                                     or m["name"] in ("call_p95_ms",
                                                      "peak_mem_gib")):
                m["workloads"].append(name)
        with open(os.path.join(dst, "portbench", "limits", name + ".json"),
                  "w") as fh:
            json.dump(TINY_LIMITS[name], fh)
    spec["workloads"] += list(extra_cells)
    with open(os.path.join(dst, "portbench", "configs", "tiny.json"),
              "w") as fh:
        json.dump(TINY_CONFIG, fh)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return dst


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The harness pointed at a tiny checkout, in this process."""
    from portbench import harness

    dst = make_checkout(str(tmp_path))
    monkeypatch.setattr(harness, "ROOT", dst)
    monkeypatch.setattr(harness, "HERE", os.path.join(dst, "portbench"))
    return harness
