"""The general-nu Matern cell's files on the CPU: a tiny cell of the same
configuration, data maker and reference under grad4's traffic runs through
the harness and comes out correct with the cell's metrics, and one whose
program runs another smoothness does not."""
from __future__ import annotations

import io
import json
import os

from conftest import make_checkout

SEED = 2 ** 31 + 4099
CELL = "tinynu.grad4"
#: grid1m_matern08 at the 44 x 44 grid (N = 1,936), 4 knots a node, 3
#: levels: every node is large enough for the frozen planner's rules
CONFIG = {
    "name": "tinynu", "source": "test", "covariance": "matern(nu=0.8)",
    "data": {"kind": "matern_field", "side": 44, "missing": 0.1,
             "features": 64, "l": 0.05, "sig": 1.0, "noise_var": 0.01,
             "nu": 0.8},
    "R": 0.01, "r": 4, "J": 4, "M": 3, "planner_seed": 0,
    "dtype": "float32", "jitter": 1e-6, "reference": "mra_matern",
    "reference_chunk": 4,
}
#: the tiny cells' limits (conftest.py)
LIMITS = {"plan_mismatch": 0, "unchecked_calls": 0, "loglik_abs_err": 0.3,
          "grad_err": 5e-3}


def checkout(tmp_path, monkeypatch, nu):
    """The harness pointed at a tiny checkout with the cell, its program
    at smoothness ``nu``."""
    from portbench import harness

    dst = make_checkout(str(tmp_path), [{
        "name": CELL, "config": "tinynu", "traffic": "tgrad4", "chips": 1,
        "why": "test"}])
    pb = os.path.join(dst, "portbench")
    with open(os.path.join(pb, "configs", "tinynu.json"), "w") as fh:
        json.dump(dict(CONFIG, covariance=f"matern(nu={nu})"), fh)
    with open(os.path.join(pb, "limits", CELL + ".json"), "w") as fh:
        json.dump(LIMITS, fh)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tinynu", "source": "test",
                            "file": "portbench/configs/tinynu.json",
                            "reduced": [], "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "grid1m_matern08.grad4" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(path, "w") as fh:
        json.dump(spec, fh)
    monkeypatch.setattr(harness, "ROOT", dst)
    monkeypatch.setattr(harness, "HERE", pb)
    return harness, spec


def _run(harness):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, SEED, 1.0, True, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_tiny_matern_cell_is_correct_and_reports_its_metrics(tmp_path,
                                                              monkeypatch):
    harness, spec = checkout(tmp_path, monkeypatch, CONFIG["data"]["nu"])
    line = _run(harness)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    want = {m["name"] for m in spec["per_layer"]
            if CELL in m.get("workloads", [])}
    # on the CPU the kernel's device readings are absent
    device_only = {"matern_roofline"}
    assert want - device_only <= set(line["metrics"]) <= want
    assert line["metrics"]["cov_entries_per_set"]["value"] > 0


def test_another_smoothness_is_not_correct(tmp_path, monkeypatch):
    """The program at nu = 1.3 against the reference's 0.8."""
    harness, _ = checkout(tmp_path, monkeypatch, 1.3)
    line = _run(harness)
    assert line["correct"] is False
    assert line["checks"]["loglik_abs_err"]["value"] > LIMITS["loglik_abs_err"]
