"""Traffic kind ``posterior``: the full sweep of ``C`` parameter sets at
once, ``MRAModel.sweep`` with a batched ``Kernel`` (likelihood and the
posterior mean and variance at every location), and the posterior
standard deviation from the variance, as a map averaged over
hyper-parameter draws needs them. The call ends when the device has
finished; the maps stay on the device.

Compared with the reference, the worst over the checked sets: each set's
objective (its error relative to the reference's, or to the median size
over the checked sets where that is larger), the root-mean-square error of
its posterior mean over all locations and the largest error of its
posterior standard deviation, each over the largest value of the
reference's map. (The mean's largest error, a widest gap over 10^6
locations, swings from seed to seed and does not separate the float32
program from the control; its root mean square does.) The maps are made
from every factor of passes A to C, so they check those passes too.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Runner", "reference_outputs", "compare", "flops_per_set"]


def flops_per_set(shape: dict) -> float:
    from portbench.yardstick.flops import sweep_flops

    return sweep_flops(shape, posterior=True)


class Runner:
    def __init__(self, model, y: np.ndarray, cfg: dict, device):
        from pymra_torch import Kernel

        self.Kernel = Kernel
        self.model = model
        self.cov = cfg["covariance"]
        self.R = cfg["R"]
        self.device = torch.device(device)
        self.y = torch.as_tensor(y, dtype=model.dtype, device=self.device)

    def enqueue(self, sets: dict):
        kern = self.Kernel(self.cov, **{
            k: torch.tensor(v, dtype=torch.float64, device=self.device)
            for k, v in sets.items()})
        res = self.model.sweep(kern, self.y, self.R)
        return {"objective": res.objective, "mean": res.mean,
                "sd": torch.sqrt(torch.clamp(res.var, min=0.0))}

    def finish(self, pending) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return pending

    def call(self, sets: dict) -> tuple[float, float, dict]:
        """``(enqueue seconds, call seconds, outputs on the device)``."""
        t0 = time.perf_counter()
        pending = self.enqueue(sets)
        t1 = time.perf_counter()
        out = self.finish(pending)
        return t1 - t0, time.perf_counter() - t0, out

    @staticmethod
    def failed(out: dict) -> int:
        return int((~torch.isfinite(out["objective"])).sum())

    @staticmethod
    def keep(out: dict) -> dict:
        return {k: v.detach() for k, v in out.items()}

    @staticmethod
    def pick(out: dict, c: int) -> dict:
        return {"objective": float(out["objective"][c]),
                "mean": out["mean"][c].double().cpu().numpy(),
                "sd": out["sd"][c].double().cpu().numpy()}


def reference_outputs(ref, l: np.ndarray, sig: np.ndarray, chunk: int
                      ) -> list[dict]:
    """The reference's objective and posterior maps at each set."""
    out = []
    with torch.no_grad():
        for i in range(0, len(l), chunk):
            res = ref.sweep(torch.tensor(l[i:i + chunk]),
                            torch.tensor(sig[i:i + chunk]), posterior=True)
            obj = res["objective"].double().cpu().numpy()
            mean = res["mean"].double().cpu().numpy()
            sd = np.sqrt(np.maximum(res["var"].double().cpu().numpy(), 0.0))
            out += [{"objective": float(obj[j]), "mean": mean[j],
                     "sd": sd[j]} for j in range(len(obj))]
            del res
    return out


def compare(got: list[dict], want: list[dict]) -> dict:
    """The numbers compared, each the worst over the checked sets."""
    def scaled(g, w, key):
        return np.abs(g[key] - w[key]) / np.max(np.abs(w[key]))

    obj = np.array([w["objective"] for w in want])
    err = np.abs(np.array([g["objective"] for g in got]) - obj)
    size = np.abs(obj)
    nums = {"objective_err": float(np.max(
                err / np.maximum(size, np.median(size)))),
            "mean_rms_err": max(float(np.sqrt(np.mean(
                scaled(g, w, "mean") ** 2))) for g, w in zip(got, want)),
            "sd_err": max(float(np.max(scaled(g, w, "sd")))
                          for g, w in zip(got, want))}
    return {k: (v if np.isfinite(v) else float("inf"))
            for k, v in nums.items()}
