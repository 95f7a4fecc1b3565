"""Traffic kind ``value_and_grad``: the log-likelihood of ``C`` parameter
sets and its gradient in each set's ``l`` and ``sig``, through one batched
``MRAModel.loglik_fn`` and autograd, as a maximum-likelihood fit from
several starts or a sampler with its chains in lockstep calls it: the
parameters are float64 tensors on the card (so that the backward pass
does not wait on a copy to the host), and the call ends when the values
and the gradients are back on the host.

Compared with the reference over the checked sets:

* ``loglik_abs_err``: the largest error of a set's log-likelihood, in
  log-likelihood units. (Not relative to the value: with some seeds' data
  the log-likelihood passes through zero among the sets, while its float32
  error follows the size of the terms it sums.)
* ``grad_err``: the largest error of a set's gradient, taken in the
  log-parameters (``l d/dl``, ``sig d/dsig``: the scale a sampler or an
  optimizer on the log scale moves in), as a vector norm, relative to the
  reference gradient's norm, or to the median norm over the checked sets
  where that is larger (a gradient can come near zero).
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Runner", "reference_outputs", "compare", "flops_per_set"]


def flops_per_set(shape: dict) -> float:
    from portbench.yardstick.flops import value_and_grad_flops

    return value_and_grad_flops(shape)


class Runner:
    def __init__(self, model, y: np.ndarray, cfg: dict, device):
        from pymra_torch import Kernel

        cov = cfg["covariance"]
        self.device = torch.device(device)
        self.f = model.loglik_fn(
            y, cfg["R"], batched=True,
            kernel_builder=lambda th: Kernel(cov, l=th["l"], sig=th["sig"]))

    def enqueue(self, sets: dict):
        """Start one call; returns what :meth:`finish` reads back."""
        theta = {k: torch.tensor(v, dtype=torch.float64, device=self.device,
                                 requires_grad=True)
                 for k, v in sets.items()}
        value = self.f(theta)
        value.sum().backward()
        return value, theta

    @staticmethod
    def finish(pending) -> dict:
        value, theta = pending
        grad = torch.stack([theta["l"].grad, theta["sig"].grad], dim=-1)
        return {"loglik": value.detach().double().cpu().numpy(),
                "grad": grad.cpu().numpy()}

    def call(self, sets: dict) -> tuple[float, float, dict]:
        """``(enqueue seconds, call seconds, outputs on the host)``."""
        t0 = time.perf_counter()
        pending = self.enqueue(sets)
        t1 = time.perf_counter()
        out = self.finish(pending)
        return t1 - t0, time.perf_counter() - t0, out

    @staticmethod
    def failed(out: dict) -> int:
        ok = np.isfinite(out["loglik"]) & np.isfinite(out["grad"]).all(-1)
        return int((~ok).sum())

    @staticmethod
    def keep(out: dict) -> dict:
        return out

    @staticmethod
    def pick(out: dict, c: int) -> dict:
        return {"loglik": float(out["loglik"][c]), "grad": out["grad"][c]}


def reference_outputs(ref, l: np.ndarray, sig: np.ndarray, chunk: int
                      ) -> list[dict]:
    """The reference's log-likelihood and gradient at each set."""
    out = []
    for i in range(0, len(l), chunk):
        lt = torch.tensor(l[i:i + chunk], dtype=torch.float64,
                          requires_grad=True)
        st = torch.tensor(sig[i:i + chunk], dtype=torch.float64,
                          requires_grad=True)
        res = ref.sweep(lt.to(ref.device), st.to(ref.device))
        res["loglik"].sum().backward()
        ll = res["loglik"].detach().double().cpu().numpy()
        g = np.stack([lt.grad.numpy(), st.grad.numpy()], axis=-1)
        out += [{"loglik": float(ll[j]), "grad": g[j],
                 "theta": (float(l[i + j]), float(sig[i + j]))}
                for j in range(len(ll))]
        del res
    return out


def compare(got: list[dict], want: list[dict]) -> dict:
    """The numbers compared over the checked sets."""
    theta = np.array([w["theta"] for w in want])
    G = np.array([w["grad"] for w in want]) * theta
    D = np.array([g["grad"] for g in got]) * theta - G
    size = np.linalg.norm(G, axis=1)
    nums = {"loglik_abs_err": float(np.max(np.abs(
                np.array([g["loglik"] for g in got])
                - np.array([w["loglik"] for w in want])))),
            "grad_err": float(np.max(np.linalg.norm(D, axis=1)
                                     / np.maximum(size, np.median(size))))}
    return {k: (v if np.isfinite(v) else float("inf"))
            for k, v in nums.items()}
