"""float32 roughness of the N=10^4 loglik near its MLE, on the CPU: the
port's float32 path beside the JAX package's.

The samplers' Hamiltonian errors include the float32 loglik's noise. This
fits the MLE of the exponential kernel's ``l`` and ``sig`` in float64 with
the port (bundled ``large``, r=4, M=4, L-BFGS from l=2, sig=1), takes the
conditional posterior sd of log l there and the roughness at 21 points
across +-3 such sds of log l with ``chip_smoke.conditional_sd`` and
``chip_smoke.roughness`` (the definitions phase 13 reports on the card),
and prints the roughness of four loglik functions at the same points,
and the mean and sd of each one's difference from the port's float64
there:

* the port in float64 (jitter 0) and in float32 (the kernels' plain
  twins, jitter 1e-6);
* the JAX package in float32 (jitter 1e-6; on the CPU it takes its XLA
  path, the Pallas kernels run only on a TPU) and in float64.

::

    python tools/float32_roughness.py --R 1e-4 1e-2

Takes a few minutes per R on a few CPU cores.
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pymra_torch import Kernel, MRAModel, PlanConfig, fit_mle, load_data  # noqa: E402
from pymra_tpu.kernels import Kernel as JaxKernel  # noqa: E402
from pymra_tpu.tree.model import MRAModel as JaxModel  # noqa: E402
from pymra_tpu.tree.plan import PlanConfig as JaxPlanConfig  # noqa: E402


def jax_loglik(model, y, R, dtype):
    """The JAX package's ``loglik_fn`` as ``chip_smoke.roughness`` calls
    it: a dict of float64 torch scalars in, a float64 torch scalar out.
    The parameters enter in ``dtype``, the model's: a float64 parameter
    would promote a float32 model's whole sweep to float64."""
    fn = jax.jit(model.loglik_fn(y, R, kernel_builder=lambda th: JaxKernel(
        "exponential", l=th["l"], sig=th["sig"])))

    def f(theta):
        value = fn({k: jnp.asarray(float(v), dtype=dtype)
                    for k, v in theta.items()})
        assert value.dtype == dtype, value.dtype
        return torch.tensor(float(value), dtype=torch.float64)

    return f


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--R", type=float, nargs="+", default=[1e-4, 1e-2])
    ap.add_argument("--steps", type=int, default=15,
                    help="L-BFGS steps of the float64 MLE")
    args = ap.parse_args()
    locs, y = load_data("large")
    dtypes = {"float64": (torch.float64, jnp.float64),
              "float32": (torch.float32, jnp.float32)}
    ports = {name: MRAModel(locs, r=4, M=4, dtype=tdt, device="cpu",
                            config=PlanConfig(r=4, kmeans_impl="native"))
             for name, (tdt, _) in dtypes.items()}
    jaxes = {name: JaxModel(locs, r=4, M=4, dtype=jdt,
                            config=JaxPlanConfig(r=4, kmeans_impl="native"))
             for name, (_, jdt) in dtypes.items()}
    for R in args.R:
        fs = {}
        for name, (tdt, jdt) in dtypes.items():
            fs[f"port {name}"] = ports[name].loglik_fn(
                torch.as_tensor(y, dtype=tdt), R,
                kernel_builder=chip_smoke.exponential_builder)
            fs[f"JAX {name}"] = jax_loglik(
                jaxes[name], np.asarray(y, dtype=jdt), R, jdt)
        f64 = fs["port float64"]
        fit = fit_mle(f64, {"l": 2.0, "sig": 1.0}, method="lbfgs",
                      steps=args.steps)
        mle = fit["theta"]
        sd = chip_smoke.conditional_sd(f64, mle)
        print(f"R={R}: port float64 MLE {mle} loglik {fit['loglik']!r}; "
              f"conditional sd of log l {sd:.6g}")
        ts = np.linspace(-chip_smoke.ROUGH_SDS, chip_smoke.ROUGH_SDS,
                         chip_smoke.ROUGH_POINTS) * sd
        points = [{"l": torch.tensor(mle["l"] * np.exp(t), dtype=torch.float64),
                   "sig": torch.tensor(mle["sig"], dtype=torch.float64)}
                  for t in ts]
        with torch.no_grad():
            ref = np.array([float(f64(p)) for p in points])
        for name, f in fs.items():
            try:
                chip_smoke.roughness(f"R={R} {name}", f, mle, sd)
            except SystemExit as e:
                print(f"R={R} {name}: {e}")
            with torch.no_grad():
                diff = np.array([float(f(p)) for p in points]) - ref
            print(f"R={R} {name} minus port float64 at the same points: "
                  f"mean {diff.mean():.6g}, sd {diff.std(ddof=1):.6g}")


if __name__ == "__main__":
    main()
