#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``pymra_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. device: the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions and the matmul precision settings the sweep pins;
2. build: ``nvcc`` builds the CUDA kernels from ``pymra_torch/ops/cuda``;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   every shipped width, escalation cases included, and both timed with
   CUDA events at the main path's shapes;
4. the N=10^4 main path (bundled ``large``, r=4, M=4): objective against
   the float64 golden, posterior finite, ms per evaluation;
5. the N=10^6 flagship (1000^2 grid, r=8, M=7): likelihood-only objective
   against its golden, ms per evaluation with and without the posterior,
   peak device memory;
6. launch counters: phases 4-5 went through both kernels, and no plain twin
   ran on a CUDA tensor.

The last two lines are JSON: the per-kernel record, then
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: float64 objectives of the two bench trees (bench.py GOLDEN_N10K_OBJECTIVE
#: and GOLDEN_N1M_OBJECTIVE) and the relative tolerance of a float32 run
GOLDEN_N10K = 118683.56905857287
GOLDEN_N1M = 27435488.53970907
ANCHOR_RTOL = 2e-3
#: kernel-versus-twin agreement: max|kernel - twin| <= ATOL + RTOL max|twin|
#: per output (two float32 column loops rounding in different places; the
#: CUDA kernel contracts multiply-subtract into FMA, the twin does not)
RTOL, ATOL = 1e-4, 1e-5

CHOL_WIDTHS = (4, 8, 17, 28, 48, 49, 64)
LEAF_WIDTHS = (17, 28, 48, 49, 64)
RAGGED_BATCH = 1000
#: (batch, P) the main path hands each kernel: N=10^4 (r=4, leaves P=49)
#: and N=10^6 (r=8, leaves P=64)
CHOL_MAIN = ((64, 4), (4096, 8))
LEAF_MAIN = ((256, 49), (16384, 64))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call on the card: CUDA events around ``reps``
    calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    from pymra_torch.tree.sweep import set_matmul_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print("== phase 1: device")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    set_matmul_precision()
    print_precision()
    return card


def print_precision():
    import torch

    print(f"precision: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}")


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from pymra_torch.ops.cuda import build

    print("== phase 2: build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"nvcc build + load: {time.perf_counter() - t0:.1f} s "
          f"({' '.join(build.NVCC_FLAGS)})")
    for line in build.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def _rotate(rng, lam):
    """``Q diag(lam) Q^T`` for a random orthogonal Q."""
    q, _ = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))
    return (q * lam) @ q.T


def _spd_batch(rng, b, p):
    a = rng.standard_normal((b, p, p))
    return a @ np.swapaxes(a, -1, -2) / p + np.eye(p)


def chol_case(rng, b, p):
    """Random SPD members plus, when p > 1: one indefinite enough to need
    the 1e2 factor, one with an exactly zero last pivot on the first
    attempt (diag(1, .., 1, -js) + js*I, as tests/test_pallas.py builds
    it) and one that fails every factor (-I)."""
    m = _spd_batch(rng, b, p)
    jit = 1e-6 * (np.abs(np.diagonal(m, axis1=-2, axis2=-1)).mean(-1) + 1)
    if p > 1 and b >= 4:
        m[1] = _rotate(rng, np.r_[np.linspace(1.0, 2.0, p - 1), -0.05])
        jit[1] = 1e-3
        m[2] = np.diag(np.r_[np.ones(p - 1), -1e-4])
        jit[2] = 1e-4
        m[3] = -np.eye(p)
    return m.astype(np.float32), jit.astype(np.float32)


def leaf_case(rng, b, p, escalate: bool):
    """Random SPD C, a 70% knot mask with one fully masked leaf and a
    knot-masked Gram A_oo. With ``escalate`` one member is indefinite enough
    to need the 1e2 factor at jitter 1e-3 (both halves); otherwise one has
    an exactly zero pivot, which at jitter 0 fails every factor."""
    c = _spd_batch(rng, b, p)
    k = (rng.random((b, p)) < 0.7).astype(np.float64)
    a2 = rng.standard_normal((b, p, p))
    a_oo = a2 @ np.swapaxes(a2, -1, -2) * 0.1 / p
    k[0] = 0.0
    if escalate:
        c[1] = _rotate(rng, np.r_[np.linspace(1.0, 2.0, p - 1), -0.05])
    else:
        c[1] = np.diag(np.r_[np.ones(p - 1), 0.0])
    k[1] = 1.0
    a_oo[1] = 0.0
    a_oo = a_oo * k[:, :, None] * k[:, None, :]
    f32 = np.float32
    return c.astype(f32), k.astype(f32), a_oo.astype(f32)


def compare(name, got, want, factor_idx):
    """Max |kernel - twin| per output with the tolerance; NaN patterns and
    the selected factors must be identical. Returns the max error."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i in factor_idx:
            check(torch.equal(g, w), f"{name}: selected factors differ")
            continue
        fin = torch.isfinite(w)
        check(torch.equal(torch.isfinite(g), fin),
              f"{name}: output {i} non-finite pattern differs")
        if fin.any():
            err = float((g[fin] - w[fin]).abs().max())
            tol = ATOL + RTOL * float(w[fin].abs().max())
            check(err <= tol, f"{name}: output {i} max|diff| {err:.3g} > "
                              f"{tol:.3g}")
            worst = max(worst, err)
    return worst


def phase_kernels(device="cuda", ragged=RAGGED_BATCH, chol_main=CHOL_MAIN,
                  leaf_main=LEAF_MAIN, timer=time_ms):
    import torch

    from pymra_torch.ops import linalg as tl

    print("== phase 3: kernels against their plain twins "
          f"(tolerance max|diff| <= {ATOL} + {RTOL} max|twin|)")
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    err = {"cholesky_jittered": 0.0, "leaf_factor": 0.0}
    times = {}

    shapes = [(ragged, p) for p in CHOL_WIDTHS] + list(chol_main)
    for b, p in shapes:
        m, jit = chol_case(rng, b, p)
        mt = torch.as_tensor(m, device=dev)
        jt = torch.as_tensor(jit, device=dev)
        got = tl.cholesky_jittered(mt, jt)
        want = tl.cholesky_jittered_ref(mt, jt)
        e = compare(f"cholesky_jittered {b}x{p}", got, want, factor_idx={2})
        err["cholesky_jittered"] = max(err["cholesky_jittered"], e)
        if p > 1 and b >= 4:
            f = got[2].tolist()
            check(f[1] == 1e2 and f[2] == 1e2 and f[3] == 1e4,
                  f"cholesky_jittered {b}x{p}: escalation factors "
                  f"{f[1:4]}, expected [100, 100, 10000]")
        line = f"cholesky_jittered B={b} P={p}: max|diff| {e:.3g}"
        if (b, p) in chol_main:
            ms = timer(lambda: tl.cholesky_jittered(mt, jt))
            ms_ref = timer(lambda: tl.cholesky_jittered_ref(mt, jt))
            times[("cholesky_jittered", b, p)] = (ms, ms_ref)
            line += f"; kernel {ms:.4f} ms, twin {ms_ref:.4f} ms"
        print(line)

    shapes = [(ragged, p) for p in LEAF_WIDTHS] + list(leaf_main)
    for b, p in shapes:
        for escalate in (True, False):
            jitter = 1e-3 if escalate else 0.0
            c, k, a = (torch.as_tensor(x, device=dev)
                       for x in leaf_case(rng, b, p, escalate))
            got = tl.leaf_factor(c, k, a, jitter)
            want = tl.leaf_factor_ref(c, k, a, jitter)
            e = compare(f"leaf_factor {b}x{p} jitter={jitter}", got, want,
                        factor_idx={3, 4})
            err["leaf_factor"] = max(err["leaf_factor"], e)
            fp, fq = got[3].tolist(), got[4].tolist()
            if escalate:
                check(fp[1] == 1e2 and fq[1] == 1e2,
                      f"leaf_factor {b}x{p}: escalation factors "
                      f"{fp[1]}, {fq[1]}, expected 100")
                # masked leaf: K_leaf = I, jitter scale 2
                want0 = torch.eye(p, device=dev) / (1.0 + 2.0 * jitter) ** 0.5
                check(float((got[0][0] - want0).abs().max()) <= 1e-6,
                      f"leaf_factor {b}x{p}: masked leaf Li is not "
                      "(1 + 2 jitter)^-1/2 I")
            else:
                check(fp[1] == 1e4 and fq[1] == 1e4
                      and not np.isfinite(got[1][1].item()),
                      f"leaf_factor {b}x{p}: exact-zero pivot at jitter 0 "
                      "did not fail through every factor")
            line = (f"leaf_factor B={b} P={p} jitter={jitter}: "
                    f"max|diff| {e:.3g}")
            if escalate and (b, p) in leaf_main:
                ms = timer(lambda: tl.leaf_factor(c, k, a, jitter))
                ms_ref = timer(lambda: tl.leaf_factor_ref(c, k, a, jitter))
                times[("leaf_factor", b, p)] = (ms, ms_ref)
                line += f"; kernel {ms:.4f} ms, twin {ms_ref:.4f} ms"
            print(line)
    return err, times


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def _anchor(tag, objective, golden):
    rel = abs(objective - golden) / abs(golden)
    print(f"{tag} objective {objective!r} golden {golden!r} rel err "
          f"{rel:.3g} (limit {ANCHOR_RTOL})")
    check(rel <= ANCHOR_RTOL, f"{tag} objective off its golden by {rel:.3g}")


def _sweep_timer(evaluate, thetas, timer):
    """ms per evaluation over ``thetas`` (one warm-up first)."""
    it = iter(thetas)
    return timer(lambda: evaluate(float(next(it))), reps=len(thetas) - 1)


def phase_n10k(device="cuda", timer=time_ms, n_evals=20):
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs

    print("== phase 4: N=10^4 main path (bundled large, r=4, M=4)")
    locs, y_obs = load_data("large")
    t0 = time.perf_counter()
    model = MRAModel(locs, r=4, M=4, dtype=torch.float32,
                     config=PlanConfig(r=4, kmeans_impl="native"),
                     device=device)
    print(f"plan + upload {time.perf_counter() - t0:.2f} s; "
          f"{model.describe().splitlines()[-2].strip()}")
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    dplan, jitter = model.dplan, model.jitter
    prep = prepare_obs(dplan, y, 1e-4)

    def evaluate(l):
        return mra_sweep(dplan, Kernel("exponential", l=l), y, 1e-4,
                         compute_posterior=True, jitter=jitter, prep=prep)

    res = evaluate(2.0)
    _anchor("N=10^4", float(res.objective), GOLDEN_N10K)
    for name, v in (("mean", res.mean), ("var", res.var)):
        check(tuple(v.shape) == (10000,) and bool(torch.isfinite(v).all()),
              f"N=10^4 posterior {name} not finite of shape [10000]")
    check(bool((res.var > 0).all()), "N=10^4 posterior var not positive")
    ms = _sweep_timer(evaluate, np.linspace(1.5, 2.5, n_evals + 1),
                      timer)
    print(f"N=10^4 full likelihood+posterior: {ms:.3f} ms/eval "
          f"({n_evals} evals, exponential l in [1.5, 2.5])")
    return ms


def phase_n1m(device="cuda", timer=time_ms, side=1000, golden=GOLDEN_N1M,
              n_evals=8):
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig
    from pymra_torch.tree.plan import tpu_shaped_M
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs
    from pymra_torch.utils import gen_locations_2d

    print(f"== phase 5: N={side * side} flagship (grid, r=8, "
          "leaves ~64)")
    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y_np = rng.standard_normal(len(locs)).astype(np.float32)
    y_np[rng.random(len(locs)) > 0.9] = np.nan
    M = tpu_shaped_M(len(locs), 8)
    t0 = time.perf_counter()
    model = MRAModel(locs, r=8, M=M, dtype=torch.float32,
                     config=PlanConfig(r=8, kmeans_impl="native"),
                     device=device)
    print(f"M={M}; plan + upload {time.perf_counter() - t0:.2f} s")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    y = torch.as_tensor(y_np, device=device)
    dplan, jitter = model.dplan, model.jitter
    prep = prepare_obs(dplan, y, 1e-2)

    def evaluate(l, post=False):
        return mra_sweep(dplan, Kernel("exponential", l=l), y, 1e-2,
                         compute_posterior=post, jitter=jitter, prep=prep)

    _anchor(f"N={len(locs)}", float(evaluate(0.05).objective), golden)
    full = evaluate(0.05, post=True)
    for name, v in (("mean", full.mean), ("var", full.var)):
        check(bool(torch.isfinite(v).all()),
              f"N={len(locs)} posterior {name} not finite")
    thetas = np.linspace(0.04, 0.06, n_evals + 1)
    ms_lik = _sweep_timer(evaluate, thetas, timer)
    ms_full = _sweep_timer(lambda l: evaluate(l, post=True), thetas,
                           timer)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else float("nan"))
    print(f"N={len(locs)} likelihood-only: {ms_lik:.3f} ms/eval; full "
          f"likelihood+posterior: {ms_full:.3f} ms/eval ({n_evals} evals, "
          f"l in [0.04, 0.06]); peak device memory {peak:.2f} GiB")
    return ms_lik, ms_full, peak


# ---------------------------------------------------------------------------

def reset_counters(tl):
    tl.cholesky_jittered.launches = 0
    tl.leaf_factor.launches = 0
    tl.cholesky_jittered_ref.cuda_calls = 0
    tl.leaf_factor_ref.cuda_calls = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from pymra_torch.ops import linalg as tl

    phase_device()
    phase_build()
    err, times = phase_kernels()

    reset_counters(tl)
    phase_n10k()
    phase_n1m()
    print("== phase 6: launch counters over phases 4-5")
    launches = {"cholesky_jittered": tl.cholesky_jittered.launches,
                "leaf_factor": tl.leaf_factor.launches}
    twins = {"cholesky_jittered_ref": tl.cholesky_jittered_ref.cuda_calls,
             "leaf_factor_ref": tl.leaf_factor_ref.cuda_calls}
    print(f"kernel launches {launches}; twin calls on CUDA tensors {twins}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    check(all(v == 0 for v in twins.values()),
          "a plain twin ran on a CUDA tensor in the main path")
    print_precision()

    src = "pymra_torch/ops/cuda/csrc/"
    rec = []
    for name, replaces, (b, p) in (
            ("cholesky_jittered", "pymra_tpu/ops/pallas/linalg.py:123",
             CHOL_MAIN[-1]),
            ("leaf_factor", "pymra_tpu/ops/pallas/linalg.py:255,309",
             LEAF_MAIN[-1])):
        ms, ms_ref = times[(name, b, p)]
        rec.append({"name": name, "route": "cuda",
                    "source": f"{src}{name}.cu", "replaces": replaces,
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": ms_ref,
                    "shape": f"{b}x{p}x{p}"})
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
