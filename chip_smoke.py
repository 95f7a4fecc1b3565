#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``pymra_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. device: the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions and the matmul precision settings the sweep pins;
2. build: one ``nvcc`` per kernel source of ``pymra_torch/ops/cuda``, all
   at once;
3. kernels: each of the nine forward CUDA kernels (the wide one,
   ``chol_wide.cu``, as K8 ``cholesky_blocked`` and as KC
   ``cholesky_cascade``; K3 ``triangular_inverse_lower`` as ``tri_inv.cu``
   up to 64 and ``tri_inv_wide.cu`` above) against its plain PyTorch twin
   on the card at every shipped width (K2 at every width of its sub-warp
   kernel too, K5 with one right-hand side and with P of them, in both
   directions), escalation and NaN cases included, and kernel,
   twin and one PyTorch library call (a yardstick the port never calls)
   timed at the paths' shapes, per call (CUDA events) and on the device
   alone (``torch.profiler``), beside the roofline bound of the same work
   and the share of it each time reaches (K8, KC and the wide K3 also
   beside the compositions they replaced; KC and the wide K3 once under
   ``torch.cuda.set_sync_debug_mode("error")``: no host synchronization);
   the jittered kernels K2, K6, K7 and KC are also timed, against their
   twins and library calls, on a clean batch where no member escalates
   (one attempt of the library call is then the whole function);
3b. backward: the fused ``cholesky_pullback`` against its twin on the
   same tensors, member by member with identical NaN patterns, its lane
   kernel (P <= 8, record ``cholesky_pullback``) timed as in phase 3 at
   every interior level's shape of the main paths and its pullback mode
   (9 <= P <= 64, record ``cholesky_pullback_tile``) at K2's side shapes
   (``CHOL_SIDE``: the triangular route's gradient); the autograd
   Functions of ``cholesky_jittered`` (its backward also timed as the sweep
   calls it), ``leaf_factor``, ``cholesky_logdet``, ``cholesky_inv_logdet``,
   ``cholesky_cascade`` and ``cholesky_blocked`` on the card against the
   same Functions on CPU copies (the twins), at the paths' shapes with
   random cotangents;
3c. K1's backward: ``leaf_pullback`` (one launch of
   ``leaf_pullback.cu``) against its twin ``leaf_pullback_ref`` on the
   card (the composition the backward ran before the kernel: float64 and
   float32 GEMMs, elementwise kernels, K4 and K3), member by member with
   identical NaN patterns, at ``LEAF_PULLBACK_MAIN`` (grid1m.grad4's
   65,536 leaves of 64, one set's 16,384 and the N=10^4 tree's 256 of 49)
   on K1's forward of ``leaf_case``'s members (masked slots, a fully
   masked leaf, factors 1e2 and 1e4, an all-fail member) with random
   cotangents; kernel and twin timed as in phase 3, the twin's device
   time too, beside the bound;
3d. the general-nu Matern kernel (``matern_cuda``: ``matern.cu``'s
   covariance and pullback) at the grid1m tree's leaf shape under 4 sets
   (4 x 16384 leaves x 64 locations x 120 columns: 56 ancestor knots and
   the leaf's own 64) on points laid out as that tree's: against its float32
   twin ``matern_general`` (chip_smoke's tolerance, NaN patterns
   identical), against the float64 twin on a slice of the leaves, the
   pullback against the float64 twin's autograd on a smaller slice; one
   launch each way a call, ms and device ms of each beside its bound
   (``matern_work``), the twin's device time and launches;
4. the N=10^4 main path (bundled ``large``, r=4, M=4): objective against
   the float64 golden, posterior finite, ms per evaluation;
5. the N=10^6 flagship (1000^2 grid, r=8, M=7): likelihood-only objective
   against its golden, ms per evaluation with and without the posterior,
   peak device memory;
6. launch counters: phases 4-5 went through K1 and K2, and no plain twin
   ran on a CUDA tensor;
7. the gradient path at N=10^4: ``MRAModel.loglik_fn`` value and gradient
   in ``l`` and ``sig`` against the float64 golden gradient, ms per
   value-and-gradient evaluation;
8. the gradient path at N=10^6: value and gradient finite and held to a
   five-point difference of the card's own float32 loglik, ms per
   value-and-gradient evaluation, its ratio to the forward, peak memory
   with autograd, then a 3-step L-BFGS ``fit_mle``;
9. launch counters over phases 7-8: K1, its backward, K2 and the
   pullback launched, no twin ran on a CUDA tensor;
9b. phase 13c's four N=10^6 parameter sets through one batched value and
   gradient on phase 5's plan and data, with K1's backward the kernel and
   then the twin (the backward before the kernel): loglik equal (1e-5),
   gradient within phase 13c's 1e-4 of the twin's; ms per evaluation and
   peak memory of both, in alternating turns;
10. dense measurement error at N=10^4 (bundled ``large``, r=4, M=4):
   (a) R = 1e-4 I passed as a dense matrix against the float64 golden and
   the diagonal path's own objective; (b) a correlated R against a frozen
   float64 objective and gradient, ms per full and per value-and-gradient
   evaluation, peak memory;
10b. phase 10's correlated R with 4 parameter sets through one sweep:
   each set's loglik and gradient against the set alone (1e-5 / 1e-4),
   the golden's set against the frozen golden, launches per batched value
   and gradient equal to one single evaluation's (R's blocks factored by
   K2 and y whitened by K5 once for all sets), the batched posterior's
   shape, ms, peak memory;
11. leaves wider than 64: the N=10^4 tree at M=3 (64 leaves of 169)
   against its frozen float64 objective and gradient, and the N=10^6 grid
   at M=6 (4096 leaves of 256): ms per evaluation with and without the
   posterior, peak memory, value and gradient against a five-point
   difference;
12. launch counters over phases 10-11: K2-K7, the wide kernel (through
   KC), the wide K3 and the pullback launched, no K8, KC or K3 call
   composed at P <= 256, no twin ran on a CUDA tensor;
13. the samplers at N=10^4 (phase 7's tree at R=1e-2, theta = log l and
   log sig under weak normal priors): a short L-BFGS ``fit_mle`` for the
   start, then NUTS, HMC, ADVI and SMC through ``MRAModel.loglik_fn``.
   Draws finite, ``check_samples`` healthy, NUTS's acceptance in range,
   each chain's last draw held to a fresh evaluation (value and gradient),
   ADVI's ELBO and SMC's evidence finite; ms and evaluations per draw,
   R-hat, ESS, and the float32 roughness of the loglik near the MLE at
   R=1e-2 and at phase 7's R=1e-4;
13b. a short NUTS at N=10^6 on phase 5's tree and data, from phase 8's
   fit (run before phase 5's plan is freed): finite draws and log_prob,
   ms per draw, acceptance, divergences and the roughness;
13c. parameter sets batched through one sweep: ``MRAModel.loglik_fn(...,
   batched=True)`` at 4 sets on phase 4's N=10^4 tree and phase 5's N=10^6
   plan and data (R=1e-2): loglik and gradient against each set evaluated
   alone on the card (phase 20's limits: 1e-5 and 1e-4),
   kernel launches per batched evaluation equal to one single
   evaluation's, ms per batched and per single evaluation, peak memory;
13d. phase 13's samplers batched on its model, from its starts, run
   lengths and generator seed: NUTS and HMC chains in lockstep, ADVI's
   draws and SMC's particles in one evaluation; phase 13's checks (NUTS's
   acceptance range, ``check_samples``, each chain's last draw against its
   batch evaluated again); ms per draw beside phase 13's, evaluations per
   transition (batched calls: the most among the chains; points: the mean
   over them), agreement with phase 13's draws;
13e. phase 13b's NUTS with 4 chains in lockstep on phase 5's N=10^6 plan
   and data: finite draws, the last draws against their batch, ms per draw
   beside 13b's, evaluations per transition, peak memory;
13f. the posterior of 4 parameter sets through one sweep
   (``MRAModel.sweep`` with a batched ``Kernel``) on phase 4's tree
   (R=1e-4, sets around l=2) and phase 5's plan and data (l in {0.04,
   0.05, 0.0625, 0.08}): the golden's set against the golden, each set's
   objective against the set alone on the card (1e-5), its mean and var
   within phase 20's limits of the set alone's, launches per batched
   evaluation equal to one single evaluation's, ms per batched and per
   single evaluation, device time (busy share) and peak memory;
14. launch counters over phases 13-13f: K1-K4 and the pullback launched,
   no twin ran on a CUDA tensor;
15. a dense covariance matrix at N=10^4: ``MRATree`` with the exponential
   (l=2) as an ``[N, N]`` float32 matrix on the card (index-mode plan,
   ``MatrixKernel``) against the float64 golden and the coordinate path's
   objective, ``setPrior(2 Sigma)`` against a tree built with 2 Sigma
   (and, reported, the kernel at sig=2), ms per evaluation beside phase
   4's, peak memory;
16. general-nu Matern (nu=0.8; on the card the kernel of phase 3d) at
   N=10^4: objective and gradient in (l, sig) against frozen float64
   goldens at R=1e-2 (R=1e-4 reported), ms per forward and per
   value-and-gradient evaluation beside the exponential's, device
   launches per covariance call and per sweep beside the exponential's,
   the kernel's launches counted and the twins never on a CUDA tensor;
17. ``keep_internals`` at N=10^4 (K2 and K3 at the leaves): objective
   against the golden, posterior against the default sweep's; the
   posterior basis matrix's row sums of squares against the sweep's
   variance; ``getB_lk`` against the sweep's ancestor basis block;
   ``drawBasisFunctions`` to ``chiprun_out/`` (without matplotlib: the
   arrays it draws); 17b: two parameter sets through one
   ``keep_internals`` sweep, every stash with the ``[C]`` axis in front,
   objective and posterior of each set against its single sweep at phase
   17's limits, launches equal, the host basis matrix refusing the batch;
18. the triangular leaf route (``PYMRA_LEAF_SOLVE=tri``: K6, K2, K5) at
   N=10^4: objective and gradient against the goldens, ms on both routes,
   the float32 roughness of both routes at phase 13's points (R=1e-2 and
   1e-4); 18b, run after phase 14 on phase 5's plan before it is freed:
   the N=10^6 objective against its golden and likelihood-only ms on both
   routes; its value and gradient held to a five-point difference of the
   card's own loglik (phase 8's check), KP's pullback mode (K2's backward
   at the 16384 leaves of 64) launched once in it, peak memory with
   autograd and ms per value-and-gradient evaluation on both routes in
   alternating pairs; its own launch counters (K2, K5, K6, KP at the
   interior levels and in its pullback mode);
19. launch counters over phases 15-18: K1, K2, K3, K5 and K6 launched, no
   twin ran on a CUDA tensor; phase 18's own launches reported beside;
20. the sharded main path at N=10^6 on phase 5's tree and data: the plan
   written by ``utils.checkpoint.save_plan``; first the sharded sweep on a
   world of one rank in this process, bit-identical to phase 5; then 2
   ranks (spawned processes, ``torch.distributed`` over gloo with a file
   store: NCCL refuses two ranks on one card) each load and pad the plan
   (``int_shard_from`` 2: levels 2-6 and the leaves shard) and run full
   sweeps with the posterior and value-and-gradient evaluations in
   ``l`` and ``sig``: the ranks agree bit for bit, the objective against
   the golden and phase 5's, the posterior against phase 5's, the
   gradient against phase 8's; ms per evaluation, peak memory, launches
   of every kernel per rank (each rank counts its own), the forward
   collectives' host time beside ``utils.accounting.sweep_cost``'s bytes;
20b. HMC on a 2 x 2 chain x data mesh of 4 ranks at N=10^4 (phase 13's
   tree and R, from phase 13's fit): data partners draw bit-identical
   chains, the gathered draws are finite and healthy, each chain's last
   log_prob matches a serial evaluation. A rank that fails or hangs fails
   the phase: the ranks are joined by a deadline and killed past it;
20c. the sharded batch: phase 13c's first 2 N=10^6 sets through one
   sharded sweep on phase 20's 2 ranks (posterior, and
   ``sharded_loglik_fn(..., batched=True)``'s value and gradient): ranks
   bit-identical, each set's loglik and gradient against 13c's serial
   batch (1e-5 / 1e-4), the posterior against the serial batched sweep's
   (phase 20's limits); then phase 20b's mesh with 2 chains a chain rank
   in lockstep (one batched sharded evaluation of both a step): 20b's
   checks, batched calls per transition beside 20b's.

Phases 13-14 (13c-13f included), 18b, 20, 20b and 20c run after phase 9,
before phase 10; phases
15-19 after phase 12. Times of phases 20-20b come from ranks that share
one card: they are not a scaling figure. Phase 3 also times K2, K5 and K6 at the side paths'
shapes (``CHOL_SIDE``, ``SOLVE_SIDE``, ``LOGDET_SIDE``).

The last two lines are JSON: the per-kernel record, then
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: float64 objectives of the two bench trees (bench.py GOLDEN_N10K_OBJECTIVE
#: and GOLDEN_N1M_OBJECTIVE) and the relative tolerance of a float32 run
GOLDEN_N10K = 118683.56905857287
GOLDEN_N1M = 27435488.53970907
ANCHOR_RTOL = 2e-3
#: float64 golden gradient of the N=10^4 tree at l=2, sig=1 (the JAX
#: package, jitter 0: ``tools/golden_gradient_n10k.py``, whose objective
#: reproduces GOLDEN_N10K to 2.5e-12)
GOLDEN_GRAD_N10K = {"l": -37296.18276094866, "sig": 74598.06509430968}
#: relative tolerance of each float32 partial against it: the float32
#: path's jitter (1e-6) alone moves both by 5.6e-4 (the port in float64
#: with that jitter), and float32 rounding, mostly in the leaf stage, by up
#: to 6.5e-4 more on the CPU twins (1.2e-3 in all for sig); the bench's
#: objective anchor uses the same 2e-3
GRAD_RTOL = 2e-3
#: N=10^6 gradient check: a five-point difference of the float32 loglik in
#: log-parameter with step 0.1; on the CPU twins it lies within 2.4e-4 of
#: the gradient at N=128^2 and 1e-4 at N=256^2, while dropping the leaf
#: backward moves the gradient by a factor of 40 or more
FD_STEP, FD_RTOL = 0.1, 2e-3
#: the correlated measurement error of phase 10: R_ij = scale
#: exp(-|s_i - s_j| / rho), rho one grid spacing of bundled ``large``
DENSE_R_SCALE, DENSE_R_RHO = 1e-4, 1.0 / 99.0
#: float64 objective and gradient (l=2, sig=1) of the N=10^4 tree under
#: that R, from the JAX package with jitter 0
#: (``tools/golden_dense_r_n10k.py``)
GOLDEN_DENSE_R_N10K = {"objective": 119999.24034216302,
                       "l": -37953.354942693455, "sig": 75912.41807796384}
#: the same for the N=10^4 data cut at M=3 (64 leaves of 169) with R=1e-2
#: (``tools/golden_wide_leaves_n10k.py``; at R=1e-4 those leaves' float32
#: posterior blocks fail every jitter factor, in the JAX package too)
GOLDEN_WIDE_N10K = {"objective": 26656.746190704536,
                    "l": -6463.406800508911, "sig": 12930.823023250949}
#: phase 13f: the posterior of C=4 sets through one sweep, on phase 4's
#: tree at its R and on phase 5's plan and data at theirs; the first
#: N=10^4 set and the second N=10^6 set are the goldens' parameters
POST_BATCH_N10K = {"l": (2.0, 1.6, 2.5, 3.2), "sig": (1.0, 1.2, 0.8, 1.1)}
POST_BATCH_N1M = {"l": (0.04, 0.05, 0.0625, 0.08), "sig": (1.0,) * 4}
#: at R = 1e-4 (phase 13f at N=10^4, phase 10b) a batch's float32 result
#: is held, like each set alone, to the set's float64 result (the
#: goldens' arithmetic, on the host in the same run): objective and
#: gradient within ANCHOR_RTOL and GRAD_RTOL, the posterior mean and var
#: within these times the set's largest magnitude. Against each other the
#: two float32 evaluations differ by more than the R=1e-2 limits: the
#: card's products round differently at C·n members than at n, and R=1e-4
#: amplifies it. On an NVIDIA H100 (700 W; tools/batch_rounding.py) the
#: batch moved the objective by up to 6.9e-4 from the set alone, the
#: posterior mean and var by 3.2e-2 and 1.9e-2 of their scale, the dense-R
#: loglik and gradient by 2.3e-4 and 6.9e-4, while either lay as close to
#: float64 as the other: objective 2.2e-4 / 4.7e-4 at most, mean 1.7e-2 /
#: 1.4e-2, var 1.8e-2 / 1.6e-2; a set alone is repeatable bit for bit, C
#: copies of one set agree with each other bit for bit, no member escalated
F64_POST_RTOL = {"mean": 5e-2, "var": 5e-2}
WIDE_R = 1e-2
#: kernel-versus-twin agreement: max|kernel - twin| <= ATOL + RTOL max|twin|
#: per output (two float32 column loops rounding in different places; the
#: CUDA kernel contracts multiply-subtract into FMA, the twin does not).
#: The backward checks use it too, each member held to its own scale: an
#: escalated member's jitter gradient is 1e4 times a healthy member's
RTOL, ATOL = 1e-4, 1e-5
#: the card's roofline (H100 SXM at 700 W): HBM bytes/s, float32 FLOP/s
#: outside the tensor cores and float64 FLOP/s on the FP64 tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 67e12

#: widths of K2, K3, K4 and K5: the interior blocks, the edges of the
#: register-tiled core's width tiers (16, 32, 48, 64) and the leaf widths
CHOL_WIDTHS = (4, 8, 16, 17, 28, 32, 33, 48, 49, 64)
#: K2 also at every width of its sub-warp kernel (a group of 4 or 8 lanes a
#: member up to P = 8) and the first width of the core
SUBWARP_WIDTHS = tuple(sorted(set(CHOL_WIDTHS) | {1, 2, 3, 5, 6, 7, 9}))
LEAF_WIDTHS = (17, 28, 48, 49, 64)
RAGGED_BATCH = 1000
#: (batch, P) the main path hands each kernel: N=10^4 (r=4, leaves P=49)
#: and N=10^6 (r=8, leaves P=64)
CHOL_MAIN = ((64, 4), (4096, 8))
LEAF_MAIN = ((256, 49), (16384, 64))
#: K1's backward (phase 3c): grid1m.grad4's leaves (4 parameter sets of
#: the N=10^6 tree's 16,384 leaves of 64; the first shape repeats the
#: second's leaves LEAF_PULLBACK_SETS times), one set's, the N=10^4 tree's
LEAF_PULLBACK_MAIN = ((65536, 64), (16384, 64), (256, 49))
LEAF_PULLBACK_SETS = 4
#: (batch, P) of K3 and K4 in the leaf backward (the leaf shapes)
TRI_MAIN = LEAF_MAIN
#: (batch, P, Q, transpose) K5 is timed at: the dense-R path's one call
#: (phase 10's ``yw = L_R^-1 y0`` at the N=10^4 leaves, forward; the
#: basis whitening, Q = 65, is wider than the sweep sends to K5), last, and
#: the shape of the pullback's solves before KP fused them (4096 x 8 x 8,
#: transposed), which keeps the earlier records comparable
SOLVE_MAIN = ((4096, 8, 8, True), (256, 49, 1, False))
#: (batch, P) of the fused Cholesky pullback on the main paths: K2's
#: backward at every interior level, 4^m blocks of r x r (N=10^6: r=8, m =
#: 0..6; N=10^4: r=4, m = 0..3)
PULLBACK_MAIN = (tuple((4 ** m, 8) for m in range(7))
                 + tuple((4 ** m, 4) for m in range(4)))
#: the pullback's checks: the main-path shapes, widths of both lane
#: layouts, the first width of the shared-memory kernel and a dense-R
#: block width
PULLBACK_SHAPES = PULLBACK_MAIN + tuple((RAGGED_BATCH, p)
                                        for p in (1, 3, 5, 9, 49))
#: device time of the pullback over this many launches a profile: a launch
#: at 64 x 4 lasts a few microseconds
PULLBACK_DEVICE_REPS = 100
#: (batch, P) of K6 and K7 on the dense-R path (N=10^4, leaves P=49), and
#: their widths: K2's and the edges of the core's width tiers
LOGDET_MAIN = ((256, 49),)
LOGDET_WIDTHS = tuple(sorted(set(CHOL_WIDTHS) | {1, 16, 32, 33}))
#: widths of K8, KC (the wide kernel takes 64 < P <= 256) and the wide K3,
#: and their paths' shapes: the N=10^4 tree at M=3 (P=169) and the N=10^6
#: grid at M=6 (P=256)
WIDE_WIDTHS = (65, 96, 128, 169, 192, 256)
WIDE_MAIN = ((64, 169), (4096, 256))
#: shapes the side paths of phases 17-18 hand the kernels, timed in phase 3
#: too: K2 (batch, P) at the N=10^4 leaves (keep_internals' prior and
#: posterior factors, the triangular route's posterior factor) and the
#: N=10^6 leaves (the triangular route); K5 (batch, P, Q, transpose) at
#: the triangular route's leaf solves of the head block (Q = S = 16) and
#: of the posterior's half (Q = P) at N=10^4, and of v (Q = 1) at N=10^6
#: (256 x 49 x 1 is SOLVE_MAIN's); K6 at the N=10^6 triangular route's
#: prior log-determinant
CHOL_SIDE = ((256, 49), (16384, 64))
SOLVE_SIDE = ((256, 49, 16, False), (256, 49, 49, False),
              (16384, 64, 1, False))
LOGDET_SIDE = ((16384, 64),)


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


def _spin():
    """A few spin kernels, synchronized: the profiler can miss the first
    or last device activities of a profile (one or two of ten one-launch
    calls went missing on an H100), so the timed calls sit between these,
    which are not counted."""
    import torch

    for _ in range(3):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


#: the kernels the wrappers launch, by the names of their ``__global__``
#: functions in ``pymra_torch/ops/cuda/csrc``
KERNEL_SYMBOLS = ("leaf_factor_kernel", "leaf_pullback_kernel",
                  "chol_jittered_", "cholesky_kernel",
                  "tri_inv_kernel", "tri_inv_wide_kernel", "tri_solve_kernel",
                  "chol_pullback_", "chol_logdet_kernel",
                  "chol_inv_logdet_kernel", "chol_wide_kernel",
                  "matern_kernel", "matern_pullback_kernel")
#: a kernel record whose wrapper launches two kernels: (wrapper, the
#: counter of its launches of this one); every other record is named by
#: its wrapper, whose ``.launches`` counts its kernel's launches (K8's and
#: KC's their launches of the wide kernel)
COUNTERS = {"triangular_inverse_lower_wide": ("triangular_inverse_lower",
                                              "wide_launches"),
            "cholesky_pullback_tile": ("cholesky_pullback", "tile_launches")}


def wrapper_of(name: str) -> tuple[str, str]:
    """(wrapper, counter attribute) of a kernel record."""
    return COUNTERS.get(name, (name, "launches"))


def launches_of(tl, name: str) -> int:
    """The launches counted so far of a kernel record's kernel (0 where
    the wrapper has no such counter: an older tree timed by a newer
    tool)."""
    wrapper, attr = wrapper_of(name)
    return getattr(getattr(tl, wrapper), attr, 0)


def _wrapper_launches() -> int:
    from pymra_torch.ops import linalg as tl
    from pymra_torch.ops import special

    return (sum(launches_of(tl, n) for n in KERNEL_NAMES)
            + _matern_launches(special))


def _matern_launches(special) -> int:
    """The general-nu Matern kernel's launches, forward and pullback (0 on
    an older tree, which has no such kernel)."""
    fn = getattr(special, "matern_cuda", None)
    return (getattr(fn, "launches", 0)
            + getattr(fn, "pullback_launches", 0)) if fn else 0


def device_ms(fn, reps: int = 10,
              tries: int = 3) -> tuple[float | None, float]:
    """Device time per call without the host's share: the summed durations
    of the device activities (kernels, copies, fills) ``torch.profiler``
    records over ``reps`` calls after one warm-up, and how many there were
    per call. The profiler can miss activities (on an H100 it recorded
    half of one kernel's launches in some sessions, and 95 of 100
    one-launch calls of the Cholesky pullback), so a profile that recorded
    fewer of the port's kernels than its wrappers launched is taken again,
    ``tries`` times in all. Where every profile missed some, but the last
    recorded nothing but the port's kernels and at least 90% of their
    launches, a call is the mean of the launches it recorded times the
    launches a call (its launches per call then read the wrappers'
    count); else, or when it recorded no device activity, the time is not
    measured: ``None``. Library kernels have no such count to check
    against."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    count = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _spin()
            before = _wrapper_launches()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            launched = _wrapper_launches() - before
            _spin()
        us = count = own = 0
        for evt in prof.key_averages():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in evt.key):
                us += getattr(evt, "self_device_time_total", 0.0)
                count += evt.count
                if any(k in evt.key for k in KERNEL_SYMBOLS):
                    own += evt.count
        if count and own == launched:
            return us / 1e3 / reps, count / reps
    if own and own == count and own >= 0.9 * launched:
        return us / own / 1e3 * launched / reps, launched / reps
    return None, count / reps


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    from pymra_torch.ops.linalg import set_matmul_precision

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
    print(f"nvcc build + load, one nvcc per source in parallel: "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(build.NVCC_FLAGS)})")
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
    # wider than one kernel block the batch is made in float32: the
    # N=10^6 shape 4096 x 256 x 256 is 2 GB in float64
    dt = np.float32 if p > 64 else np.float64
    a = rng.standard_normal((b, p, p), dtype=dt)
    return a @ np.swapaxes(a, -1, -2) / dt(p) + np.eye(p, dtype=dt)


def _jitter(m):
    """The test batches' jitter rule: 1e-6 (mean|diag| + 1) a member."""
    return 1e-6 * (np.abs(np.diagonal(m, axis1=-2, axis2=-1)).mean(-1) + 1)


def clean_case(rng, b, p):
    """Random SPD members with ``chol_case``'s jitter rule: no member
    escalates, so a jittered kernel's one attempt is its whole function,
    as one attempt of its library call is."""
    m = _spd_batch(rng, b, p)
    return m.astype(np.float32), _jitter(m).astype(np.float32)


def wide_case(rng, b, p):
    """``chol_case`` and, when b >= 6: member 4 needs the 1e4 factor (an
    eigenvalue of -1 at jitter 1e-3) and member 5 carries a NaN in its lower
    triangle (row 100 or the last, column 3: in the first block column's
    panel when P > 100), so it fails every factor."""
    m, jit = chol_case(rng, b, p)
    if b >= 6:
        m[4] = _rotate(rng, np.r_[np.linspace(1.0, 2.0, p - 1), -1.0])
        jit[4] = 1e-3
        m[5, min(100, p - 1), 3] = np.nan
    return m, jit


def chol_case(rng, b, p):
    """Random SPD members plus, when p > 1: one indefinite enough to need
    the 1e2 factor, one with an exactly zero last pivot on the first
    attempt (diag(1, .., 1, -js) + js*I, as tests/test_pallas.py builds
    it) and one that fails every factor (-I)."""
    m = _spd_batch(rng, b, p)
    jit = _jitter(m)
    if p > 1 and b >= 4:
        m[1] = _rotate(rng, np.r_[np.linspace(1.0, 2.0, p - 1), -0.05])
        jit[1] = 1e-3
        m[2] = np.diag(np.r_[np.ones(p - 1), -1e-4])
        jit[2] = 1e-4
        m[3] = -np.eye(p)
    return m.astype(np.float32), jit.astype(np.float32)


def leaf_case(rng, b, p, escalate: bool, hard: bool = False):
    """Random SPD C, a 70% knot mask with one fully masked leaf (member 0)
    and a knot-masked Gram A_oo. With ``escalate`` member 1 is indefinite
    enough to need the 1e2 factor at jitter 1e-3 (both halves); otherwise
    it has an exactly zero pivot, which at jitter 0 fails every factor.
    With ``hard`` too (and b >= 4), member 2 needs the 1e4 factor (an
    eigenvalue of -1) and member 3 fails all three (a [[0, 100], [100, 0]]
    block: its second pivot stays below zero at every factor)."""
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
    if escalate and hard and b >= 4 and p >= 2:
        c[2] = _rotate(rng, np.r_[np.linspace(1.0, 2.0, p - 1), -1.0])
        c[3] = np.eye(p)
        c[3][:2, :2] = [[0.0, 100.0], [100.0, 0.0]]
        k[2:4] = 1.0
        a_oo[2:4] = 0.0
    a_oo = a_oo * k[:, :, None] * k[:, None, :]
    f32 = np.float32
    return c.astype(f32), k.astype(f32), a_oo.astype(f32)


def lower_case(rng, b, p):
    """Well-conditioned lower factors: a small random strict lower part on
    a diagonal in [1, 2]."""
    low = np.tril(rng.standard_normal((b, p, p)), -1) * (0.5 / np.sqrt(p))
    diag = rng.uniform(1.0, 2.0, (b, p))
    return (low + diag[:, :, None] * np.eye(p)).astype(np.float32)


def tri_case(rng, b, p):
    """``lower_case`` and, when b >= 5, members K3's kernels leave to the
    twin's whole-row substitution: member 1 with an exactly zero diagonal
    entry (row P // 2), member 2 with a NaN below the diagonal (row 100 or
    the last: in the first block column's panel when P > 100), member 3
    with a subnormal diagonal entry (its row's quotients overflow), and
    member 4 whose first three diagonal entries are 1e-20 (finite and in
    the quotient's range, but its inverse overflows to inf)."""
    lt = lower_case(rng, b, p)
    if b >= 5:
        z = p // 2
        lt[1, z, z] = 0.0
        r = min(100, p - 1)
        lt[2, r, min(3, r)] = np.nan
        lt[3, p - 1, p - 1] = 1e-39
        for i in range(min(3, p)):
            lt[4, i, i] = 1e-20
    return lt


def check_tri_inv(name, got, lt):
    """K3's result against its twin, each member held to its own scale,
    identical inf and NaN patterns, and exact zeros above the diagonal of
    every member whose result is finite. Returns the max error over
    ``tri_case``'s healthy members (:func:`healthy_err`)."""
    import torch

    from pymra_torch.ops import linalg as tl

    want = tl.triangular_inverse_lower_ref(lt)
    compare(name, (got,), (want,), per_member=True)
    g, w = got.cpu(), want.cpu()
    check(torch.equal(torch.isnan(g), torch.isnan(w))
          and torch.equal(torch.isinf(g), torch.isinf(w)),
          f"{name}: inf / NaN pattern differs from the twin's")
    fin = torch.isfinite(w).flatten(1).all(1)
    check(bool((torch.triu(g[fin], 1) == 0).all()),
          f"{name}: a finite member has a nonzero above the diagonal")
    return healthy_err(g, w)


def healthy_err(got, want) -> float:
    """max|got - want| over ``tri_case``'s healthy members (all but 1-4):
    the others' entries reach 1e35 where finite, so their differences say
    nothing of the kernel's rounding (``compare`` holds each to its own
    scale)."""
    g, w = got.detach().cpu(), want.detach().cpu()
    keep = [b for b in range(len(w)) if not 1 <= b <= 4]
    return float((g[keep] - w[keep]).abs().max()) if keep else 0.0


def compare(name, got, want, factor_idx=frozenset(), per_member=False):
    """|kernel - twin| of every output against ATOL + RTOL times a scale:
    the output's max |twin|, or with ``per_member`` each member's own (the
    max |twin| over all of that member's outputs, so that one large member
    does not widen the others' tolerance). NaN patterns and the selected
    factors must be identical. Returns the max error."""
    import torch

    pairs = [(g.detach().cpu(), w.detach().cpu()) for g, w in zip(got, want)]
    if per_member:
        scale = torch.stack([
            w.nan_to_num(0.0, 0.0, 0.0).abs().reshape(len(w), -1).amax(1)
            for _, w in pairs]).amax(0)
    worst = 0.0
    for i, (g, w) in enumerate(pairs):
        if i in factor_idx:
            check(torch.equal(g, w), f"{name}: selected factors differ")
            continue
        fin = torch.isfinite(w)
        check(torch.equal(torch.isfinite(g), fin),
              f"{name}: output {i} non-finite pattern differs")
        if fin.any():
            diff = (g - w).abs()
            if per_member:
                tol = ATOL + RTOL * scale.reshape(-1, *[1] * (w.dim() - 1))
            else:
                tol = torch.tensor(ATOL + RTOL * float(w[fin].abs().max()))
            err = float(diff[fin].max())
            bad = (fin & (diff > tol)).nonzero()
            if len(bad):
                at = tuple(bad[0].tolist())
                limit = float(tol.expand_as(w)[at])
                fail(f"{name}: output {i} max|diff| {err:.3g}; |diff| "
                     f"{float(diff[at]):.3g} > {limit:.3g} at {at}")
            worst = max(worst, err)
    return worst


def bound_ms(nbytes: float, flops: float,
             flops64: float = 0.0) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM
    rate and the operations over the peak rate of their type (float32
    outside the tensor cores, float64 on the FP64 tensor cores; the two
    summed, as they share the SMs' instruction slots), with which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOP_PER_S + flops64 / FP64_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wide_flops(p: int) -> tuple[float, float]:
    """(float32, float64) operations of one blocked factorization of a
    ``P x P`` member in 64-wide block columns, as K8 and KC stage it: each
    diagonal block of width b factored and inverted in float32 (b^3/3
    each), the panels and downdates, the rest of the P^3/3, in float64. Up
    to P = 64 all P^3/3 are float32."""
    if p <= 64:
        return p ** 3 / 3, 0.0
    diag = sum(min(64, p - j) ** 3 / 3 for j in range(0, p, 64))
    return 2 * diag, p ** 3 / 3 - diag


def _attempts(f) -> float:
    """Factorizations run, given each member's selected factor (1, 1e2 or
    1e4 took 1, 2 or 3 attempts)."""
    return float((1 + (f >= 1e2).int() + (f >= 1e4).int()).sum())


def work(name, inputs, outputs) -> tuple[float, float, float]:
    """(bytes, float32 flops, float64 flops) one call needs on these
    inputs: each input read once, each output written once (float32), and
    the factorizations this run's escalation really took. Of a symmetric
    input (K1's C and A_oo, K2's and K4's matrix) or a lower-triangular
    one (K3's and K5's L) only the lower triangle, P(P+1)/2 entries of
    each matrix, has to be read;
    outputs are written whole; the Cholesky pullback's phi(L^T Lbar) needs
    only Lbar's lower triangle too, and K1's backward only Xbar's. Cholesky and a triangular inverse are
    P^3/3 flops each, a solve with Q columns P^2 Q; K8's and KC's are split
    by :func:`wide_flops`."""
    b, p = inputs[0].shape[0], inputs[0].shape[-1]
    if name == "cholesky_pullback_tile":  # KP's pullback mode: the same work
        name = "cholesky_pullback"
    triangular = {"leaf_factor": (0, 2), "leaf_pullback": (0, 2, 4),
                  "cholesky_pullback": (0, 1)}.get(name, (0,))
    nbytes = 4.0 * (sum(t.numel() for t in outputs) + sum(
        b * p * (p + 1) // 2 if i in triangular else t.numel()
        for i, t in enumerate(inputs)))
    flops64 = 0.0
    if name == "cholesky_cascade" and p > 64:
        flops, flops64 = (_attempts(outputs[2]) * x for x in wide_flops(p))
    elif name == "cholesky_blocked" and p > 64:
        flops, flops64 = (b * x for x in wide_flops(p))
    elif name in ("cholesky_jittered", "cholesky_cascade"):
        flops = _attempts(outputs[2]) * p ** 3 / 3
    elif name == "cholesky_logdet":
        flops = _attempts(outputs[1]) * p ** 3 / 3
    elif name == "cholesky_inv_logdet":
        # factor and inverse
        flops = _attempts(outputs[2]) * 2 * p ** 3 / 3
    elif name == "leaf_factor":
        # prior log-determinant P^3/3, posterior factor + inverse 2 P^3/3
        flops = (_attempts(outputs[3]) + 2 * _attempts(outputs[4])) \
            * p ** 3 / 3
    elif name == "leaf_pullback":
        # float64: the triangular products G, V (P^3 / 3 each) and S (2 P^3
        # / 3); float32: the prior's factor and inverse (2 P^3 / 3) and
        # Y^T Y on the lower triangle (P^3 / 3)
        flops, flops64 = b * p ** 3, b * 4 * p ** 3 / 3
    elif name == "solve_triangular_batched":
        flops = b * p * p * inputs[1].shape[-1]
    elif name == "cholesky_pullback":
        # L^T Lbar' on the lower triangle, then two solves with P columns
        flops = b * (p ** 3 / 3 + 2 * p ** 3)
    else:
        flops = b * p ** 3 / 3
    return nbytes, flops, flops64


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def timed(times, key, timer, dev_timer, run, plain, library, inputs):
    """Time kernel, twin and library call at one main-path shape; record
    them with the bound of the work; return the line's tail. ``ms`` and
    ``library_ms`` are per Python call (CUDA events, the host's share
    included); ``device_ms`` and ``library_device_ms`` only the device's
    activities, with their count per call."""
    out = run()
    out = out if isinstance(out, tuple) else (out,)
    ms, ms_ref = timer(run), timer(plain)
    dev, n_dev = dev_timer(run)
    ms_lib = lib_dev = n_lib = None
    if library is not None:
        ms_lib = timer(library)
        lib_dev, n_lib = dev_timer(library)
    b_ms, b_by = bound_ms(*work(key[0], inputs, list(out)))
    share = b_ms / ms
    dev_share = None if dev is None else b_ms / dev
    times[key] = {"ms": ms, "plain_ms": ms_ref, "library_ms": ms_lib,
                  "bound_ms": b_ms, "bound_by": b_by, "bound_share": share,
                  "device_ms": dev, "device_launches": n_dev,
                  "device_bound_share": dev_share,
                  "library_device_ms": lib_dev,
                  "library_device_launches": n_lib}
    lib = (f"{_ms(ms_lib)} (device {_ms(lib_dev)}, {n_lib:g} launches)"
           if library is not None else "none")
    dev_pct = "n/m" if dev_share is None else f"{100 * dev_share:.1f}%"
    return (f"; kernel {ms:.4f} ms (device {_ms(dev)}, {n_dev:g} launches), "
            f"twin {ms_ref:.4f} ms, library {lib}, bound {b_ms:.4f} ms "
            f"({b_by}; {100 * share:.1f}% of the call, {dev_pct} of the "
            "device time)")


def _library_factor(m, jit, eye):
    import torch

    return torch.linalg.cholesky_ex(m + jit[:, None, None] * eye)[0]


def _library_logdet(m, jit, eye):
    import torch

    lc = _library_factor(m, jit, eye)
    return torch.log(torch.diagonal(lc, dim1=-2, dim2=-1)).sum(-1)


def _library_inv(m, jit, eye):
    import torch

    lc = _library_factor(m, jit, eye)
    return torch.linalg.solve_triangular(lc, eye.expand_as(lc), upper=False)


#: the library yardstick of each jittered kernel, ``(m, jit, eye)``: one
#: attempt of the same function, no escalation
LIBRARY = {"cholesky_jittered": _library_factor,
           "cholesky_logdet": _library_logdet,
           "cholesky_inv_logdet": _library_inv,
           "cholesky_cascade": _library_factor}


def time_clean(times, err, name, b, p, rng, dev, timer, dev_timer):
    """Time the jittered kernel ``name``, its twin and its library call on
    a clean batch (``clean_case``) at ``(b, p)``, recorded under ``(name +
    "_clean", b, p)``: there one attempt of the library call does the
    kernel's whole work. The kernel is held to its twin there and no
    member may escalate. Returns the line's tail."""
    import torch

    from pymra_torch.ops import linalg as tl

    m, jit = (torch.as_tensor(x, device=dev) for x in clean_case(rng, b, p))
    eye = torch.eye(p, device=dev)
    fn, twin = getattr(tl, name), getattr(tl, name + "_ref")
    got = fn(m, jit)
    fidx = len(got) - 1  # every jittered kernel returns f last
    e = compare(f"{name} clean {b}x{p}", got, twin(m, jit),
                factor_idx={fidx})
    err[name] = max(err[name], e)
    check(bool((got[fidx] == tl.FACTORS[0]).all()),
          f"{name} clean {b}x{p}: a member escalated")
    return "; clean batch" + timed(
        times, (name + "_clean", b, p), timer, dev_timer,
        lambda: fn(m, jit), lambda: twin(m, jit),
        lambda: LIBRARY[name](m, jit, eye), [m, jit])


def _check_escalation(name, f):
    """Members 1-3 of ``chol_case`` escalate to 1e2, 1e2 and (all fail)
    1e4."""
    f = f.tolist()
    check(f[1] == 1e2 and f[2] == 1e2 and f[3] == 1e4,
          f"{name}: escalation factors {f[1:4]}, expected [100, 100, 10000]")


def phase_kernels(device="cuda", ragged=RAGGED_BATCH, chol_main=CHOL_MAIN,
                  leaf_main=LEAF_MAIN, tri_main=TRI_MAIN,
                  solve_main=SOLVE_MAIN, logdet_main=LOGDET_MAIN,
                  wide_widths=WIDE_WIDTHS, wide_main=WIDE_MAIN,
                  timer=time_ms, dev_timer=device_ms, chol_side=(),
                  solve_side=(), logdet_side=()):
    """Every kernel against its twin; timed at the main paths' shapes and
    at the side paths' (``*_side``: K2 and K6 recorded under ``(name, b,
    p)``, K5 under ``(name, b, p, q)``)."""
    import torch

    from pymra_torch.ops import linalg as tl

    print("== phase 3: kernels against their plain twins "
          f"(tolerance max|diff| <= {ATOL} + {RTOL} max|twin|)")
    rng = np.random.default_rng(0)
    clean_rng = np.random.default_rng(1)
    dev = torch.device(device)
    err = {n: 0.0 for n in KERNEL_NAMES if n not in BACKWARD_KERNELS}
    times = {}

    def dv(x):
        return torch.as_tensor(x, device=dev)

    shapes = ([(ragged, p) for p in SUBWARP_WIDTHS] + list(chol_main)
              + list(chol_side))
    for b, p in shapes:
        m, jit = chol_case(rng, b, p)
        mt, jt = dv(m), dv(jit)
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
        if (b, p) in chol_main or (b, p) in chol_side:
            eye = torch.eye(p, device=dev)
            line += timed(
                times, ("cholesky_jittered", b, p), timer, dev_timer,
                lambda: tl.cholesky_jittered(mt, jt),
                lambda: tl.cholesky_jittered_ref(mt, jt),
                lambda: _library_factor(mt, jt, eye), [mt, jt])
            line += time_clean(times, err, "cholesky_jittered", b, p,
                               clean_rng, dev, timer, dev_timer)
        print(line)

    shapes = [(ragged, p) for p in LEAF_WIDTHS] + list(leaf_main)
    for b, p in shapes:
        for escalate in (True, False):
            jitter = 1e-3 if escalate else 0.0
            c, k, a = (dv(x) for x in leaf_case(rng, b, p, escalate,
                                                  hard=True))
            got = tl.leaf_factor(c, k, a, jitter)
            want = tl.leaf_factor_ref(c, k, a, jitter)
            e = compare(f"leaf_factor {b}x{p} jitter={jitter}", got, want,
                        factor_idx={3, 4})
            err["leaf_factor"] = max(err["leaf_factor"], e)
            fp, fq = got[3].tolist(), got[4].tolist()
            if escalate:
                # members 1-3: 1e2, 1e4, and 1e4 with every attempt failed
                want_f = [1e2, 1e4, 1e4]
                failed = not any(np.isfinite(got[i][3].item())
                                 for i in (1, 2))
                check(fp[1:4] == want_f and fq[1:4] == want_f and failed,
                      f"leaf_factor {b}x{p}: escalation factors "
                      f"{fp[1:4]}, {fq[1:4]}, expected [100, 10000, 10000] "
                      "with member 3 failing")
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
                line += timed(
                    times, ("leaf_factor", b, p), timer, dev_timer,
                    lambda: tl.leaf_factor(c, k, a, jitter),
                    lambda: tl.leaf_factor_ref(c, k, a, jitter), None,
                    [c, k, a])
            print(line)

    # K4: no jitter, so the indefinite, negative-pivot and -I members of
    # chol_case come out NaN from their failing column on, in both
    shapes = [(ragged, p) for p in CHOL_WIDTHS] + list(tri_main)
    for b, p in shapes:
        m = chol_case(rng, b, p)[0]
        if b >= 5 and p >= 4:
            # an exactly zero pivot mid-way with a coupling below it: L gets
            # 0/0 on the diagonal and x/0 = inf under it
            z = p // 2
            m[4] = np.eye(p)
            m[4][z, z] = 0.0
            m[4][z + 1, z] = m[4][z, z + 1] = 0.5
        mt = dv(m)
        got = tl.cholesky(mt)
        e = compare(f"cholesky {b}x{p}", (got,), (tl.cholesky_ref(mt),))
        err["cholesky"] = max(err["cholesky"], e)
        if p > 1 and b >= 4:
            check(bool(torch.isfinite(got[0]).all())
                  and bool(torch.isnan(got[3][:, 0]).all()),
                  f"cholesky {b}x{p}: healthy member not finite or -I "
                  "member's first column not NaN")
        line = f"cholesky B={b} P={p}: max|diff| {e:.3g}"
        if (b, p) in tri_main:
            line += timed(times, ("cholesky", b, p), timer, dev_timer,
                          lambda: tl.cholesky(mt),
                          lambda: tl.cholesky_ref(mt),
                          lambda: torch.linalg.cholesky_ex(mt), [mt])
        print(line)

    # K3: tri_case's members that take the twin's whole-row substitution
    # in the kernel are checked; the times are taken on healthy factors
    for b, p in shapes:
        lt = dv(tri_case(rng, b, p))
        e = check_tri_inv(f"triangular_inverse_lower {b}x{p}",
                          tl.triangular_inverse_lower(lt), lt)
        err["triangular_inverse_lower"] = max(
            err["triangular_inverse_lower"], e)
        line = f"triangular_inverse_lower B={b} P={p}: max|diff| {e:.3g}"
        if (b, p) in tri_main:
            lt = dv(lower_case(rng, b, p))
            eye = torch.eye(p, device=dev).expand_as(lt)
            line += timed(
                times, ("triangular_inverse_lower", b, p), timer, dev_timer,
                lambda: tl.triangular_inverse_lower(lt),
                lambda: tl.triangular_inverse_lower_ref(lt),
                lambda: torch.linalg.solve_triangular(lt, eye, upper=False),
                [lt])
        print(line)
        del lt

    # K5 at every width with Q = 1 and Q = P, both directions, tri_case's
    # members that take the twin's whole-row substitution in the kernel
    # included (each member held to its own scale; the error reported is
    # the healthy members'); timed at the paths' shapes on healthy factors
    for p in CHOL_WIDTHS:
        lt = dv(tri_case(rng, ragged, p))
        for q in sorted({1, p}):
            rhs = dv(rng.standard_normal((ragged, p, q)).astype(np.float32))
            for transpose in (False, True):
                got = tl.solve_triangular_batched(lt, rhs, transpose)
                want = tl.solve_triangular_batched_ref(lt, rhs, transpose)
                compare(f"solve_triangular_batched {ragged}x{p}x{q} "
                        f"T={transpose}", (got,), (want,), per_member=True)
                e = healthy_err(got, want)
                err["solve_triangular_batched"] = max(
                    err["solve_triangular_batched"], e)
                print(f"solve_triangular_batched B={ragged} P={p} Q={q} "
                      f"transpose={transpose}: max|diff| {e:.3g}")
    # the main paths' shapes recorded under (name, b, p), the side paths'
    # under (name, b, p, q)
    solves = ([(shape, shape[:2]) for shape in solve_main]
              + [(shape, shape[:3]) for shape in solve_side])
    for (b, p, q, transpose), key in solves:
        lt = dv(lower_case(rng, b, p))
        rhs = dv(rng.standard_normal((b, p, q)).astype(np.float32))
        e = compare(f"solve_triangular_batched {b}x{p}x{q} T={transpose}",
                    (tl.solve_triangular_batched(lt, rhs, transpose),),
                    (tl.solve_triangular_batched_ref(lt, rhs, transpose),))
        err["solve_triangular_batched"] = max(
            err["solve_triangular_batched"], e)
        # the library's solve of op(L) x = b, op(L) = L^T upper
        op_l = lt.transpose(-1, -2) if transpose else lt
        print(f"solve_triangular_batched B={b} P={p} Q={q} "
              f"transpose={transpose}: max|diff| {e:.3g}" + timed(
                  times, ("solve_triangular_batched",) + key, timer,
                  dev_timer,
                  lambda: tl.solve_triangular_batched(lt, rhs, transpose),
                  lambda: tl.solve_triangular_batched_ref(lt, rhs,
                                                          transpose),
                  lambda: torch.linalg.solve_triangular(
                      op_l, rhs, upper=transpose), [lt, rhs]))

    # K6 and K7: chol_case's escalated, exact-zero-pivot and all-fail
    # members, where the kernel runs up to three attempts and the library
    # yardstick one; then the clean batch, where both run one
    shapes = ([(ragged, p) for p in LOGDET_WIDTHS] + list(logdet_main)
              + list(logdet_side))
    for b, p in shapes:
        m, jit = chol_case(rng, b, p)
        mt, jt = dv(m), dv(jit)
        eye = torch.eye(p, device=dev)
        for name, fidx in (("cholesky_logdet", 1), ("cholesky_inv_logdet", 2)):
            fn, twin = getattr(tl, name), getattr(tl, name + "_ref")
            got = fn(mt, jt)
            e = compare(f"{name} {b}x{p}", got, twin(mt, jt),
                        factor_idx={fidx})
            err[name] = max(err[name], e)
            if p > 1 and b >= 4:
                _check_escalation(f"{name} {b}x{p}", got[fidx])
            line = f"{name} B={b} P={p}: max|diff| {e:.3g}"
            if (b, p) in logdet_main or (
                    name == "cholesky_logdet" and (b, p) in logdet_side):
                line += timed(times, (name, b, p), timer, dev_timer,
                              lambda: fn(mt, jt), lambda: twin(mt, jt),
                              lambda: LIBRARY[name](mt, jt, eye), [mt, jt])
                line += time_clean(times, err, name, b, p, clean_rng, dev,
                                   timer, dev_timer)
            print(line)

    # K8 and KC (one wide kernel), and the wide K3: K8 has no jitter, so
    # wide_case's failing members are NaN from their failing column on; KC
    # escalates them (member 4 to 1e4) or fails all three (the -I and NaN
    # members)
    shapes = [(ragged, p) for p in wide_widths] + list(wide_main)
    for b, p in shapes:
        m, jit = wide_case(rng, b, p)
        mt, jt = dv(m), dv(jit)
        eye = torch.eye(p, device=dev)
        main = (b, p) in wide_main

        def composed_k8(a):
            return tl._blocked(a, tl.MAX_P, tl.cholesky,
                               tl.triangular_inverse_lower)

        def composed_kc():
            # the composition KC ran before the wide kernel
            return tl._escalate(mt, jt, tl.FACTORS,
                                tl._cascade_attempt(composed_k8))

        got = tl.cholesky_blocked(mt)
        e = compare(f"cholesky_blocked {b}x{p}", (got,),
                    (tl.cholesky_blocked_ref(mt),))
        err["cholesky_blocked"] = max(err["cholesky_blocked"], e)
        check(bool(torch.isfinite(got[0]).all())
              and bool(torch.isnan(got[3][:, 0]).all()),
              f"cholesky_blocked {b}x{p}: healthy member not finite or -I "
              "member's first column not NaN")
        line = f"cholesky_blocked B={b} P={p}: max|diff| {e:.3g}"
        if main:
            line += timed(times, ("cholesky_blocked", b, p), timer, dev_timer,
                          lambda: tl.cholesky_blocked(mt),
                          lambda: tl.cholesky_blocked_ref(mt),
                          lambda: torch.linalg.cholesky_ex(mt), [mt])
            ms = timer(lambda: composed_k8(mt))
            times[("cholesky_blocked", b, p)]["composed_ms"] = ms
            line += f"; the composition it replaced {ms:.4f} ms"
        print(line)
        del got

        got = tl.cholesky_cascade(mt, jt)
        e = compare(f"cholesky_cascade {b}x{p}", got,
                    tl.cholesky_cascade_ref(mt, jt), factor_idx={2})
        err["cholesky_cascade"] = max(err["cholesky_cascade"], e)
        f = got[2].tolist()
        ok = torch.isfinite(got[0]).flatten(1).all(1).tolist()
        if b >= 6:
            check(f[1:6] == [1e2, 1e2, 1e4, 1e4, 1e4]
                  and ok[:6] == [True, True, True, False, True, False],
                  f"cholesky_cascade {b}x{p}: escalation factors {f[1:6]} "
                  f"(finite {ok[1:6]}), expected [100, 100, 10000, 10000, "
                  "10000] with members 3 and 5 failing")
        else:
            _check_escalation(f"cholesky_cascade {b}x{p}", got[2])
        line = f"cholesky_cascade B={b} P={p}: max|diff| {e:.3g}"
        if main:
            line += timed(
                times, ("cholesky_cascade", b, p), timer, dev_timer,
                lambda: tl.cholesky_cascade(mt, jt),
                lambda: tl.cholesky_cascade_ref(mt, jt),
                lambda: _library_factor(mt, jt, eye), [mt, jt])
            ms = timer(composed_kc)
            times[("cholesky_cascade", b, p)]["composed_ms"] = ms
            line += f"; the composition it replaced {ms:.4f} ms"
            if dev.type == "cuda":
                # no host synchronization in the call
                torch.cuda.set_sync_debug_mode("error")
                try:
                    tl.cholesky_cascade(mt, jt)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                line += "; no host synchronization (sync debug mode error)"
            line += time_clean(times, err, "cholesky_cascade", b, p,
                               clean_rng, dev, timer, dev_timer)
        print(line)
        del got, m, mt

        # on the CPU the wrapper above 64 is the blocked composition over
        # the twin, whose matmuls spread a member's NaN by columns where
        # the twin's whole-row updates spread it by rows: the twin's inf
        # and NaN patterns are the kernel's, held on the card only
        odd = dev.type == "cuda"
        lt = dv(tri_case(rng, b, p) if odd else lower_case(rng, b, p))
        e = check_tri_inv(f"triangular_inverse_lower (wide) {b}x{p}",
                          tl.triangular_inverse_lower(lt), lt)
        err["triangular_inverse_lower_wide"] = max(
            err["triangular_inverse_lower_wide"], e)
        line = (f"triangular_inverse_lower (wide) B={b} P={p}: "
                f"max|diff| {e:.3g}")
        if main:
            key = ("triangular_inverse_lower_wide", b, p)
            lt = dv(lower_case(rng, b, p))
            line += timed(
                times, key, timer, dev_timer,
                lambda: tl.triangular_inverse_lower(lt),
                lambda: tl.triangular_inverse_lower_ref(lt),
                lambda: torch.linalg.solve_triangular(
                    lt, eye.expand_as(lt), upper=False), [lt])
            # the composition it replaced: the P <= 64 kernel on the
            # 64-wide diagonal blocks, float32 matmuls for the rest
            ms = timer(lambda: tl._tri_inv_blocked(lt, tl._tri_inv_fwd))
            times[key]["composed_ms"] = ms
            line += f"; the composition it replaced {ms:.4f} ms"
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
                try:
                    tl.triangular_inverse_lower(lt)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                line += "; no host synchronization (sync debug mode error)"
        print(line)
        del lt
    return err, times


# ---------------------------------------------------------------------------
# phase 3b: backward passes on the card against the CPU twins
# ---------------------------------------------------------------------------

def _backward(fn, inputs, cotangents, device):
    """Gradients of ``fn``'s outputs with the given cotangents, inputs and
    cotangents copied to ``device`` (float32)."""
    import torch

    xs = [torch.tensor(x, device=device, requires_grad=True)
          for x in inputs]
    outs = fn(*xs)
    return torch.autograd.grad(
        outs, xs, [torch.tensor(c, device=device) for c in cotangents])


def time_backward(m, jit, lbar, device, timer, dev_timer) -> dict:
    """Per-call and device time of ``cholesky_jittered``'s backward as the
    sweep runs it: the factor's cotangent only, the jitter structural (no
    gradient)."""
    import torch

    from pymra_torch.ops import linalg as tl

    mt = torch.tensor(m, device=device, requires_grad=True)
    l = tl.cholesky_jittered(mt, torch.as_tensor(jit, device=device))[0]
    lb = torch.as_tensor(lbar, device=device)

    def run():
        return torch.autograd.grad(l, mt, lb, retain_graph=True)

    ms = timer(run)
    dev, n_dev = dev_timer(run)
    return {"ms": ms, "device_ms": dev, "device_launches": n_dev}


def phase_backward(device="cuda", chol_main=CHOL_MAIN, leaf_main=LEAF_MAIN,
                   logdet_main=LOGDET_MAIN, wide_main=WIDE_MAIN[:1],
                   pullback_shapes=PULLBACK_SHAPES,
                   pullback_main=PULLBACK_MAIN, timer=time_ms,
                   dev_timer=device_ms, pullback_side=()):
    """Backward passes against CPU copies; the fused pullback against its
    twin, timed at ``pullback_main`` and at the side paths' shapes
    ``pullback_side``, each shape recorded under its kernel's record and
    ``(b, p)``: ``cholesky_pullback`` up to P = 8 (the lane kernel),
    ``cholesky_pullback_tile`` above (the core's pullback mode)."""
    import torch

    from pymra_torch.ops import linalg as tl

    print("== phase 3b: backward on the card against CPU copies, the fused "
          f"pullback against its twin (tolerance |diff| <= {ATOL} + {RTOL} "
          "max|cpu| of each member)")
    err = dict.fromkeys(["cholesky_pullback", "cholesky_pullback_tile",
                         "cholesky_jittered",
                         "leaf_factor", "cholesky_logdet",
                         "cholesky_inv_logdet", "cholesky_cascade",
                         "cholesky_blocked"], 0.0)
    times = {}
    f32 = np.float32

    # the fused pullback at K2's factors (escalated and all-fail members
    # included) against the composition it fuses, on the same tensors; its
    # own draws, so that the checks below keep their inputs; timed at every
    # main-path and side-path shape, on the device over
    # PULLBACK_DEVICE_REPS launches
    rng = np.random.default_rng(11)
    timed_at = tuple(pullback_main) + tuple(pullback_side)
    for b, p in tuple(pullback_shapes) + tuple(pullback_side):
        m, jit = chol_case(rng, b, p)
        l, _, f = tl.cholesky_jittered(torch.as_tensor(m, device=device),
                                       torch.as_tensor(jit, device=device))
        lbar, ldbar = (torch.as_tensor(rng.standard_normal(s).astype(f32),
                                       device=device)
                       for s in (m.shape, (b,)))
        args = (l, lbar, ldbar, f)
        name = ("cholesky_pullback" if tl.jittered_tier(p) == 0
                else "cholesky_pullback_tile")
        got, want = tl.cholesky_pullback(*args), tl.cholesky_pullback_ref(*args)
        e = compare(f"{name} {b}x{p}", got, want, per_member=True)
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            check(torch.equal(torch.isnan(g), torch.isnan(w)),
                  f"{name} {b}x{p}: NaN pattern differs from the twin's")
        err[name] = max(err[name], e)
        line = f"{name} B={b} P={p}: max|diff| {e:.3g}"
        if (b, p) in timed_at:
            line += timed(times, (name, b, p), timer,
                          lambda fn: dev_timer(fn, PULLBACK_DEVICE_REPS),
                          lambda: tl.cholesky_pullback(*args),
                          lambda: tl.cholesky_pullback_ref(*args), None,
                          list(args))
        print(line)

    def chol(m, jit):
        return tl.cholesky_jittered(m, jit)[:2]

    rng = np.random.default_rng(1)
    for b, p in chol_main:
        m, jit = chol_case(rng, b, p)
        cot = [rng.standard_normal(m.shape).astype(f32),
               rng.standard_normal(b).astype(f32)]
        e = compare(f"cholesky_jittered backward {b}x{p}",
                    _backward(chol, [m, jit], cot, device),
                    _backward(chol, [m, jit], cot, "cpu"), per_member=True)
        err["cholesky_jittered"] = max(err["cholesky_jittered"], e)
        t = time_backward(m, jit, cot[0], device, timer, dev_timer)
        times[("cholesky_jittered_backward", b, p)] = t
        print(f"cholesky_jittered backward B={b} P={p}: max|diff| {e:.3g}; "
              f"as the sweep calls it {t['ms']:.4f} ms per call (device "
              f"{_ms(t['device_ms'])}, {t['device_launches']:g} launches)")

    for b, p in leaf_main:
        c, k, a = leaf_case(rng, b, p, escalate=True)

        def leaf(cc, aa, k=k):
            import torch

            return tl.leaf_factor(cc, torch.as_tensor(k, device=cc.device),
                                  aa, 1e-3)[:3]

        cot = [rng.standard_normal(c.shape).astype(f32),
               rng.standard_normal(b).astype(f32),
               rng.standard_normal(b).astype(f32)]
        e = compare(f"leaf_factor backward {b}x{p}",
                    _backward(leaf, [c, a], cot, device),
                    _backward(leaf, [c, a], cot, "cpu"), per_member=True)
        err["leaf_factor"] = max(err["leaf_factor"], e)
        print(f"leaf_factor backward B={b} P={p}: max|diff| {e:.3g}")

    # K6, K7 and KC, escalated and all-fail members included; the jitter
    # gets its gradient too
    def logdet(m, jit):
        return tl.cholesky_logdet(m, jit)[:1]

    def inv_logdet(m, jit):
        return tl.cholesky_inv_logdet(m, jit)[:2]

    def cascade(m, jit):
        return tl.cholesky_cascade(m, jit)[:2]

    cases = [("cholesky_logdet", logdet, s) for s in logdet_main] + [
        ("cholesky_inv_logdet", inv_logdet, s) for s in logdet_main] + [
        ("cholesky_cascade", cascade, s) for s in wide_main]
    for name, fn, (b, p) in cases:
        m, jit = chol_case(rng, b, p)
        cot = ([] if name == "cholesky_logdet"
               else [rng.standard_normal(m.shape).astype(f32)])
        cot.append(rng.standard_normal(b).astype(f32))
        e = compare(f"{name} backward {b}x{p}",
                    _backward(fn, [m, jit], cot, device),
                    _backward(fn, [m, jit], cot, "cpu"), per_member=True)
        err[name] = max(err[name], e)
        print(f"{name} backward B={b} P={p}: max|diff| {e:.3g}")

    # K8's pullback, on healthy members (it has no escalation)
    def blocked(m):
        return (tl.cholesky_blocked(m),)

    for b, p in wide_main:
        m = _spd_batch(rng, b, p).astype(f32)
        cot = [np.tril(rng.standard_normal(m.shape)).astype(f32)]
        e = compare(f"cholesky_blocked backward {b}x{p}",
                    _backward(blocked, [m], cot, device),
                    _backward(blocked, [m], cot, "cpu"), per_member=True)
        err["cholesky_blocked"] = max(err["cholesky_blocked"], e)
        print(f"cholesky_blocked backward B={b} P={p}: max|diff| {e:.3g}")
    return err, times


def leaf_pullback_case(rng, b, p, device, sets=1):
    """K1's backward's arguments after ``jitter``: ``leaf_case``'s members
    (escalated and hard: masked slots, a fully masked leaf, factors 1e2 and
    1e4, an all-fail member; ``b // sets`` of them, repeated ``sets``
    times, as the sets of a batched sweep repeat its nodes), K1's forward
    on them on ``device`` at jitter 1e-3, and random cotangents of its
    three differentiable outputs: ``(c, kmask, li, fp, libar, ldpbar,
    ldqbar)``."""
    import torch

    from pymra_torch.ops import linalg as tl

    c, k, a = (np.concatenate([x] * sets) for x in leaf_case(
        rng, b // sets, p, escalate=True, hard=True))
    c, k, a = (torch.as_tensor(x, device=device) for x in (c, k, a))
    li, _, _, fp, _ = tl.leaf_factor(c, k, a, 1e-3)
    del a
    bars = [torch.as_tensor(rng.standard_normal(s, dtype=np.float32),
                            device=device) for s in ((b, p, p), (b,), (b,))]
    return [c, k, li, fp] + bars


def phase_leaf_pullback(device="cuda", shapes=LEAF_PULLBACK_MAIN,
                        sets=LEAF_PULLBACK_SETS, timer=time_ms,
                        dev_timer=device_ms):
    """Phase 3c: K1's backward against its twin on the same tensors at
    ``shapes`` (the first of them ``sets`` copies of its leaves), timed;
    returns ``(err, times)`` under the record ``leaf_pullback``."""
    import torch

    from pymra_torch.ops import linalg as tl
    from pymra_torch.ops.cuda import build

    print("== phase 3c: K1's backward (leaf_pullback) against its twin on "
          f"the same tensors (tolerance |diff| <= {ATOL} + {RTOL} max|twin| "
          "of each member)")
    log = build.build_log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "leaf_pullback_kernel" in line:
            tier = line.split("leaf_pullback_kernelILi")[1].split("E")[0]
            print(f"  ptxas, tier {8 * int(tier)}:",
                  " ".join(x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                           if "Used" in x or "spill" in x))
    err, times = {"leaf_pullback": 0.0}, {}
    rng = np.random.default_rng(13)
    for i, (b, p) in enumerate(shapes):
        args = leaf_pullback_case(rng, b, p, device, sets if i == 0 else 1)
        f = args[3].cpu()
        n_esc = {fac: int((f == fac).sum()) for fac in (1e2, 1e4)}

        def run(args=args):
            return tl.leaf_pullback(*args, 1e-3)

        def plain(args=args):
            return tl.leaf_pullback_ref(*args, 1e-3)

        got, want = run(), plain()
        e = compare(f"leaf_pullback {b}x{p}", got, want, per_member=True)
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            check(torch.equal(torch.isnan(g), torch.isnan(w)),
                  f"leaf_pullback {b}x{p}: NaN pattern differs from the "
                  "twin's")
        check(bool(torch.isnan(got[0][3]).all()),
              f"leaf_pullback {b}x{p}: the all-fail member is not NaN")
        del got, want
        err["leaf_pullback"] = max(err["leaf_pullback"], e)
        line = (f"leaf_pullback B={b} P={p} (prior factors 1e2, 1e4: "
                f"{n_esc[1e2]}, {n_esc[1e4]} members): max|diff| {e:.3g}")
        line += timed(times, ("leaf_pullback", b, p), timer, dev_timer, run,
                      plain, None, args)
        twin_dev, twin_n = dev_timer(plain)
        times["leaf_pullback", b, p]["plain_device_ms"] = twin_dev
        times["leaf_pullback", b, p]["plain_device_launches"] = twin_n
        print(line + f"; twin on the device {_ms(twin_dev)} ({twin_n:g} "
              "launches)")
        del args
        if device == "cuda":
            torch.cuda.empty_cache()
    return err, times


#: phase 3d: grid1m's leaves under 4 parameter sets: sets, leaves of the
#: 128 x 128 boxes, locations a leaf, ancestor knots (8 at each of 7
#: levels) plus the leaf's own locations
MATERN_SHAPE = (4, 16384, 64, 56 + 64)
#: phase 3d's slices: leaves held to the float64 twin, and to its
#: gradient
MATERN_F64_LEAVES, MATERN_GRAD_LEAVES = 512, 64


def matern_case(rng, shape, device):
    """Points laid out as grid1m's tree lays them out: each leaf's
    locations uniform in its box of the 128 x 128 boxes of the unit square,
    its ancestors' knots (8 at each of the 7 coarser levels) uniform in the
    ancestor's box, then the leaf's own locations; the sets' ``l`` around
    0.05 and ``sig`` around 1 (grid1m.grad4's draws)."""
    import torch

    C, n, p, q = shape
    side = int(round(n ** 0.5))
    ix, iy = np.divmod(np.arange(n), side)
    corner = np.stack([ix, iy], -1)[:, None, :] / side
    own = corner + rng.random((n, p, 2)) / side
    anc = []
    for k in range(7):  # level k's boxes have side 2^-k
        box = np.floor(corner * 2 ** k) / 2 ** k
        anc.append(box + rng.random((n, 8, 2)) / 2 ** k)
    b = np.concatenate(anc + [own], 1)[:, :q]
    f32 = dict(dtype=torch.float32, device=device)
    l = torch.as_tensor(np.exp(rng.normal(np.log(0.05), 0.15, C)), **f32)
    sig = torch.as_tensor(np.exp(rng.normal(0.0, 0.1, C)), **f32)
    return (torch.as_tensor(own, **f32), torch.as_tensor(b, **f32), l, sig)


#: operations per entry and set the general-nu Matern needs at the least:
#: half of what a float32-accurate rational approximation of s^nu K_nu(s)
#: takes (degree 6: 24 operations and a division; s^nu e^-s: a logarithm
#: and an exponential, ~16 fused multiply-adds; the distance and its
#: scaling: 7), and 48 for the pullback, which adds K_(nu-1) and two sums
MATERN_FWD_OPS, MATERN_PULLBACK_OPS = 32.0, 48.0


def matern_work(sets, b, p, q, pullback=False) -> tuple[float, float]:
    """(bytes, float32 operations) of one launch of the Matern kernel on
    ``sets`` parameter sets of a ``[b, p, q]`` block of 2-D points: the
    points, ``l`` and ``sig`` read once, the covariance written once (the
    pullback reads its cotangent instead and writes two sums a set)."""
    entries = float(sets) * b * p * q
    nbytes = 4.0 * (entries + 2 * b * (p + q) + 2 * sets
                    + (2 * sets if pullback else 0))
    return nbytes, entries * (MATERN_PULLBACK_OPS if pullback
                              else MATERN_FWD_OPS)


def _matern_fallback_count(special, a, b, nu):
    """The forward's counter of entries outside its table under a traced
    annotation, at l = 1e-4 (far points: s above 2^10), 500 (near points:
    s below 2^-12) and 0.05, against the count from the distances."""
    import torch

    from pymra_torch.utils import profiling

    l = torch.tensor([1e-4, 500.0, 0.05], dtype=a.dtype, device=a.device)
    name = "chip_smoke.matern_fallback"
    with profiling.tracing(), profiling.trace_annotation(name), \
            torch.no_grad():
        special.matern_cuda(a, b, l.reshape(-1, 1, 1, 1), 1.0, nu)
    rec = [r for r in profiling.spans() if r["name"] == name][-1]
    d = torch.sqrt(((a[:, :, None] - b[:, None]) ** 2).sum(-1)).double()
    x = math.sqrt(2.0 * nu) * d / l.double().reshape(-1, 1, 1, 1)
    want = int(((x > 0) & ((x < 2.0 ** -12) | (x >= 2.0 ** 10))).sum())
    return rec["counts"].get("cov_fallback_entries"), want


def phase_matern_kernel(device="cuda", shape=MATERN_SHAPE, nu=0.8,
                        timer=time_ms, dev_timer=device_ms):
    """Phase 3d: the general-nu Matern kernel against its twins at
    ``shape``, timed; returns its record."""
    import torch

    from pymra_torch.ops import special
    from pymra_torch.ops.cuda import build

    C, n, p, q = shape
    print(f"== phase 3d: the general-nu Matern kernel (nu={nu}) at {C} sets"
          f" x {n} x {p} x {q} against its twin (tolerance |diff| <= {ATOL}"
          f" + {RTOL} max|twin|) and the float64 twin")
    log = build.build_log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "matern" in line:
            print("  ptxas:", line.split("'")[1] if "'" in line else line,
                  " ".join(x.split(":", 1)[-1].strip()
                           for x in log[i + 1:i + 4]
                           if "Used" in x or "spill" in x))
    a, b, l, sig = matern_case(np.random.default_rng(31), shape, device)
    lb, sb = l.reshape(-1, 1, 1, 1), sig.reshape(-1, 1, 1, 1)
    before = special.matern_cuda.launches
    with torch.no_grad():
        got = special.matern_cuda(a, b, lb, sb, nu)
    check(special.matern_cuda.launches - before == 1,
          "matern: a call is not one launch")
    d = torch.sqrt(((a[:, :, None] - b[:, None]) ** 2).sum(-1))
    err = 0.0
    for c in range(C):  # the twin a set at a time (its temporaries)
        want = special.matern_general(d, l[c], sig[c], nu)
        err = max(err, compare(f"matern set {c}", [got[c]], [want]))
        check(torch.equal(torch.isnan(got[c]), torch.isnan(want)),
              f"matern set {c}: NaN pattern differs from the twin's")
        del want
    k = MATERN_F64_LEAVES
    want64 = special.matern_general(d[:k].double(), lb.double(),
                                    sb.double(), nu)
    rel64 = float(((got[:, :k].double() - want64).abs()
                   / want64.abs().clamp_min(1e-30)).max())
    top64 = float((got[:, :k].double() - want64).abs().max()
                  / want64.abs().max())
    del want64
    # the pullback against the float64 twin's autograd on a slice
    k = min(MATERN_GRAD_LEAVES, n)
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (C, k, p, q)), dtype=torch.float32, device=device)
    lt, st = l.clone().requires_grad_(), sig.clone().requires_grad_()
    (special.matern_cuda(a[:k], b[:k], lt.reshape(-1, 1, 1, 1),
                         st.reshape(-1, 1, 1, 1), nu) * g).sum().backward()
    l64, s64 = (t.double().requires_grad_() for t in (l, sig))
    (special.matern_general(d[:k].double(), l64.reshape(-1, 1, 1, 1),
                            s64.reshape(-1, 1, 1, 1), nu)
     * g.double()).sum().backward()
    grad_rel = max(float(((x.grad.double() - y.grad).abs()
                          / y.grad.abs()).max())
                   for x, y in ((lt, l64), (st, s64)))
    check(grad_rel <= 1e-5, f"matern pullback: {grad_rel:.3g} off the "
          "float64 twin's gradient (limit 1e-5)")
    del d, g
    print(f"matern {C}x{n}x{p}x{q}: max|diff| against the float32 twin "
          f"{err:.3g}; against float64 (first {MATERN_F64_LEAVES} leaves) "
          f"{rel64:.3g} relative, {top64:.3g} of the largest; pullback "
          f"against the float64 twin's gradient (first {MATERN_GRAD_LEAVES} "
          f"leaves) {grad_rel:.3g} relative")
    tables = {}
    for v in sorted({nu, 0.3, 1.3, 2.2}):
        tab = special.matern_table(v, device)
        nbytes = 0 if tab.table is None else tab.table.numel() * 8
        tables[v] = {"bytes": nbytes, "build_ms": 1e3 * tab.build_s,
                     "max_err": tab.max_err}
        print(f"matern table nu={v}: {nbytes} bytes, built and uploaded in "
              f"{1e3 * tab.build_s:.3f} ms, the table's largest relative "
              f"error {tab.max_err:.3g}"
              + ("" if nbytes else " (no table: the series and CF2)"))
    fell, want = _matern_fallback_count(special, a[:64], b[:64], nu)
    check(fell == want > 0, f"matern: the forward counted {fell} entries "
          f"outside its table, {want} lie there")
    print(f"matern fallback counter: {fell} entries outside the table, as "
          f"expected")

    def forward():
        with torch.no_grad():
            return special.matern_cuda(a, b, lb, sb, nu)

    gout = torch.ones_like(got)
    del got

    def pullback():
        return special._matern_pullback(a, b, None, l, sig, gout, nu)

    rec = {"max_abs_err": err, "f64_rel_err": rel64, "f64_err": top64,
           "grad_rel_err": grad_rel, "tables": tables,
           "fallback_entries": fell}
    for name, fn, pb in (("forward", forward, False),
                         ("pullback", pullback, True)):
        ms = timer(fn)
        dev, n_dev = dev_timer(fn)
        before = _matern_launches(special)
        fn()
        launches = _matern_launches(special) - before
        bound = bound_ms(*matern_work(C, n, p, q, pullback=pb))[0]
        share = None if dev is None else 100.0 * bound / dev
        rec[name] = {"ms": ms, "device_ms": dev, "device_launches": n_dev,
                     "launches_per_call": launches, "bound_ms": bound,
                     "roofline_pct": share}
        print(f"matern {name}: {ms:.3f} ms (device {_ms(dev)}, {n_dev:g} "
              f"launches), {launches:g} launches a call; bound {bound:.4f} "
              f"ms (bytes), "
              + ("roofline not measured" if share is None else
                 f"{share:.2f}% of its roofline"))
    del gout
    # the twin's device time and launches at one set of 1024 leaves
    k = 1024
    dk = torch.sqrt(((a[:k, :, None] - b[:k, None]) ** 2).sum(-1))
    twin_dev, twin_n = dev_timer(
        lambda: special.matern_general(dk, l[0], sig[0], nu), reps=2)
    print(f"the twin at 1 set x {k} leaves: device {_ms(twin_dev)}, "
          f"{twin_n:g} launches a covariance call")
    rec["twin_1024_leaves"] = {"device_ms": twin_dev, "launches": twin_n}
    del a, b, dk
    if device != "cpu":
        torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def leaf_pullback_twin():
    """K1's backward as it ran before its kernel: ``leaf_pullback`` is its
    twin ``leaf_pullback_ref`` for the block."""
    from pymra_torch.ops import linalg as tl

    kernel = tl.leaf_pullback
    tl.leaf_pullback = tl.leaf_pullback_ref
    try:
        yield
    finally:
        tl.leaf_pullback = kernel


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
    return {"ms_lik": ms_lik, "model": model, "y": y, "full": full}


# ---------------------------------------------------------------------------
# phases 7-8: the gradient path
# ---------------------------------------------------------------------------

def exponential_builder(theta):
    from pymra_torch import Kernel

    return Kernel("exponential", l=theta["l"], sig=theta["sig"])


def value_and_grad(f, l, sig):
    """``f({l, sig})`` and its gradient, the parameters 0-dim float64 CPU
    tensors (``loglik_fn`` copies a dict's tensors to the device)."""
    import torch

    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in (("l", l), ("sig", sig))}
    value = f(theta)
    value.backward()
    return float(value.detach()), {k: float(t.grad)
                                   for k, t in theta.items()}


def _grad_timer(f, ls, timer):
    """ms per value-and-gradient evaluation over ``ls`` (one warm-up)."""
    it = iter(ls)
    return timer(lambda: value_and_grad(f, float(next(it)), 1.0),
                 reps=len(ls) - 1)


def phase_grad_n10k(device="cuda", timer=time_ms, n_evals=10,
                    data="large", r=4, M=4, R=1e-4,
                    golden=GOLDEN_GRAD_N10K):
    import torch

    from pymra_torch import MRAModel, PlanConfig, load_data

    locs, y_obs = load_data(data)
    tag = f"N={len(locs)}"
    print(f"== phase 7: gradient path at {tag} (bundled {data}, r={r}, "
          f"M={M}, exponential l=2 sig=1, R={R})")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y_dev = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    f = model.loglik_fn(y_dev, R, kernel_builder=exponential_builder)
    value, grad = value_and_grad(f, 2.0, 1.0)
    check(np.isfinite(value), f"{tag} loglik {value} not finite")
    # parameters left on the host (a tuple is not moved to the device)
    # meet the device's locations as 0-dim tensors and get the same
    # gradient, summed on the device and sent back per covariance call
    f_host = model.loglik_fn(y_dev, R, kernel_builder=lambda th: (
        exponential_builder(dict(th))))
    theta = tuple((k, torch.tensor(v, dtype=torch.float64,
                                   requires_grad=True))
                  for k, v in (("l", 2.0), ("sig", 1.0)))
    f_host(theta).backward()
    for k, t in theta:
        check(t.grad is not None and abs(float(t.grad) - grad[k])
              <= 1e-6 * abs(grad[k]), f"{tag} host parameter {k}: gradient "
              f"{t.grad} differs from {grad[k]}")
    for k in ("l", "sig"):
        rel = abs(grad[k] - golden[k]) / abs(golden[k])
        print(f"{tag} dloglik/d{k} {grad[k]!r} golden {golden[k]!r} rel "
              f"err {rel:.3g} (limit {GRAD_RTOL})")
        check(rel <= GRAD_RTOL,
              f"{tag} dloglik/d{k} off its golden by {rel:.3g}")
    ms = _grad_timer(f, np.linspace(1.5, 2.5, n_evals + 1), timer)
    print(f"{tag} value and gradient: {ms:.3f} ms/eval ({n_evals} evals, "
          "l in [1.5, 2.5])")
    return ms


def five_point(fn, h):
    """Derivative at 0 of ``fn`` from its values at -2h, -h, h, 2h."""
    return (8.0 * (fn(h) - fn(-h)) - (fn(2 * h) - fn(-2 * h))) / (12.0 * h)


def gradient_vs_difference(f, tag, device, l0=0.05):
    """Value and gradient of ``f`` at (l0, sig=1), finite, with the peak
    device memory of that evaluation; each partial in log-parameter held
    to a five-point difference of ``f``'s own values. Returns ``(peak GiB,
    differences, autograd)``."""
    import torch

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    value, grad = value_and_grad(f, l0, 1.0)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else float("nan"))
    check(np.isfinite(value) and all(np.isfinite(list(grad.values()))),
          f"{tag} value {value} or gradient {grad} not finite")

    def loglik(l, sig):
        with torch.no_grad():
            return float(f({"l": torch.tensor(l, dtype=torch.float64),
                            "sig": torch.tensor(sig, dtype=torch.float64)}))

    # derivatives in log-parameter: d/dlog l = l d/dl
    fd = {"l": five_point(lambda t: loglik(l0 * np.exp(t), 1.0), FD_STEP),
          "sig": five_point(lambda t: loglik(l0, np.exp(t)), FD_STEP)}
    ad = {"l": l0 * grad["l"], "sig": 1.0 * grad["sig"]}
    for k in ("l", "sig"):
        rel = abs(ad[k] - fd[k]) / abs(fd[k])
        print(f"{tag} dloglik/dlog {k}: autograd {ad[k]!r}, five-point "
              f"difference (step {FD_STEP}) {fd[k]!r}, rel diff {rel:.3g} "
              f"(limit {FD_RTOL})")
        check(rel <= FD_RTOL, f"{tag} gradient in {k} off the difference "
                              f"by {rel:.3g}")
    return peak, fd, ad


def phase_grad_n1m(n1m, ms_forward, device="cuda", timer=time_ms,
                   n_evals=5, fit_steps=3):
    from pymra_torch import fit_mle

    model, y = n1m["model"], n1m["y"]
    n = model.dplan.n_locs
    print(f"== phase 8: gradient path at N={n} (l=0.05, sig=1, R=1e-2)")
    f = model.loglik_fn(y, 1e-2, kernel_builder=exponential_builder)
    peak, fd, ad = gradient_vs_difference(f, f"N={n}", device)
    ms = _grad_timer(f, np.linspace(0.04, 0.06, n_evals + 1), timer)
    print(f"N={n} value and gradient: {ms:.3f} ms/eval ({n_evals} evals, "
          f"l in [0.04, 0.06]); {ms / ms_forward:.2f}x the likelihood-only "
          f"forward; peak device memory with autograd {peak:.2f} GiB")

    res = fit_mle(f, {"l": 0.04, "sig": 1.0}, method="lbfgs",
                  steps=fit_steps)
    start = -res["history"][0]
    print(f"N={n} fit_mle lbfgs {len(res['history'])} steps from l=0.04 "
          f"sig=1: loglik {start!r} -> {res['loglik']!r} at {res['theta']}")
    check(np.isfinite(res["loglik"]) and res["loglik"] > start,
          f"N={n} fit_mle did not raise the loglik ({start} -> "
          f"{res['loglik']})")
    return {"ms": ms, "peak": peak, "fd": fd, "ad": ad, "theta": res["theta"]}


def phase_leaf_pullback_n1m(n1m, device="cuda", timer=time_ms, n_evals=5,
                            sets=None, R=None):
    """Phase 9b: the batched value and gradient on phase 5's plan and data
    at phase 13c's N=10^6 sets, K1's backward the kernel and then its twin
    (:func:`leaf_pullback_twin`): loglik and gradient of each set against
    the twin's; ms per evaluation in turns (kernel, twin, twin, kernel) and
    peak memory of both."""
    sets = BATCH_N1M if sets is None else sets
    R = SAMPLER_R if R is None else R
    model, y = n1m["model"], n1m["y"]
    n, C = model.dplan.n_locs, len(sets["l"])
    print(f"== phase 9b: K1's backward at N={n}, {C} parameter sets "
          f"batched (R={R}): the kernel against its twin")
    fb = model.loglik_fn(y, R, kernel_builder=exponential_builder,
                         batched=True)
    batched_value_and_grad(fb, sets)  # warm-up
    _reset_peak(device)
    values, grads = batched_value_and_grad(fb, sets)
    peak = _peak_gib(device)
    with leaf_pullback_twin():
        batched_value_and_grad(fb, sets)
        _reset_peak(device)
        values_t, grads_t = batched_value_and_grad(fb, sets)
        peak_t = _peak_gib(device)
    worst = {"value": float(np.max(np.abs(values - values_t)
                                   / np.abs(values_t))),
             "grad": max(float(np.max(np.abs(grads[k] - grads_t[k])
                                      / np.abs(grads_t[k])))
                         for k in ("l", "sig"))}
    print(f"N={n} C={C} kernel against twin: loglik rel diff "
          f"{worst['value']:.3g} (limit {BATCH_OBJ_RTOL}), gradient "
          f"{worst['grad']:.3g} (limit {BATCH_GRAD_RTOL}); gradient "
          f"{ {k: v.tolist() for k, v in grads.items()} }, twin's "
          f"{ {k: v.tolist() for k, v in grads_t.items()} }")
    check(worst["value"] <= BATCH_OBJ_RTOL,
          f"N={n}: loglik with K1's backward kernel off the twin's by "
          f"{worst['value']:.3g}")
    check(worst["grad"] <= BATCH_GRAD_RTOL,
          f"N={n}: gradient with K1's backward kernel off the twin's by "
          f"{worst['grad']:.3g}")
    shifts = np.exp(np.linspace(-0.01, 0.01, n_evals + 1))

    def call():
        it = iter(shifts)

        def one():
            t = next(it)
            batched_value_and_grad(fb, {"l": [l * t for l in sets["l"]],
                                        "sig": sets["sig"]})
        return one

    ms = {"kernel": [], "twin": []}
    for turn in ("kernel", "twin", "twin", "kernel"):
        with (leaf_pullback_twin() if turn == "twin"
              else contextlib.nullcontext()):
            ms[turn].append(timer(call(), reps=n_evals))
    print(f"N={n} C={C} value and gradient, ms per batched evaluation in "
          f"turns: kernel {ms['kernel']}, twin {ms['twin']}; peak device "
          f"memory {peak:.2f} GiB (twin {peak_t:.2f} GiB)")
    return {"worst": worst, "ms": ms, "peak": peak, "peak_twin": peak_t}


# ---------------------------------------------------------------------------
# phases 10-11: dense measurement error and wide leaves
# ---------------------------------------------------------------------------

def correlated_r(locs, device, scale=DENSE_R_SCALE, rho=DENSE_R_RHO):
    """``R_ij = scale exp(-|s_i - s_j| / rho)`` on the device, formed in
    float64 and rounded once."""
    import torch

    s = torch.as_tensor(np.asarray(locs), dtype=torch.float64, device=device)
    return (scale * torch.exp(-torch.cdist(s, s) / rho)).float()


def _held(tag, got, golden, rtol):
    """Each of objective, dloglik/dl, dloglik/dsig within ``rtol`` of its
    golden."""
    for k, v in got.items():
        rel = abs(v - golden[k]) / abs(golden[k])
        print(f"{tag} {k} {v!r} golden {golden[k]!r} rel err {rel:.3g} "
              f"(limit {rtol})")
        check(rel <= rtol, f"{tag} {k} off its golden by {rel:.3g}")


def sweep_value_and_grad(model, y, R, l, sig):
    """Objective and gradient of ``sweep(...).loglik`` in (l, sig), the
    parameters float64 tensors on the model's device: the gradient path of
    a dense R (``loglik_fn`` takes a diagonal R). ``l`` and ``sig`` as
    lists of C values run C sets through one sweep: every entry is then a
    list (of the sets' values)."""
    import torch

    from pymra_torch import Kernel

    th = {k: torch.tensor(v, dtype=torch.float64, device=model.device,
                          requires_grad=True)
          for k, v in (("l", l), ("sig", sig))}
    res = model.sweep(Kernel("exponential", l=th["l"], sig=th["sig"]), y, R,
                      compute_posterior=False)
    res.loglik.sum().backward()
    return {"objective": res.objective.detach().tolist(),
            "loglik": res.loglik.detach().tolist(),
            **{k: t.grad.tolist() for k, t in th.items()}}


def phase_dense_r(device="cuda", timer=time_ms, n_evals=10, data="large",
                  r=4, M=4, rho=DENSE_R_RHO, golden_diag=GOLDEN_N10K,
                  golden=GOLDEN_DENSE_R_N10K):
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data

    locs, y_obs = load_data(data)
    n = len(locs)
    tag = f"dense R N={n}"
    print(f"== phase 10: dense measurement error at N={n} (bundled {data}, "
          f"r={r}, M={M}, exponential l=2)")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    kern = Kernel("exponential", l=2.0)

    # (a) the bench tree's R = 1e-4 I, passed as a dense matrix
    eye_r = torch.diag(torch.full((n,), 1e-4, device=device))
    dense = float(model.objective(kern, y, eye_r))
    diag = float(model.objective(kern, y, 1e-4))
    _anchor(f"{tag} (a) 1e-4 I as a dense R:", dense, golden_diag)
    rel = abs(dense - diag) / abs(diag)
    print(f"{tag} (a) against the diagonal path's {diag!r}: rel diff "
          f"{rel:.3g} (limit {ANCHOR_RTOL})")
    check(rel <= ANCHOR_RTOL, f"{tag} (a) off the diagonal path by {rel:.3g}")
    del eye_r

    # (b) a correlated R: objective and gradient against the float64 golden
    R = correlated_r(locs, device, rho=rho)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    got = sweep_value_and_grad(model, y, R, 2.0, 1.0)
    _held(f"{tag} (b)", {k: got[k] for k in golden}, golden, GRAD_RTOL)
    full = model.sweep(kern, y, R)
    for name, v in (("mean", full.mean), ("var", full.var)):
        check(tuple(v.shape) == (n,) and bool(torch.isfinite(v).all()),
              f"{tag} (b) posterior {name} not finite of shape [{n}]")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else float("nan"))
    ls = np.linspace(1.5, 2.5, n_evals + 1)
    ms_full = _sweep_timer(lambda l: model.sweep(Kernel("exponential", l=l),
                                                 y, R), ls, timer)
    it = iter(ls)
    ms_grad = timer(lambda: sweep_value_and_grad(model, y, R,
                                                 float(next(it)), 1.0),
                    reps=n_evals)
    print(f"{tag} (b) full likelihood+posterior: {ms_full:.3f} ms/eval; "
          f"value and gradient: {ms_grad:.3f} ms/eval ({n_evals} evals, "
          f"l in [1.5, 2.5]); peak device memory with autograd {peak:.2f} "
          "GiB (R itself takes "
          f"{R.numel() * 4 / 2**30:.2f})")
    return {"ms_full": ms_full, "ms_grad": ms_grad, "peak": peak,
            "model": model, "y": y, "R": R}


#: phase 10b: phase 13f's N=10^4 sets under phase 10's correlated R, the
#: first at the golden's parameters
DENSE_BATCH = POST_BATCH_N10K


def phase_dense_r_batched(dense, device="cuda", timer=time_ms, n_evals=5,
                          sets=DENSE_BATCH, golden=GOLDEN_DENSE_R_N10K):
    """Phase 10b: phase 10's tree and correlated R with C sets through one
    sweep: the batched objective and gradient and each set's alone against
    the set's float64 ones (computed here on the host: see
    ``F64_POST_RTOL``), the golden's set against the frozen golden,
    launches per batched value and gradient against one single
    evaluation's (R's blocks factored and y whitened once), the batched
    posterior's shape, ms and peak memory."""
    import torch

    from pymra_torch import MRAModel

    model, y, R = dense["model"], dense["y"], dense["R"]
    n = model.dplan.n_locs
    C = len(sets["l"])
    tag = f"dense R N={n} batched"
    print(f"== phase 10b: phase 10's correlated R with {C} parameter sets "
          f"through one sweep ({sets})")

    def one(c, t=1.0):
        return sweep_value_and_grad(model, y, R, sets["l"][c] * t,
                                    sets["sig"][c])

    def batch(t=1.0):
        return sweep_value_and_grad(model, y, R,
                                    [l * t for l in sets["l"]],
                                    list(sets["sig"]))

    one(0)  # warm-up, uncounted
    before = _launch_snapshot()
    singles = [one(c) for c in range(C)]
    mid = _launch_snapshot()
    _reset_peak(device)
    got = batch()
    peak = _peak_gib(device)
    after = _launch_snapshot()
    per_single = {k: (mid[k] - before[k]) / C for k in KERNEL_NAMES}
    per_batch = {k: after[k] - mid[k] for k in KERNEL_NAMES}
    print(f"{tag} kernel launches per value and gradient: one set alone "
          f"{ {k: v for k, v in per_single.items() if v} }, {C} sets batched "
          f"{ {k: v for k, v in per_batch.items() if v} } (R's blocks by K2 "
          "and y's whitening by K5 once for all sets)")
    check(per_batch == per_single, f"{tag}: the batch of {C} launched "
          f"{per_batch}, one set alone {per_single}")
    _held(f"{tag} set 0", {k: got[k][0] for k in golden}, golden, GRAD_RTOL)
    exact = MRAModel(model.plan.locs, model.plan.r, plan=model.plan,
                     dtype=torch.float64, device="cpu")
    R64 = R.detach().to("cpu", torch.float64)
    y64 = y.detach().to("cpu", torch.float64)
    f64 = [sweep_value_and_grad(exact, y64, R64, sets["l"][c],
                                sets["sig"][c]) for c in range(C)]
    worst = {}
    for name, runs in (("batched", [{k: got[k][c] for k in got}
                                     for c in range(C)]),
                       ("alone", singles)):
        for key, limit in (("objective", ANCHOR_RTOL), ("grad", GRAD_RTOL)):
            names = ("objective",) if key == "objective" else ("l", "sig")
            worst[name, key] = max(abs(o[k] - w[k]) / abs(w[k])
                                   for o, w in zip(runs, f64)
                                   for k in names)
            print(f"{tag} {name} {key} against each set's float64: rel diff"
                  f" {worst[name, key]:.3g} (limit {limit})")
            check(worst[name, key] <= limit,
                  f"{tag}: {name} {key} off float64 by "
                  f"{worst[name, key]:.3g}")
    worst["loglik"] = max(abs(got["loglik"][c] - o["loglik"])
                          / abs(o["loglik"]) for c, o in enumerate(singles))
    worst["grad"] = max(abs(got[k][c] - o[k]) / abs(o[k])
                        for c, o in enumerate(singles) for k in ("l", "sig"))
    print(f"{tag} against each set alone: loglik rel diff "
          f"{worst['loglik']:.3g}, gradient {worst['grad']:.3g} (reported; "
          "see F64_POST_RTOL)")
    full = model.sweep(batched_kernel(sets), y, R)
    check(tuple(full.mean.shape) == (C, n)
          and bool(torch.isfinite(full.mean).all())
          and bool((full.var > 0).all()),
          f"{tag}: batched posterior of shape {tuple(full.mean.shape)}, "
          "not finite or a variance not positive")
    shifts = np.exp(np.linspace(-0.01, 0.01, n_evals + 1))
    it = iter(shifts)
    ms_batch = timer(lambda: batch(float(next(it))), reps=n_evals)
    it = iter(shifts)
    ms_single = timer(lambda: one(0, float(next(it))), reps=n_evals)
    print(f"{tag} value and gradient: {ms_batch:.3f} ms per batched "
          f"evaluation of {C} sets against {ms_single:.3f} ms for one set "
          f"alone ({C} alone: {C * ms_single:.3f}; {n_evals} evals each); "
          f"peak device memory of the batched evaluation {peak:.2f} GiB")
    return {"ms_batch": ms_batch, "ms_single": ms_single, "peak": peak,
            "worst": worst, "launches": per_batch}


def phase_wide(device="cuda", timer=time_ms, n_evals=8, data="large", r=4,
               M=3, golden=GOLDEN_WIDE_N10K, side=1000, big_M=6, big_l=0.05,
               grad_evals=3):
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs
    from pymra_torch.utils import gen_locations_2d

    locs, y_obs = load_data(data)
    print(f"== phase 11: leaves wider than 64 (bundled {data}, r={r}, "
          f"M={M}, R={WIDE_R}; a {side}^2 grid, r=8, M={big_M}, "
          f"l={big_l}, R=1e-2)")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    widths = sorted({lvl.leaf_locs.shape[1] for lvl in model.dplan.levels
                     if lvl.leaf_locs.shape[0]})
    tag = f"N={len(locs)} M={M} (leaves of {widths})"
    check(max(widths) > 64, f"{tag}: no leaf wider than 64")
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    f = model.loglik_fn(y, WIDE_R, kernel_builder=exponential_builder)
    value, grad = value_and_grad(f, 2.0, 1.0)
    n_obs = int(np.isfinite(y_obs).sum())
    _held(tag, {"objective": -2.0 * value - n_obs * np.log(2.0 * np.pi),
                **grad}, golden, GRAD_RTOL)

    big = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y_np = rng.standard_normal(len(big)).astype(np.float32)
    y_np[rng.random(len(big)) > 0.9] = np.nan
    t0 = time.perf_counter()
    bmodel = MRAModel(big, r=8, M=big_M, dtype=torch.float32,
                      config=PlanConfig(r=8, kmeans_impl="native"),
                      device=device)
    leaf = [tuple(lvl.leaf_locs.shape[:2]) for lvl in bmodel.dplan.levels
            if lvl.leaf_locs.shape[0]]
    tag = f"N={len(big)} M={big_M} (leaves {leaf})"
    print(f"{tag}: plan + upload {time.perf_counter() - t0:.2f} s")
    yb = torch.as_tensor(y_np, device=device)
    dplan, jitter = bmodel.dplan, bmodel.jitter
    prep = prepare_obs(dplan, yb, 1e-2)

    def evaluate(l, post=False):
        return mra_sweep(dplan, Kernel("exponential", l=l), yb, 1e-2,
                         compute_posterior=post, jitter=jitter, prep=prep)

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    full = evaluate(big_l, post=True)
    check(bool(torch.isfinite(full.objective)), f"{tag} objective not finite")
    for name, v in (("mean", full.mean), ("var", full.var)):
        check(bool(torch.isfinite(v).all()),
              f"{tag} posterior {name} not finite")
    print(f"{tag} objective {float(full.objective)!r}")
    del full
    thetas = big_l * np.linspace(0.8, 1.2, n_evals + 1)
    ms_lik = _sweep_timer(evaluate, thetas, timer)
    ms_full = _sweep_timer(lambda l: evaluate(l, post=True), thetas, timer)
    peak_fwd = (torch.cuda.max_memory_allocated() / 2**30
                if device != "cpu" else float("nan"))
    print(f"{tag} likelihood-only: {ms_lik:.3f} ms/eval; full "
          f"likelihood+posterior: {ms_full:.3f} ms/eval ({n_evals} evals, "
          f"l in [{thetas[0]:.3g}, {thetas[-1]:.3g}]); peak device memory "
          f"{peak_fwd:.2f} GiB")
    fb = bmodel.loglik_fn(yb, 1e-2, kernel_builder=exponential_builder)
    peak, fd, ad = gradient_vs_difference(fb, tag, device, l0=big_l)
    ms_grad = _grad_timer(fb, big_l * np.linspace(0.8, 1.2, grad_evals + 1),
                          timer)
    print(f"{tag} value and gradient: {ms_grad:.3f} ms/eval ({grad_evals} "
          f"evals); {ms_grad / ms_lik:.2f}x the likelihood-only forward; "
          f"peak device memory with autograd {peak:.2f} GiB")
    return {"ms_lik": ms_lik, "ms_full": ms_full, "ms_grad": ms_grad,
            "peak": peak, "fd": fd, "ad": ad}


# ---------------------------------------------------------------------------
# phases 13, 13b: the samplers on the gradient path
# ---------------------------------------------------------------------------

#: the samplers' parameters are log l and log sig of the exponential kernel,
#: under weak normal priors of this sd centred at l = sig = 1
PRIOR_SD = 2.0
SAMPLER_PARAMS = ("log_l", "log_sig")
#: SMC's prior: a normal of this sd in log-space around the MLE, so that its
#: draws stay where the float32 factorization holds
SMC_PRIOR_SD = 0.05
#: NUTS's mean acceptance statistic must land in this range, and the
#: divergence rate of NUTS's retained draws stay at most this
ACCEPT_RANGE = (0.6, 0.99)
MAX_DIVERGENCE_RATE = 0.05
#: each chain's last draw: the log_prob the sampler recorded, and the value
#: and gradient its evaluation there returned, against log_prob_fn evaluated
#: again, within this times max(1, |log_prob|) (float32 sums of terms of the
#: loglik's size; the backward's summation order is not fixed on the card)
REEVAL_RTOL = 1e-6
#: run lengths of phase 13 (N=10^4) and 13b (N=10^6)
SAMPLER_RUNS = {
    "nuts": {"chains": 4, "num_warmup": 40, "num_samples": 40,
             "max_depth": 5},
    "hmc": {"chains": 2, "num_warmup": 20, "num_samples": 20,
            "num_leapfrog": 4},
    "advi": {"steps": 20, "num_mc": 2},
    "smc": {"n_particles": 16, "n_mutations": 2, "max_stages": 10},
}
N1M_NUTS = {"chains": 2, "num_warmup": 10, "num_samples": 10, "max_depth": 4}
#: the float32 roughness: the loglik at this many points across +- this
#: many conditional posterior sds of log l around the MLE
ROUGH_POINTS, ROUGH_SDS = 21, 3.0
#: phase 13 samples at this measurement error. At phase 7's R=1e-4 the
#: float32 loglik near its MLE is rough by tens of loglik units, the JAX
#: package's float32 path too (``tools/float32_roughness.py``): NUTS's
#: step size collapses and SMC meets a non-finite loglik. The phase
#: reports the roughness there too
SAMPLER_R = 1e-2
ROUGH_RS = (1e-2, 1e-4)
#: the sampler's own host cost is its ms per evaluation less that of the
#: same log posterior evaluated alone at this many of the points the
#: sampler visited, on the same host clock (phase 13, phase 13b)
REPLAY_EVALS, N1M_REPLAY_EVALS = 200, 40


def natural(theta):
    """``{log_l, log_sig}`` -> ``{l, sig}``."""
    import torch

    return {"l": torch.exp(theta["log_l"]), "sig": torch.exp(theta["log_sig"])}


def log_posterior(f):
    """``theta -> f(l, sig)`` plus the weak normal priors on ``theta``."""

    def logp(theta):
        prior = sum(-0.5 * (theta[k] / PRIOR_SD) ** 2 for k in SAMPLER_PARAMS)
        value = f(natural(theta))
        # a batch's [C] prior on the host goes to the loglik's device (a
        # 0-dim one meets it as a scalar)
        return value + (prior.to(value.device) if prior.dim() else prior)

    return logp


def _key(theta, row=None) -> tuple:
    """The parameter values of a point (``row`` of a batch of them)."""
    return tuple(float(theta[k].detach() if row is None
                       else theta[k].detach()[row]) for k in sorted(theta))


class CountingLogProb:
    """A sampler's ``log_prob_fn``: counts its evaluations (``calls``) and
    the points they evaluated (``rows``: a batched call, whose leaves carry
    a leading ``[k]`` axis, evaluates ``k``), and keeps each point's value
    and the gradient the sampler's backward pass sent to its parameters,
    keyed by the parameter values; a batched call's points also keep the
    whole batch and their row in it."""

    def __init__(self, fn):
        self.fn, self.calls, self.rows, self.seen = fn, 0, 0, {}

    def __call__(self, theta):
        self.calls += 1
        lead = theta[SAMPLER_PARAMS[0]].shape
        if not lead:
            self.rows += 1
            recs = [{"grad": {}}]
            self.seen[_key(theta)] = recs[0]
        else:
            self.rows += lead[0]
            batch = {k: t.detach().clone() for k, t in theta.items()}
            recs = [{"grad": {}, "batch": batch, "row": i}
                    for i in range(lead[0])]
            for i, rec in enumerate(recs):
                self.seen[_key(theta, i)] = rec
        def keep(g, k):
            for rec, gi in zip(recs, g.reshape(-1).tolist()):
                rec["grad"][k] = gi

        for k, t in theta.items():
            if t.requires_grad:
                t.register_hook(lambda g, k=k: keep(g, k))
        value = self.fn(theta)
        for rec, v in zip(recs, value.detach().reshape(-1).tolist()):
            rec["value"] = v
        return value


def fresh_evaluation(logp, rec, theta):
    """``logp``'s value and gradient evaluated again where ``rec`` was:
    at ``theta`` (0-dim leaves), or for a point of a batched call at that
    call's whole batch again (``logp`` batched), read at its row."""
    if "batch" in rec:
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in rec["batch"].items()}
    value = logp(theta)
    value.sum().backward()
    row = rec.get("row", 0)
    return (float(value.detach().reshape(-1)[row]),
            {k: float(theta[k].grad.reshape(-1)[row])
             for k in SAMPLER_PARAMS})


def check_last_draws(tag, res, counter, logp) -> float:
    """Each chain's last draw: the log_prob the sampler recorded there, and
    the value and gradient its evaluation there returned, held to ``logp``
    evaluated again (catches a sampler, or a ``log_prob_fn``, that carries a
    stale value or gradient); after a batched run ``logp`` is the batched
    log posterior and evaluates that evaluation's batch again. Returns the
    largest difference relative to ``max(1, |log_prob|)``."""
    worst = 0.0
    for c in range(res.log_prob.shape[0]):
        theta = {k: res.samples[k][c, -1].clone().requires_grad_(True)
                 for k in SAMPLER_PARAMS}
        rec = counter.seen.get(_key(theta))
        check(rec is not None, f"{tag} chain {c}: no evaluation at its last "
                               "draw")
        v, grad = fresh_evaluation(logp, rec, theta)
        diffs = [abs(float(res.log_prob[c, -1]) - v), abs(rec["value"] - v)]
        diffs += [abs(rec["grad"].get(k, np.nan) - grad[k])
                  for k in SAMPLER_PARAMS]
        scale = max(1.0, abs(v))
        check(all(d <= REEVAL_RTOL * scale for d in diffs),
              f"{tag} chain {c}: log_prob {float(res.log_prob[c, -1])!r}, "
              f"evaluation {rec['value']!r} with gradient {rec['grad']} at "
              f"the last draw; evaluated again {v!r} with gradient {grad} "
              f"(limit {REEVAL_RTOL} of {scale:.6g})")
        worst = max(worst, max(diffs) / scale)
    return worst


def replay_ms(logp, counter, n) -> tuple:
    """ms per evaluation of ``logp`` alone, its value and gradient read back
    as a sampler reads them, at ``n`` (at least 2) of the points
    ``counter`` saw, evenly spaced over the run, timed as a sampler's run
    is: the host clock around the loop. The two interleaved halves of the
    points are timed one after the other; returns the ms per evaluation of
    all and the difference between the halves' (the host clock's spread)."""
    import torch

    seen = list(counter.seen)
    points = seen[::max(1, len(seen) // n)][:n]
    ms = []
    for half in (points[0::2], points[1::2]):
        t0 = time.perf_counter()
        for point in half:
            theta = {k: torch.tensor(v, dtype=torch.float64,
                                     requires_grad=True)
                     for k, v in zip(sorted(SAMPLER_PARAMS), point)}
            value = logp(theta)
            value.backward()
            float(value.detach())
            [float(t.grad) for t in theta.values()]
        ms.append(1e3 * (time.perf_counter() - t0) / len(half))
    both = (ms[0] * len(points[0::2]) + ms[1] * len(points[1::2])) / len(
        points)
    return both, abs(ms[0] - ms[1])


def _per_param(values, digits) -> dict:
    return {k: round(float(v), digits) for k, v in zip(SAMPLER_PARAMS,
                                                       values)}


def _draws(res):
    """``[chains, n, 2]`` draws of (log l, log sig) as numpy."""
    import torch

    return torch.stack([res.samples[k] for k in SAMPLER_PARAMS],
                       dim=-1).numpy()


def _chain_report(tag, res, transitions, counter, wall, ms_mle, logp,
                  x_mle, replay, divergences=None) -> dict:
    """The checks every chain sampler's run passes (finite draws and
    log_prob, ``check_samples`` at the divergence limit, the last draws
    held to a fresh evaluation) and its report, with its host cost: ms per
    evaluation in the sampler less :func:`replay_ms` at ``replay`` of its
    points (``ms_mle``: CUDA events near the MLE, phase 7's way)."""
    from pymra_torch.infer import ess, split_rhat
    from pymra_torch.utils.health import check_samples

    reeval = check_last_draws(tag, res, counter, logp)
    rep = check_samples(res.samples, divergences,
                        max_divergence_rate=MAX_DIVERGENCE_RATE)
    check(rep.ok, f"{tag} draws: {rep}")
    check(bool(np.isfinite(res.log_prob.numpy()).all()),
          f"{tag} log_prob not finite")
    xs = _draws(res)
    chains, n = xs.shape[:2]
    rhat = split_rhat(xs).numpy()
    e = ess(xs).numpy()
    mean, sd = xs.reshape(-1, 2).mean(0), xs.reshape(-1, 2).std(0)
    off = np.abs(mean - np.array([x_mle[k] for k in SAMPLER_PARAMS])) / sd
    alone, spread = replay_ms(logp, counter, replay)
    out = {"wall_s": wall, "ms_per_draw": 1e3 * wall / transitions,
           "evals_per_draw": counter.calls / transitions,
           "ms_per_eval": 1e3 * wall / counter.calls,
           "ms_per_eval_alone": alone, "alone_spread_ms": spread,
           "host_ms_per_eval": 1e3 * wall / counter.calls - alone,
           "step_size": res.step_size.tolist(), "rhat": rhat.tolist(),
           "ess": e.tolist(), "post_mean": mean.tolist(),
           "post_sd": sd.tolist(), "mean_minus_mle_sds": off.tolist(),
           "accept": float(res.accept_rate.mean()), "reeval_rel": reeval}
    print(f"{tag}: {chains} chains x {transitions // chains} transitions "
          f"({n} kept) in {wall:.2f} s: {out['ms_per_draw']:.3f} ms per "
          f"draw, {out['evals_per_draw']:.3f} value-and-gradient "
          f"evaluations per draw, {out['ms_per_eval']:.3f} ms per "
          f"evaluation in the sampler against {alone:.3f} ms alone at "
          f"{min(replay, len(counter.seen))} of its points (host clock; "
          f"the replay's halves differ by {spread:.3f} ms): host cost "
          f"{out['host_ms_per_eval']:.3f} ms per evaluation ({ms_mle:.3f} "
          f"ms near the MLE by CUDA events); "
          f"accept {out['accept']:.4f}; step sizes "
          f"{[round(v, 6) for v in out['step_size']]}")
    print(f"{tag}: split-R-hat {_per_param(rhat, 4)}, ESS "
          f"{_per_param(e, 1)}, posterior mean {_per_param(mean, 5)} sd "
          f"{_per_param(sd, 5)}, |mean - MLE| {_per_param(off, 3)} sd; "
          f"last draws "
          f"against a fresh evaluation: {reeval:.3g} of |log_prob| (limit "
          f"{REEVAL_RTOL})")
    return out


def conditional_sd(f, theta, h=1e-2) -> float:
    """The sd of log l given log sig in the Laplace approximation at
    ``theta`` (``{l, sig}``): one over the square root of minus the second
    derivative of the log posterior in log l, from a central difference of
    ``f``'s gradient at log l +- h."""
    g = [theta["l"] * np.exp(s) * value_and_grad(
        f, theta["l"] * np.exp(s), theta["sig"])[1]["l"] for s in (h, -h)]
    curv = (g[0] - g[1]) / (2 * h) - 1.0 / PRIOR_SD ** 2
    return 1.0 / np.sqrt(-curv) if curv < 0 else float("nan")


def roughness(tag, f, theta, sd) -> float:
    """float32 roughness: the residual sd, in loglik units, of a quadratic
    fit to ``f`` at ROUGH_POINTS points across +-ROUGH_SDS ``sd`` of log l
    around ``theta`` (log sig there)."""
    import torch

    ts = np.linspace(-ROUGH_SDS, ROUGH_SDS, ROUGH_POINTS) * sd
    with torch.no_grad():
        vals = np.array([float(f({
            "l": torch.tensor(theta["l"] * np.exp(t), dtype=torch.float64),
            "sig": torch.tensor(theta["sig"], dtype=torch.float64)}))
            for t in ts])
    fits = {d: vals - np.polyval(np.polyfit(ts, vals, d), ts) for d in (2, 4)}
    rough = {d: float(np.sqrt(np.sum(r * r) / (len(ts) - d - 1)))
             for d, r in fits.items()}
    print(f"{tag} float32 roughness: the loglik at {len(ts)} points across "
          f"+-{ROUGH_SDS:g} x {sd:.4g} (the conditional posterior sd of log "
          f"l) around l={theta['l']:.6g}, sig={theta['sig']:.6g}: residual "
          f"sd {rough[2]:.4g} of a quadratic fit ({rough[4]:.4g} of a "
          f"quartic), loglik {float(vals.min())!r} .. "
          f"{float(vals.max())!r}")
    check(bool(np.isfinite(vals).all()), f"{tag} loglik not finite near the "
                                         "MLE")
    return rough[2]


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _fit(tag, f, steps) -> dict:
    """A short L-BFGS ``fit_mle`` from l=2, sig=1: the MLE ``{l, sig}``."""
    from pymra_torch import fit_mle

    fit, wall = _timed(lambda: fit_mle(f, {"l": 2.0, "sig": 1.0},
                                       method="lbfgs", steps=steps))
    print(f"{tag} fit_mle lbfgs {len(fit['history'])} steps from l=2 sig=1 "
          f"in {wall:.2f} s: loglik {-fit['history'][0]!r} -> "
          f"{fit['loglik']!r} at {fit['theta']}")
    check(np.isfinite(fit["loglik"]), f"{tag} fit_mle loglik not finite")
    return fit["theta"]


def smc_prior(x_mle):
    """SMC's prior, a normal of ``SMC_PRIOR_SD`` in log-space around the
    MLE: its log density (of 0-dim leaves, or of a batch of them) and one
    draw from a generator."""
    import torch

    def log_prior(theta):
        return sum(-0.5 * ((theta[k] - x_mle[k]) / SMC_PRIOR_SD) ** 2
                   for k in SAMPLER_PARAMS)

    def prior_sample(g):
        return {k: x_mle[k] + SMC_PRIOR_SD * torch.randn(
            (), generator=g, dtype=torch.float64) for k in SAMPLER_PARAMS}

    return log_prior, prior_sample


def phase_samplers(ms_grad, device="cuda", data="large", r=4, M=4,
                   R=SAMPLER_R, rough_rs=ROUGH_RS, runs=SAMPLER_RUNS,
                   mle_steps=10, timer=time_ms, wrap=None,
                   replay=REPLAY_EVALS) -> dict:
    """NUTS, HMC, ADVI and SMC over the N=10^4 gradient path, and the
    float32 roughness at each R of ``rough_rs``. ``wrap`` (tests) wraps the
    log posterior the samplers see, not the one the checks evaluate."""
    import torch

    from pymra_torch import MRAModel, PlanConfig, load_data
    from pymra_torch.infer import advi, hmc, nuts, smc

    t_phase = time.perf_counter()
    locs, y_obs = load_data(data)
    tag = f"N={len(locs)}"
    print(f"== phase 13: samplers at {tag} (bundled {data}, r={r}, M={M}, "
          f"R={R}; theta = log l, log sig of the exponential kernel, priors "
          f"N(0, {PRIOR_SD:g}^2))")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    f = model.loglik_fn(y, R, kernel_builder=exponential_builder)
    logp = log_posterior(f)
    target = wrap(logp) if wrap else logp
    mle = _fit(tag, f, mle_steps)
    x_mle = {"log_l": float(np.log(mle["l"])),
             "log_sig": float(np.log(mle["sig"]))}
    # value and gradient alone near the MLE, where the samplers evaluate
    ls = iter(mle["l"] * np.exp(np.linspace(-0.01, 0.01, 6)))
    ms_mle = timer(lambda: value_and_grad(f, float(next(ls)), mle["sig"]),
                   reps=5)
    print(f"{tag} value and gradient near the MLE: {ms_mle:.3f} ms/eval (5 "
          f"evals; {ms_grad:.3f} at l in [1.5, 2.5], phase 7)")
    gen = torch.Generator().manual_seed(0)

    def init(chains):
        return {k: x_mle[k] + 0.01 * torch.randn(chains, generator=gen,
                                                 dtype=torch.float64)
                for k in SAMPLER_PARAMS}

    # phase 13d runs the same samplers batched on this model, from the same
    # start and generators
    out = {"mle": mle, "model": model, "y": y, "x_mle": x_mle, "results": {}}
    kw = dict(runs["nuts"])
    chains = kw.pop("chains")
    counter = CountingLogProb(target)
    res, wall = _timed(lambda: nuts(counter, init(chains), gen, **kw))
    out["results"]["nuts"] = res
    out["nuts"] = _chain_report(
        "NUTS", res, chains * (kw["num_warmup"] + kw["num_samples"]),
        counter, wall, ms_mle, logp, x_mle, replay, res.num_divergent)
    depths = np.bincount(res.tree_depth.numpy().ravel(),
                         minlength=kw["max_depth"] + 1)
    out["nuts"].update(depth_histogram=depths.tolist(),
                       divergent=int(res.num_divergent.sum()))
    print(f"NUTS: tree depths {dict(enumerate(depths.tolist()))}, "
          f"divergent {out['nuts']['divergent']} of {chains * kw['num_samples']}")
    lo, hi = ACCEPT_RANGE
    check(lo <= out["nuts"]["accept"] <= hi, f"NUTS mean acceptance "
          f"{out['nuts']['accept']} outside [{lo}, {hi}]")

    kw = dict(runs["hmc"])
    chains = kw.pop("chains")
    counter = CountingLogProb(target)
    res, wall = _timed(lambda: hmc(counter, init(chains), gen, **kw))
    out["results"]["hmc"] = res
    out["hmc"] = _chain_report(
        "HMC", res, chains * (kw["num_warmup"] + kw["num_samples"]),
        counter, wall, ms_mle, logp, x_mle, replay)

    counter = CountingLogProb(target)
    res, wall = _timed(lambda: advi(
        counter, {k: torch.tensor(x_mle[k], dtype=torch.float64)
                  for k in SAMPLER_PARAMS}, gen, **runs["advi"]))
    out["results"]["advi"] = res
    hist = res.elbo_history.numpy()
    check(bool(np.isfinite(hist).all()), "ADVI ELBO history not finite")
    out["advi"] = {"wall_s": wall, "evals": counter.calls,
                   "elbo_last": float(hist[-1]),
                   "mean": {k: float(v) for k, v in res.mean.items()},
                   "sd": {k: float(v) for k, v in res.sd.items()}}
    print(f"ADVI: {len(hist)} steps, {counter.calls} evaluations in "
          f"{wall:.2f} s ({1e3 * wall / counter.calls:.3f} ms each); ELBO "
          f"{float(hist[0])!r} -> {float(hist[-1])!r}; mean {out['advi']['mean']} sd "
          f"{out['advi']['sd']}")

    def log_like(theta):
        return f(natural(theta))

    log_prior, prior_sample = smc_prior(x_mle)
    counter = CountingLogProb(log_like)
    res, wall = _timed(lambda: smc(counter, log_prior, prior_sample, gen,
                                   **runs["smc"]))
    out["results"]["smc"] = res
    check(bool(np.isfinite(float(res.log_evidence))),
          f"SMC log-evidence {float(res.log_evidence)} not finite")
    out["smc"] = {"wall_s": wall, "evals": counter.calls,
                  "log_evidence": float(res.log_evidence),
                  "betas": res.betas.tolist(),
                  "acc_rates": res.acc_rates.tolist()}
    print(f"SMC: {runs['smc']['n_particles']} particles, {counter.calls} "
          f"evaluations in {wall:.2f} s ({1e3 * wall / counter.calls:.3f} "
          f"ms each); prior N(MLE, {SMC_PRIOR_SD:g}^2); log-evidence "
          f"{out['smc']['log_evidence']!r}; betas "
          f"{[round(b, 6) for b in out['smc']['betas']]}; acceptance "
          f"{[round(a, 3) for a in out['smc']['acc_rates']]}")

    out["ms_grad_mle"] = ms_mle
    out["roughness"] = {}
    for rr in rough_rs:
        f_r, mle_r = f, mle
        if rr != R:
            f_r = model.loglik_fn(y, rr, kernel_builder=exponential_builder)
            mle_r = _fit(f"{tag} R={rr}", f_r, mle_steps)
        sd = conditional_sd(f_r, mle_r)
        out["roughness"][rr] = {"sd": sd, "mle": mle_r, "roughness": roughness(
            f"{tag} R={rr}", f_r, mle_r, sd)}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13 wall time {out['wall_s']:.1f} s")
    return out


def phase_nuts_n1m(n1m, theta0, ms_grad, device="cuda", R=1e-2,
                   run=N1M_NUTS, timer=time_ms,
                   replay=N1M_REPLAY_EVALS) -> dict:
    """A short NUTS on phase 5's N=10^6 plan and data from phase 8's fit;
    gated on finite draws and log_prob only."""
    import torch

    from pymra_torch.infer import nuts

    model, y = n1m["model"], n1m["y"]
    n = model.dplan.n_locs
    tag = f"N={n}"
    print(f"== phase 13b: NUTS at {tag} (phase 5's grid and data, R={R}, "
          f"from phase 8's fit {theta0})")
    t_phase = time.perf_counter()
    f = model.loglik_fn(y, R, kernel_builder=exponential_builder)
    logp = log_posterior(f)
    ls = iter(theta0["l"] * np.exp(np.linspace(-0.01, 0.01, 4)))
    ms_start = timer(lambda: value_and_grad(f, float(next(ls)),
                                            theta0["sig"]), reps=3)
    print(f"{tag} value and gradient near the start: {ms_start:.3f} ms/eval "
          f"(3 evals; {ms_grad:.3f} at l in [0.04, 0.06], phase 8)")
    gen = torch.Generator().manual_seed(1)
    kw = dict(run)
    chains = kw.pop("chains")
    init = {k: float(np.log(theta0[k[4:]])) + 1e-3 * torch.randn(
        chains, generator=gen, dtype=torch.float64) for k in SAMPLER_PARAMS}
    counter = CountingLogProb(logp)
    res, wall = _timed(lambda: nuts(counter, init, gen, **kw))
    transitions = chains * (kw["num_warmup"] + kw["num_samples"])
    check(bool(np.isfinite(_draws(res)).all()), f"{tag} NUTS draws not "
                                                "finite")
    check(bool(np.isfinite(res.log_prob.numpy()).all()),
          f"{tag} NUTS log_prob not finite")
    depths = np.bincount(res.tree_depth.numpy().ravel(),
                         minlength=kw["max_depth"] + 1)
    alone, spread = replay_ms(logp, counter, replay)
    out = {"wall_s": wall, "ms_per_draw": 1e3 * wall / transitions,
           "evals_per_draw": counter.calls / transitions,
           "ms_per_eval": 1e3 * wall / counter.calls, "ms_grad": ms_start,
           "ms_per_eval_alone": alone, "alone_spread_ms": spread,
           "host_ms_per_eval": 1e3 * wall / counter.calls - alone,
           "accept": float(res.accept_rate.mean()),
           "divergent": int(res.num_divergent.sum()),
           "step_size": res.step_size.tolist(),
           "depth_histogram": depths.tolist()}
    print(f"{tag} NUTS: {chains} chains x {transitions // chains} "
          f"transitions in {wall:.2f} s: {out['ms_per_draw']:.3f} ms per "
          f"draw, {out['evals_per_draw']:.3f} evaluations per draw, "
          f"{out['ms_per_eval']:.3f} ms per evaluation against "
          f"{alone:.3f} alone at {min(replay, len(counter.seen))} of its "
          f"points (host clock; halves differ by {spread:.3f} ms; host cost "
          f"{out['host_ms_per_eval']:.3f} ms), "
          f"{ms_start:.3f} near the start by CUDA events; accept "
          f"{out['accept']:.4f}, "
          f"divergent {out['divergent']} of {chains * kw['num_samples']}, "
          f"step sizes {[round(v, 8) for v in out['step_size']]}, tree "
          f"depths {dict(enumerate(depths.tolist()))}")
    sd = conditional_sd(f, theta0)
    out["cond_sd"] = sd
    out["roughness"] = roughness(tag, f, theta0, sd)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13b wall time {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 13c-13e: parameter sets batched through one sweep
# ---------------------------------------------------------------------------

#: phase 13c: the parameter sets batched at each tree (R = SAMPLER_R), and
#: the batched loglik and gradient against the same sets evaluated one at a
#: time on the card, within phase 20's limits (the batch changes nothing but
#: rounding: the kernels' members are independent, the matmuls' batches and
#: the sums' lengths change)
BATCH_N10K = {"l": (1.5, 2.0, 2.5, 3.0), "sig": (1.0, 1.2, 0.8, 1.1)}
BATCH_N1M = {"l": (0.04, 0.05, 0.06, 0.045), "sig": (1.0, 1.1, 0.9, 1.2)}
BATCH_OBJ_RTOL = 1e-5
BATCH_GRAD_RTOL = 1e-4
#: phase 13e: phase 13b's run with this many chains in lockstep
N1M_BATCHED_NUTS = {**N1M_NUTS, "chains": 4}


def batched_value_and_grad(f, sets):
    """``f`` (a batched ``loglik_fn``) at the parameter sets ``{l: [C],
    sig: [C]}`` and its gradient: ``(values [C], {k: [C]})``, read back."""
    import torch

    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in sets.items()}
    value = f(theta)
    value.sum().backward()
    return (value.detach().cpu().numpy(),
            {k: t.grad.numpy() for k, t in theta.items()})


def _launch_snapshot():
    from pymra_torch.ops import linalg as tl

    return {n: launches_of(tl, n) for n in KERNEL_NAMES}


def _check_batch(tag, model, y, R, sets, device, timer, n_evals) -> dict:
    """The batched value and gradient at ``sets`` against each set alone;
    launches per batched evaluation against one single evaluation's; ms per
    evaluation of both; peak memory of the batched evaluation."""
    C = len(sets["l"])
    f = model.loglik_fn(y, R, kernel_builder=exponential_builder)
    fb = model.loglik_fn(y, R, kernel_builder=exponential_builder,
                         batched=True)
    value_and_grad(f, sets["l"][0], sets["sig"][0])  # warm-up, uncounted
    before = _launch_snapshot()
    singles = [value_and_grad(f, sets["l"][c], sets["sig"][c])
               for c in range(C)]
    mid = _launch_snapshot()
    _reset_peak(device)
    values, grads = batched_value_and_grad(fb, sets)
    peak = _peak_gib(device)
    after = _launch_snapshot()
    per_single = {n: (mid[n] - before[n]) / C for n in KERNEL_NAMES}
    per_batch = {n: after[n] - mid[n] for n in KERNEL_NAMES}
    print(f"{tag} kernel launches per evaluation: one set alone "
          f"{ {n: v for n, v in per_single.items() if v} }, {C} sets batched "
          f"{ {n: v for n, v in per_batch.items() if v} }")
    check(per_batch == per_single, f"{tag}: the batch of {C} launched "
          f"{per_batch}, one set alone {per_single}")
    worst = {"value": 0.0, "grad": 0.0}
    for c, (v1, g1) in enumerate(singles):
        worst["value"] = max(worst["value"], abs(values[c] - v1) / abs(v1))
        for k in ("l", "sig"):
            worst["grad"] = max(worst["grad"],
                                abs(grads[k][c] - g1[k]) / abs(g1[k]))
    print(f"{tag} batched C={C} against each set alone: loglik rel diff "
          f"{worst['value']:.3g} (limit {BATCH_OBJ_RTOL}), gradient "
          f"{worst['grad']:.3g} (limit {BATCH_GRAD_RTOL}); loglik "
          f"{[round(float(v), 3) for v in values]}")
    check(worst["value"] <= BATCH_OBJ_RTOL,
          f"{tag}: batched loglik off the single evaluations by "
          f"{worst['value']:.3g}")
    check(worst["grad"] <= BATCH_GRAD_RTOL,
          f"{tag}: batched gradient off the single evaluations by "
          f"{worst['grad']:.3g}")
    shifts = iter(np.exp(np.linspace(-0.01, 0.01, n_evals + 1)))

    def batch_call():
        t = next(shifts)
        batched_value_and_grad(fb, {"l": [l * t for l in sets["l"]],
                                    "sig": sets["sig"]})

    ms_batch = timer(batch_call, reps=n_evals)
    ls = iter(sets["l"][0] * np.exp(np.linspace(-0.01, 0.01, n_evals + 1)))
    ms_single = timer(lambda: value_and_grad(f, float(next(ls)),
                                             sets["sig"][0]), reps=n_evals)
    print(f"{tag} value and gradient: {ms_batch:.3f} ms per batched "
          f"evaluation of {C} sets against {ms_single:.3f} ms for one set "
          f"alone ({C} alone: {C * ms_single:.3f}; {n_evals} evals each); "
          f"{C * ms_single / ms_batch:.2f}x; peak device memory of the "
          f"batched evaluation {peak:.2f} GiB")
    return {"ms_batch": ms_batch, "ms_single": ms_single, "peak": peak,
            "worst": worst, "launches": per_batch, "values": values.tolist(),
            "grads": {k: v.tolist() for k, v in grads.items()}}


def phase_batched(n1m, device="cuda", timer=time_ms, data="large", r=4,
                  M=4, R=SAMPLER_R, n_evals=5, sets_n10k=BATCH_N10K,
                  sets_n1m=BATCH_N1M) -> dict:
    """Phase 13c: ``loglik_fn(..., batched=True)`` at C parameter sets on
    phase 4's N=10^4 tree and phase 5's N=10^6 plan and data."""
    import torch

    from pymra_torch import MRAModel, PlanConfig, load_data

    locs, y_obs = load_data(data)
    print(f"== phase 13c: {len(sets_n10k['l'])} parameter sets batched "
          f"through one sweep at N={len(locs)} (bundled {data}, r={r}, "
          f"M={M}) and N={n1m['model'].dplan.n_locs} (phase 5), R={R}")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    out = {"n10k": _check_batch(f"N={len(locs)}", model, y, R, sets_n10k,
                                device, timer, n_evals)}
    out["n1m"] = _check_batch(f"N={n1m['model'].dplan.n_locs}",
                              n1m["model"], n1m["y"], R, sets_n1m, device,
                              timer, n_evals)
    return out


def batched_kernel(sets, device="cpu"):
    """The exponential kernel at the parameter sets ``{l: [C], sig: [C]}``
    (float64 leaves; ``Kernel`` rounds them to the sweep's dtype)."""
    import torch

    from pymra_torch import Kernel

    return Kernel("exponential", **{
        k: torch.tensor(v, dtype=torch.float64, device=device)
        for k, v in sets.items()})


def _set_of(sets, c):
    return {k: v[c] for k, v in sets.items()}


def _moments_off(tag, got, want, limits) -> dict:
    """Each posterior moment of ``got`` against ``want`` (``{mean, var}``
    arrays ``[..., N]``): max |diff| relative to the largest magnitude of
    ``want``'s set (its last axis), within ``limits[name]``; returns the
    max and the median."""
    out = {}
    for name in ("mean", "var"):
        a = np.asarray(got[name], dtype=np.float64)
        b = np.asarray(want[name], dtype=np.float64)
        check(a.shape == b.shape and bool(np.isfinite(a).all()),
              f"{tag} posterior {name}: shape {a.shape} against {b.shape}, "
              "or not finite")
        d = np.abs(a - b) / np.maximum(np.abs(b).max(-1, keepdims=True),
                                       1e-30)
        out[name] = (float(d.max()), float(np.median(d)))
        print(f"{tag} posterior {name}: max |diff| {out[name][0]:.3g} of "
              f"its largest magnitude, median {out[name][1]:.3g} (limit "
              f"{limits[name]})")
        check(out[name][0] <= limits[name],
              f"{tag} posterior {name} off by {out[name][0]:.3g}")
    return out


def _host(res) -> dict:
    """A sweep result's moments as float64 numpy arrays."""
    return {k: getattr(res, k).detach().cpu().double().numpy()
            for k in ("mean", "var")}


def _check_posterior_batch(tag, model, y, R, sets, golden, device, timer,
                           dev_timer, n_evals, exact=None) -> dict:
    """The batched posterior sweep at ``sets`` against each set alone:
    objective (the golden's set also against ``golden``), mean and var;
    launches per batched evaluation against one single evaluation's; ms of
    both, the batch's device time and peak memory. With ``exact`` (a
    float64 host model on the same plan, and ``y`` there) the batch and
    each set alone are held to that set's float64 result instead (see
    ``F64_POST_RTOL``), their difference reported."""
    import torch

    from pymra_torch import Kernel

    C = len(sets["l"])
    g = sets["l"].index(golden[0])

    def single(c, t=1.0):
        return model.sweep(Kernel("exponential", l=sets["l"][c] * t,
                                  sig=sets["sig"][c]), y, R)

    def batch(t=1.0):
        return model.sweep(batched_kernel(
            {"l": [l * t for l in sets["l"]], "sig": sets["sig"]}), y, R)

    single(0)  # warm-up, uncounted
    before = _launch_snapshot()
    singles = [_host(r) | {"objective": float(r.objective)}
               for r in (single(c) for c in range(C))]
    mid = _launch_snapshot()
    _reset_peak(device)
    res = batch()
    objective = res.objective.detach().cpu().double().numpy()
    peak = _peak_gib(device)
    after = _launch_snapshot()
    per_single = {n: (mid[n] - before[n]) / C for n in KERNEL_NAMES}
    per_batch = {n: after[n] - mid[n] for n in KERNEL_NAMES}
    print(f"{tag} kernel launches per posterior evaluation: one set alone "
          f"{ {n: v for n, v in per_single.items() if v} }, {C} sets batched "
          f"{ {n: v for n, v in per_batch.items() if v} }")
    check(per_batch == per_single, f"{tag}: the batch of {C} launched "
          f"{per_batch}, one set alone {per_single}")
    n = model.dplan.n_locs
    check(objective.shape == (C,) and tuple(res.mean.shape) == (C, n)
          and bool((res.var > 0).all()),
          f"{tag}: objective {objective.shape}, mean "
          f"{tuple(res.mean.shape)} (expected ({C},), ({C}, {n})), or a "
          "variance not positive")
    _anchor(f"{tag} batched set {g}", float(objective[g]), golden[1])
    obj = max(abs(objective[c] - o["objective"]) / abs(o["objective"])
              for c, o in enumerate(singles))
    got = _host(res)
    alone = {k: np.stack([o[k] for o in singles]) for k in ("mean", "var")}
    if exact is None:
        print(f"{tag} batched C={C} objective against each set alone: rel "
              f"diff {obj:.3g} (limit {BATCH_OBJ_RTOL}); objectives "
              f"{[round(float(v), 3) for v in objective]}")
        check(obj <= BATCH_OBJ_RTOL, f"{tag}: batched objective off the "
                                     f"single evaluations by {obj:.3g}")
        moments = _moments_off(f"{tag} batched against each set alone",
                               got, alone, SHARD_POST_RTOL)
    else:
        model64, y64 = exact
        f64 = [model64.sweep(Kernel("exponential", l=sets["l"][c],
                                    sig=sets["sig"][c]), y64, R)
               for c in range(C)]
        want = {k: np.stack([getattr(r, k).numpy() for r in f64])
                for k in ("mean", "var")}
        for name, values in (("batched", objective),
                             ("alone", [o["objective"] for o in singles])):
            worst = max(abs(values[c] - float(r.objective))
                        / abs(float(r.objective)) for c, r in enumerate(f64))
            print(f"{tag} {name} objective against each set's float64: rel "
                  f"diff {worst:.3g} (limit {ANCHOR_RTOL})")
            check(worst <= ANCHOR_RTOL, f"{tag}: {name} objective off "
                                        f"float64 by {worst:.3g}")
        print(f"{tag} batched C={C} objective against each set alone: rel "
              f"diff {obj:.3g} (reported; see F64_POST_RTOL); objectives "
              f"{[round(float(v), 3) for v in objective]}")
        moments = _moments_off(f"{tag} batched against float64", got, want,
                               F64_POST_RTOL)
        _moments_off(f"{tag} alone against float64", alone, want,
                     F64_POST_RTOL)
        d = {k: float((np.abs(got[k] - alone[k]) / np.abs(alone[k]).max(
            -1, keepdims=True)).max()) for k in ("mean", "var")}
        print(f"{tag} posterior batched against alone: max |diff| {d} of "
              "the set's largest magnitude (reported)")
    shifts = np.exp(np.linspace(-0.01, 0.01, n_evals + 1))
    it = iter(shifts)
    ms_batch = timer(lambda: batch(float(next(it))), reps=n_evals)
    it = iter(shifts)
    ms_single = timer(lambda: single(0, float(next(it))), reps=n_evals)
    dev, _ = dev_timer(lambda: batch(), reps=3)
    busy = (f"{dev:.3f} ms device (torch.profiler, 3 evals), busy "
            f"{100 * dev / ms_batch:.1f}%" if dev is not None
            else "device time not measured")
    print(f"{tag} full likelihood+posterior: {ms_batch:.3f} ms per batched "
          f"evaluation of {C} sets against {ms_single:.3f} ms for one set "
          f"alone ({C} alone: {C * ms_single:.3f}; {n_evals} evals each; "
          f"{C * ms_single / ms_batch:.2f}x); {busy}; peak device memory of "
          f"the batched evaluation {peak:.2f} GiB")
    return {"ms_batch": ms_batch, "ms_single": ms_single, "device_ms": dev,
            "peak": peak, "objective": obj, "moments": moments,
            "launches": per_batch, "mean": got["mean"], "var": got["var"]}


def phase_batched_posterior(n1m, device="cuda", timer=time_ms,
                            dev_timer=device_ms, data="large", r=4, M=4,
                            n_evals=5, sets_n10k=POST_BATCH_N10K,
                            sets_n1m=POST_BATCH_N1M, golden_n10k=GOLDEN_N10K,
                            golden_n1m=GOLDEN_N1M) -> dict:
    """Phase 13f: ``MRAModel.sweep`` with a batched covariance (the
    posterior, the default) at C sets on phase 4's N=10^4 tree (R=1e-4)
    and phase 5's N=10^6 plan and data (R=1e-2)."""
    import torch

    from pymra_torch import MRAModel, PlanConfig, load_data

    locs, y_obs = load_data(data)
    n1 = n1m["model"].dplan.n_locs
    print(f"== phase 13f: the posterior of {len(sets_n10k['l'])} parameter "
          f"sets through one sweep at N={len(locs)} (bundled {data}, r={r}, "
          f"M={M}, R=1e-4, {sets_n10k}) and N={n1} (phase 5, R=1e-2, "
          f"{sets_n1m})")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    exact = MRAModel(locs, r=r, plan=model.plan, dtype=torch.float64,
                     device="cpu")
    out = {"n10k": _check_posterior_batch(
        f"N={len(locs)}", model, y, 1e-4, sets_n10k, (2.0, golden_n10k),
        device, timer, dev_timer, n_evals, exact=(exact, y_obs))}
    out["n1m"] = _check_posterior_batch(
        f"N={n1}", n1m["model"], n1m["y"], 1e-2, sets_n1m,
        (0.05, golden_n1m), device, timer, dev_timer, n_evals)
    return out


def _lockstep_report(tag, res, counter, wall, transitions, serial, serial_res,
                     logp) -> dict:
    """The checks and report of a sampler run in lockstep: each chain's
    last draw against its batch evaluated again, ms per transition of all
    chains and per chain draw beside the serial run's, evaluations per
    transition (batched calls: the largest count among the chains; points:
    the mean over them), and how far the draws follow the serial run's
    with the same generators (float32 rounding may part them)."""
    chains = res.log_prob.shape[0]
    reeval = check_last_draws(tag, res, counter, logp)
    check(bool(np.isfinite(res.log_prob.numpy()).all()),
          f"{tag} log_prob not finite")
    xs, xs_serial = _draws(res), _draws(serial_res)
    same = (res.tree_depth == serial_res.tree_depth).double().mean() if (
        hasattr(res, "tree_depth")) else float("nan")
    out = {"wall_s": wall, "ms_per_transition": 1e3 * wall / transitions,
           "ms_per_draw": 1e3 * wall / (chains * transitions),
           "calls_per_transition": counter.calls / transitions,
           "evals_per_draw": counter.rows / (chains * transitions),
           "ms_per_call": 1e3 * wall / counter.calls,
           "accept": float(res.accept_rate.mean()), "reeval_rel": reeval,
           "same_depths": float(same),
           "max_draw_diff": float(np.abs(xs - xs_serial).max()),
           "serial_ms_per_draw": serial["ms_per_draw"]}
    print(f"{tag}: {chains} chains x {transitions} transitions in lockstep "
          f"in {wall:.2f} s: {out['ms_per_transition']:.3f} ms per "
          f"transition of all chains, {out['ms_per_draw']:.3f} ms per chain "
          f"draw against {serial['ms_per_draw']:.3f} serial (phase 13: "
          f"{serial['ms_per_draw'] / out['ms_per_draw']:.2f}x); "
          f"evaluations per transition: {out['calls_per_transition']:.3f} "
          f"batched calls (the most among the chains), "
          f"{out['evals_per_draw']:.3f} points a chain (serial "
          f"{serial['evals_per_draw']:.3f}); {out['ms_per_call']:.3f} ms per "
          f"batched call; accept {out['accept']:.4f}; last draws against "
          f"their batch evaluated again {reeval:.3g} of |log_prob| (limit "
          f"{REEVAL_RTOL}); against the serial run: tree depths equal "
          f"{out['same_depths']:.3f}, max |draw diff| "
          f"{out['max_draw_diff']:.3g}")
    return out


def phase_samplers_batched(serial, device="cuda", R=SAMPLER_R,
                           runs=SAMPLER_RUNS, wrap=None) -> dict:
    """Phase 13d: phase 13's samplers with ``batched=True`` on its model,
    from its start, run lengths and generator seed: NUTS and HMC chains in
    lockstep, ADVI's draws and SMC's particles in one evaluation; phase
    13's checks. ``wrap`` (tests) wraps the log posterior the samplers see,
    not the one the checks evaluate."""
    import torch

    from pymra_torch.utils.health import check_samples
    from pymra_torch.infer import advi, hmc, nuts, smc

    model, y, x_mle = serial["model"], serial["y"], serial["x_mle"]
    tag = f"N={model.dplan.n_locs}"
    print(f"== phase 13d: phase 13's samplers batched at {tag} (R={R}, the "
          "same starts and generators)")
    t_phase = time.perf_counter()
    f = model.loglik_fn(y, R, kernel_builder=exponential_builder,
                        batched=True)
    logp = log_posterior(f)
    target = wrap(logp) if wrap else logp
    gen = torch.Generator().manual_seed(0)

    def init(chains):
        return {k: x_mle[k] + 0.01 * torch.randn(chains, generator=gen,
                                                 dtype=torch.float64)
                for k in SAMPLER_PARAMS}

    out = {}
    kw = dict(runs["nuts"])
    chains = kw.pop("chains")
    T = kw["num_warmup"] + kw["num_samples"]
    counter = CountingLogProb(target)
    res, wall = _timed(lambda: nuts(counter, init(chains), gen, batched=True,
                                    **kw))
    out["nuts"] = _lockstep_report("NUTS batched", res, counter, wall, T,
                                   serial["nuts"], serial["results"]["nuts"],
                                   logp)
    rep = check_samples(res.samples, res.num_divergent,
                        max_divergence_rate=MAX_DIVERGENCE_RATE)
    check(rep.ok, f"NUTS batched draws: {rep}")
    lo, hi = ACCEPT_RANGE
    check(lo <= out["nuts"]["accept"] <= hi, f"NUTS batched mean acceptance "
          f"{out['nuts']['accept']} outside [{lo}, {hi}]")

    kw = dict(runs["hmc"])
    chains = kw.pop("chains")
    T = kw["num_warmup"] + kw["num_samples"]
    counter = CountingLogProb(target)
    res, wall = _timed(lambda: hmc(counter, init(chains), gen, batched=True,
                                   **kw))
    out["hmc"] = _lockstep_report("HMC batched", res, counter, wall, T,
                                  serial["hmc"], serial["results"]["hmc"],
                                  logp)
    rep = check_samples(res.samples, max_divergence_rate=MAX_DIVERGENCE_RATE)
    check(rep.ok, f"HMC batched draws: {rep}")

    counter = CountingLogProb(target)
    res, wall = _timed(lambda: advi(
        counter, {k: torch.tensor(x_mle[k], dtype=torch.float64)
                  for k in SAMPLER_PARAMS}, gen, batched=True,
        **runs["advi"]))
    hist = res.elbo_history.numpy()
    check(bool(np.isfinite(hist).all()), "ADVI batched ELBO not finite")
    ser = serial["results"]["advi"].elbo_history.numpy()
    out["advi"] = {"wall_s": wall, "calls": counter.calls,
                   "elbo_last": float(hist[-1]),
                   "max_elbo_diff": float(np.abs(hist - ser).max())}
    print(f"ADVI batched: {len(hist)} steps, {counter.calls} evaluations of "
          f"{runs['advi']['num_mc']} draws in {wall:.2f} s "
          f"({1e3 * wall / counter.calls:.3f} ms each; serial "
          f"{1e3 * serial['advi']['wall_s'] / serial['advi']['evals']:.3f} "
          f"ms a draw); ELBO {float(hist[-1])!r} (serial {float(ser[-1])!r},"
          f" max diff {out['advi']['max_elbo_diff']:.3g})")

    log_prior, prior_sample = smc_prior(x_mle)
    counter = CountingLogProb(lambda theta: f(natural(theta)))
    res, wall = _timed(lambda: smc(counter, log_prior, prior_sample, gen,
                                   batched=True, **runs["smc"]))
    check(bool(np.isfinite(float(res.log_evidence))),
          f"SMC batched log-evidence {float(res.log_evidence)} not finite")
    ser = serial["results"]["smc"]
    out["smc"] = {"wall_s": wall, "calls": counter.calls,
                  "log_evidence": float(res.log_evidence)}
    print(f"SMC batched: {runs['smc']['n_particles']} particles, "
          f"{counter.calls} evaluations of all particles in {wall:.2f} s "
          f"({1e3 * wall / counter.calls:.3f} ms each; serial "
          f"{serial['smc']['wall_s']:.2f} s for {serial['smc']['evals']}); "
          f"log-evidence {out['smc']['log_evidence']!r} (serial "
          f"{float(ser.log_evidence)!r}); betas "
          f"{[round(b, 6) for b in res.betas.tolist()]}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13d wall time {out['wall_s']:.1f} s")
    return out


def phase_nuts_n1m_batched(n1m, theta0, serial, device="cuda", R=1e-2,
                           run=N1M_BATCHED_NUTS) -> dict:
    """Phase 13e: phase 13b's NUTS with its chains in lockstep on phase
    5's N=10^6 plan and data: finite draws, the last draws against their
    batch evaluated again, ms per draw beside phase 13b's, evaluations per
    transition, peak memory."""
    import torch

    from pymra_torch.infer import nuts

    model, y = n1m["model"], n1m["y"]
    tag = f"N={model.dplan.n_locs}"
    kw = dict(run)
    chains = kw.pop("chains")
    T = kw["num_warmup"] + kw["num_samples"]
    print(f"== phase 13e: NUTS batched at {tag}, {chains} chains in lockstep "
          f"({kw}, R={R}, from phase 8's fit {theta0})")
    f = model.loglik_fn(y, R, kernel_builder=exponential_builder,
                        batched=True)
    logp = log_posterior(f)
    gen = torch.Generator().manual_seed(1)
    init = {k: float(np.log(theta0[k[4:]])) + 1e-3 * torch.randn(
        chains, generator=gen, dtype=torch.float64) for k in SAMPLER_PARAMS}
    counter = CountingLogProb(logp)
    _reset_peak(device)
    res, wall = _timed(lambda: nuts(counter, init, gen, batched=True, **kw))
    peak = _peak_gib(device)
    check(bool(np.isfinite(_draws(res)).all()), f"{tag} NUTS batched draws "
                                                "not finite")
    check(bool(np.isfinite(res.log_prob.numpy()).all()),
          f"{tag} NUTS batched log_prob not finite")
    reeval = check_last_draws(f"{tag} NUTS batched", res, counter, logp)
    depths = np.bincount(res.tree_depth.numpy().ravel(),
                         minlength=kw["max_depth"] + 1)
    out = {"wall_s": wall, "ms_per_transition": 1e3 * wall / T,
           "ms_per_draw": 1e3 * wall / (chains * T),
           "calls_per_transition": counter.calls / T,
           "evals_per_draw": counter.rows / (chains * T),
           "ms_per_call": 1e3 * wall / counter.calls, "peak": peak,
           "accept": float(res.accept_rate.mean()),
           "divergent": int(res.num_divergent.sum()), "reeval_rel": reeval,
           "depth_histogram": depths.tolist()}
    print(f"{tag} NUTS batched: {chains} chains x {T} transitions in "
          f"{wall:.2f} s: {out['ms_per_transition']:.3f} ms per transition "
          f"of all chains, {out['ms_per_draw']:.3f} ms per chain draw "
          f"(phase 13b serial, {N1M_NUTS['chains']} chains: "
          f"{serial['ms_per_draw']:.3f}); {out['calls_per_transition']:.3f} "
          f"batched calls per transition, {out['evals_per_draw']:.3f} points "
          f"a chain (13b: {serial['evals_per_draw']:.3f}); "
          f"{out['ms_per_call']:.3f} ms per batched call; peak device memory "
          f"{peak:.2f} GiB; accept {out['accept']:.4f}, divergent "
          f"{out['divergent']} of {chains * kw['num_samples']}, tree depths "
          f"{dict(enumerate(depths.tolist()))}; last draws against their "
          f"batch evaluated again {reeval:.3g} (limit {REEVAL_RTOL})")
    return out


# ---------------------------------------------------------------------------
# phases 15-19: the side paths — a dense covariance matrix, general-nu
# Matern, keep_internals with the basis matrices, the triangular leaf route
# ---------------------------------------------------------------------------

#: phase 16's Matern smoothness, and the float64 objective and gradient
#: (l=2, sig=1) of the N=10^4 tree under it at each measurement error, from
#: the JAX package with jitter 0 (``tools/golden_matern_n10k.py``)
MATERN_NU = 0.8
GOLDEN_MATERN_N10K = {
    1e-2: {"objective": 96376.07112857478, "l": -14391.265102098578,
           "sig": 18013.959397506536},
    1e-4: {"objective": 1939358.5836223047, "l": -539220.3146021592,
           "sig": 674103.619413083},
}
#: phase 16 holds the Matern at this R. At R=1e-4 the float32 sweep is
#: 4.1e-3 off the objective and 6.9e-3 / 7.0e-3 off the gradient on the CPU
#: twins, and 4.0e-3 with the covariance taken in float64 and rounded once:
#: the sweep's float32 conditioning, not kv_frac (whose float32 values are
#: within 1.9e-6 of float64 on these distances). The phase reports R=1e-4
#: unchecked
MATERN_R = 1e-2
#: phase 17: the keep_internals sweep's posterior against the default
#: (fused) sweep's: each is within 0.0453 / 0.0517 (mean) and 8.40e-5 /
#: 8.40e-5 (var) of the float64 sweep on the CPU twins at N=10^4, so the two
#: may differ by their sum, here rounded up
KEEP_MEAN_ATOL, KEEP_VAR_ATOL = 0.1, 2e-4
#: the posterior basis matrix's row sums of squares against the
#: keep_internals sweep's var: 1.68e-7 on the CPU twins at N=10^4 (float32
#: solves of the sweep against the float64 assembly from the same stash)
BASIS_VAR_ATOL = 2e-6
#: getB_lk (a dense float32 solve against the joint ancestor knots) against
#: the sweep's ancestor basis block, relative to its largest entry: 4.2e-6
#: on the CPU twins at N=10^4
B_LK_RTOL = 1e-3
#: phase 15: setPrior's objective against a tree built with the same matrix
#: (the same computation on the same plan: equal on the CPU twins)
SET_PRIOR_RTOL = 1e-6
#: where phase 17 writes its drawing
OUT_DIR = "chiprun_out"
#: the leaf routes of phase 18: the default (``auto``: the inverse route at
#: the bench trees' leaves) and the triangular one
ROUTES = ("auto", "tri")
#: kernels phases 15-18 must launch: K1 (matrix-covariance and Matern
#: sweeps), K2 (keep_internals leaves, the triangular route), K3
#: (keep_internals), K5 and K6 (the triangular route), KP's pullback mode
#: (K2's backward at the triangular route's leaves, 256 x 49)
SIDE_KERNELS = ("leaf_factor", "cholesky_jittered",
                "triangular_inverse_lower", "solve_triangular_batched",
                "cholesky_logdet", "cholesky_pullback_tile")
#: kernels the N=10^6 triangular route (phase 18b) must launch: its
#: forward's, and in its value and gradient KP at the interior levels and
#: KP's pullback mode at the leaves (16384 x 64)
TRI_KERNELS = ("cholesky_jittered", "solve_triangular_batched",
               "cholesky_logdet", "cholesky_pullback", "cholesky_pullback_tile")


@contextlib.contextmanager
def leaf_route(mode: str):
    """The sweep's leaf route (the port's flag ``PYMRA_LEAF_SOLVE``) for
    the block."""
    old = os.environ.get("PYMRA_LEAF_SOLVE")
    os.environ["PYMRA_LEAF_SOLVE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["PYMRA_LEAF_SOLVE"]
        else:
            os.environ["PYMRA_LEAF_SOLVE"] = old


def _reset_peak(device):
    import torch

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device) -> float:
    import torch

    return (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else float("nan"))


def _rel(tag, got, want, limit):
    rel = abs(got - want) / abs(want)
    print(f"{tag}: {got!r} against {want!r}, rel diff {rel:.3g} (limit "
          f"{limit})")
    check(rel <= limit, f"{tag}: rel diff {rel:.3g}")


def _posterior_finite(tag, res, n):
    import torch

    for name, v in (("mean", res.mean), ("var", res.var)):
        check(tuple(v.shape) == (n,) and bool(torch.isfinite(v).all()),
              f"{tag} posterior {name} not finite of shape [{n}]")


def _tree(data, r, M, cov, R, device):
    """``MRATree`` on a bundled dataset in float32."""
    import torch

    from pymra_torch import MRATree, load_data

    locs, y_obs = load_data(data)
    return MRATree(locs, r, cov, y_obs, R, M=M, dtype=torch.float32,
                   device=device)


def dense_sigma(locs, device, l=2.0):
    """The exponential covariance at ``locs`` as an ``[N, N]`` matrix:
    formed in float64 on the host, moved to ``device`` as float32."""
    import torch

    from pymra_torch import Kernel

    s = torch.as_tensor(np.asarray(locs), dtype=torch.float64)
    return Kernel("exponential", l=l)(s).to(device, torch.float32)


def phase_matrix_cov(device="cuda", timer=time_ms, n_evals=10,
                     data="large", r=4, M=4, R=1e-4, golden=GOLDEN_N10K,
                     ms_coord=None, sigma_of=dense_sigma):
    """A dense covariance matrix through ``MRATree`` (index mode,
    ``MatrixKernel``) and ``setPrior``; ``sigma_of(locs, device)`` gives
    the matrix."""
    import torch

    from pymra_torch import Kernel, MatrixKernel, MRAModel, load_data
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs

    t_phase = time.perf_counter()
    _reset_peak(device)
    tree = _tree(data, r, M, sigma_of(load_data(data)[0], device), R,
                 device)
    model, n = tree.model, tree.model.plan.n_locs
    tag = f"matrix covariance N={n}"
    print(f"== phase 15: a dense covariance matrix at N={n} (bundled {data},"
          f" r={r}, M={M}, the exponential l=2 as an [N, N] float32 matrix "
          f"on the card, R={R})")
    points = model.dplan.levels[-1].leaf_locs
    check(model.index_mode and isinstance(tree.cov, MatrixKernel)
          and points.dtype == torch.long and points.shape[-1] == 1,
          f"{tag}: the tree did not plan location indices")
    _anchor(tag, tree.getLikelihood(), golden)
    coord = _tree(data, r, M, Kernel("exponential", l=2.0), R, device)
    coord_model = coord.model
    _rel(f"{tag} objective against the coordinate path's",
         tree.getLikelihood(), coord.getLikelihood(), ANCHOR_RTOL)
    mean, sd = tree.predict()
    check(bool(np.isfinite(mean).all() and np.isfinite(sd).all()),
          f"{tag}: posterior not finite")

    # setPrior on the coordinate tree re-plans it in index mode on its
    # plan; as in the JAX package's test, the result must move and equal a
    # tree built with the scaled matrix (the same computation)
    plan, before = coord.model.plan, coord.getLikelihood()
    coord.setPrior(Sigma=2.0 * tree.cov.matrix)
    check(coord.model.index_mode and coord.model.plan is plan,
          f"{tag}: setPrior did not re-plan in index mode on the tree's plan")
    after = coord.getLikelihood()
    check(after != before, f"{tag}: setPrior left the objective {before}")
    direct = _tree(data, r, M, 2.0 * tree.cov.matrix, R, device)
    _rel(f"{tag} setPrior(2 Sigma) against a tree built with 2 Sigma",
         after, direct.getLikelihood(), SET_PRIOR_RTOL)
    del direct
    # against the kernel at sig=2: float64 on the host (the plain
    # structure) and float32 on the card, reported: rounding the matrix's
    # entries to float32 alone moves this tree's objective by up to 1.8e-3
    # at sig=2 and R=1e-4 on the CPU twins
    k2 = Kernel("exponential", l=2.0, sig=2.0)
    f64 = MRAModel(None, r, plan=plan, dtype=torch.float64, device="cpu")
    want = float(f64.objective(k2, coord.obs, R))
    f32 = float(coord_model.objective(k2, coord.obs, R))
    print(f"{tag} setPrior(2 Sigma) {after!r} against the kernel at sig=2 "
          f"(reported): float64 on the host {want!r}, rel diff "
          f"{abs(after - want) / abs(want):.3g}; the coordinate path on the "
          f"card {f32!r}, rel diff {abs(f32 - want) / abs(want):.3g}")
    del coord, coord_model, f64

    y = torch.as_tensor(tree.obs, dtype=torch.float32, device=device)
    prep = prepare_obs(model.dplan, y, R)
    ms = timer(lambda: mra_sweep(model.dplan, tree.cov, None, None,
                                 jitter=model.jitter, prep=prep),
               reps=n_evals)
    peak = _peak_gib(device)
    beside = "" if ms_coord is None else (
        f" (the coordinate path: {ms_coord:.3f} ms/eval, phase 4)")
    print(f"{tag} full likelihood+posterior: {ms:.3f} ms/eval ({n_evals} "
          f"evals){beside}; peak device memory {peak:.2f} GiB (the matrix "
          f"takes {tree.cov.matrix.numel() * 4 / 2**30:.2f}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"ms": ms, "peak": peak}


def matern_builder(theta):
    from pymra_torch import Kernel

    return Kernel("matern", l=theta["l"], sig=theta["sig"], nu=MATERN_NU)


def _recorded(device, dev_timer, fn, reps, what, takes=3):
    """``dev_timer(fn, reps)``, taken up to ``takes`` times on the card
    until a profile recorded every launch of the port's kernels that the
    wrappers counted (``device_ms`` returns no time otherwise); fails where
    none did. On the CPU the one reading as it is."""
    for _ in range(takes if device != "cpu" else 1):
        ms, n = dev_timer(fn, reps)
        if ms is not None or device == "cpu":
            return ms, n
    fail(f"{what}: every one of {takes} profiles missed some of the port's "
         f"kernel launches (the last recorded {n:g} device operations a "
         "call)")


def phase_matern(device="cuda", timer=time_ms, dev_timer=device_ms,
                 n_evals=10, data="large", r=4, M=4, R=MATERN_R,
                 golden=GOLDEN_MATERN_N10K):
    """General-nu Matern (on the card ``matern.cu``) on the N=10^4 tree:
    objective and gradient against their float64 goldens at ``R``, the
    other goldens' R reported; ms per forward and per value and gradient;
    device launches per covariance call and per sweep, beside the
    exponential's."""
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs

    t_phase = time.perf_counter()
    if device != "cpu":
        from pymra_torch.ops import special

        # phase 3d ran the twins on the card on purpose
        special.kv_frac.cuda_calls = special.matern_general.cuda_calls = 0
    locs, y_obs = load_data(data)
    tag = f"Matern nu={MATERN_NU} N={len(locs)}"
    print(f"== phase 16: general-nu Matern at N={len(locs)} (bundled {data}"
          f", r={r}, M={M}, nu={MATERN_NU}, l=2, sig=1, R={R})")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    n_obs = int(np.isfinite(y_obs).sum())
    for rr in [R] + [v for v in golden if v != R]:
        f = model.loglik_fn(y, rr, kernel_builder=matern_builder)
        value, grad = value_and_grad(f, 2.0, 1.0)
        got = {"objective": -2.0 * value - n_obs * np.log(2.0 * np.pi),
               **grad}
        if rr == R:
            _held(f"{tag} R={rr}", got, golden[rr], GRAD_RTOL)
            continue
        rel = {k: abs(v - golden[rr][k]) / abs(golden[rr][k])
               for k, v in got.items()}
        print(f"{tag} R={rr} (reported, not held): "
              + ", ".join(f"{k} {v!r} rel err {rel[k]:.3g}"
                          for k, v in got.items()))
    dplan, jitter = model.dplan, model.jitter
    prep = prepare_obs(dplan, y, R)

    def evaluate(l, name="matern"):
        kw = {"nu": MATERN_NU} if name == "matern" else {}
        return mra_sweep(dplan, Kernel(name, l=l, **kw), None, None,
                         jitter=jitter, prep=prep)

    _posterior_finite(tag, evaluate(2.0), len(locs))
    ls = np.linspace(1.5, 2.5, n_evals + 1)
    ms_fwd = _sweep_timer(evaluate, ls, timer)
    f = model.loglik_fn(y, R, kernel_builder=matern_builder)
    ms_grad = _grad_timer(f, ls, timer)
    ms_fwd_exp = _sweep_timer(lambda l: evaluate(l, "exponential"), ls,
                              timer)
    ms_grad_exp = _grad_timer(model.loglik_fn(y, R, kernel_builder=lambda th:
                                              Kernel("exponential",
                                                     l=th["l"],
                                                     sig=th["sig"])),
                              ls, timer)
    # device launches: one covariance call at the leaves' self-covariance
    # shape, and one sweep, the Matern's beside the exponential's; on the
    # card a profile that missed some of the port's launches is taken
    # again, and the phase fails where every one did
    x = [lvl.leaf_locs for lvl in dplan.levels if lvl.leaf_locs.shape[0]][-1]
    launches = {}
    for name in ("matern", "exponential"):
        kern = Kernel(name, l=2.0, **({"nu": MATERN_NU}
                                      if name == "matern" else {}))
        launches[name] = {
            "covariance": _recorded(device, dev_timer, lambda: kern(x, x),
                                    10, f"{name} covariance call"),
            "sweep": _recorded(device, dev_timer,
                               lambda: evaluate(2.0, name), 2,
                               f"{name} sweep")}
    print(f"{tag} full likelihood+posterior: {ms_fwd:.3f} ms/eval (the "
          f"exponential's {ms_fwd_exp:.3f}); value and gradient: "
          f"{ms_grad:.3f} ms/eval (the exponential's {ms_grad_exp:.3f}) "
          f"({n_evals} evals each, l in [1.5, 2.5])")
    for name, d in launches.items():
        (c_ms, c_n), (s_ms, s_n) = d["covariance"], d["sweep"]
        print(f"{name}: a covariance call at {tuple(x.shape)} x "
              f"{tuple(x.shape)}: {c_n:g} launches (device {_ms(c_ms)}); "
              f"a full sweep {s_n:g} launches (device {_ms(s_ms)})")
    if device != "cpu":
        from pymra_torch.ops import special

        twins = {"kv_frac": special.kv_frac.cuda_calls,
                 "matern_general": special.matern_general.cuda_calls}
        print(f"{tag}: Matern kernel launches {special.matern_cuda.launches}"
              f" forward, {special.matern_cuda.pullback_launches} pullback; "
              f"twin calls on CUDA tensors {twins}")
        check(special.matern_cuda.launches > 0
              and special.matern_cuda.pullback_launches > 0,
              f"{tag}: the Matern kernel never launched")
        check(not any(twins.values()),
              f"{tag}: a Matern twin ran on a CUDA tensor")
    print(f"phase 16 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"ms_fwd": ms_fwd, "ms_grad": ms_grad, "ms_fwd_exp": ms_fwd_exp,
            "ms_grad_exp": ms_grad_exp, "launches": launches}


def phase_keep_internals(device="cuda", timer=time_ms, n_evals=5,
                         data="large", r=4, M=4, R=1e-4, golden=GOLDEN_N10K,
                         out_dir=OUT_DIR):
    """``keep_internals`` (K2 and K3 at the leaves) against the golden and
    the default sweep; the posterior basis matrix against the sweep's var;
    ``getB_lk`` against the sweep's ancestor basis; ``drawBasisFunctions``
    to a file."""
    import importlib.util

    import torch

    from pymra_torch import Kernel
    from pymra_torch.tree.basis import basis_matrix
    from pymra_torch.tree.sweep import mra_sweep

    t_phase = time.perf_counter()
    tree = _tree(data, r, M, Kernel("exponential", l=2.0), R, device)
    model = tree.model
    n = model.plan.n_locs
    tag = f"keep_internals N={n}"
    print(f"== phase 17: keep_internals and the basis matrices at N={n} "
          f"(bundled {data}, r={r}, M={M}, exponential l=2, R={R})")
    y = torch.as_tensor(tree.obs, dtype=torch.float32, device=device)

    def keep():
        return mra_sweep(model.dplan, tree.cov, y, R, jitter=model.jitter,
                         keep_internals=True)

    res, internals = keep()
    check(set(internals) == {"prior_L", "chain_Q", "chain_GG", "leaf",
                             "interior"}, f"{tag}: stash keys {internals}")
    _anchor(tag, float(res.objective), golden)
    _posterior_finite(tag, res, n)
    base = mra_sweep(model.dplan, tree.cov, y, R, jitter=model.jitter)
    for name, limit in (("mean", KEEP_MEAN_ATOL), ("var", KEEP_VAR_ATOL)):
        diff = float((getattr(res, name) - getattr(base, name)).abs().max())
        print(f"{tag} {name} against the default sweep's: max|diff| "
              f"{diff:.3g} (limit {limit})")
        check(diff <= limit, f"{tag} {name} off the default sweep's by "
                             f"{diff:.3g}")
    ms_keep = timer(lambda: keep(), reps=n_evals)
    ms_base = timer(lambda: mra_sweep(model.dplan, tree.cov, y, R,
                                      jitter=model.jitter), reps=n_evals)

    t0 = time.perf_counter()
    B = tree.getBasisFunctionsMatrix("posterior", timesKC=True)
    t_basis = time.perf_counter() - t0
    var = res.var.detach().cpu().double().numpy()
    diff = float(np.abs(np.einsum("ij,ij->i", B, B) - var).max())
    print(f"{tag} posterior basis matrix (timesKC) {B.shape[0]} x "
          f"{B.shape[1]} float64 ({B.nbytes / 2**30:.2f} GiB) in "
          f"{t_basis:.2f} s: row sums of squares against the sweep's var, "
          f"max|diff| {diff:.3g} (limit {BASIS_VAR_ATOL})")
    check(diff <= BASIS_VAR_ATOL, f"{tag} basis row sums off the sweep's "
                                  f"var by {diff:.3g}")
    del B

    m = len(model.dplan.levels) - 1
    leaves = [nd for nd in model.plan.nodes[m] if nd.is_leaf]
    leaf = leaves[0]
    k = m - 1
    got = tree.getB_lk(leaf.node_id, k)
    want = internals["leaf"][m]["Bstack"][0][:leaf.n_locs, k * r:(k + 1) * r]
    want = want.detach().cpu().double().numpy()
    diff = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{tag} getB_lk({leaf.node_id!r}, {k}) {got.shape} against the "
          f"sweep's ancestor basis block: max|diff| / max|block| "
          f"{diff:.3g} (limit {B_LK_RTOL})")
    check(diff <= B_LK_RTOL, f"{tag} getB_lk off the sweep's block by "
                             f"{diff:.3g}")

    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, "phase17_basis_functions")
    if importlib.util.find_spec("matplotlib") is not None:
        figs = tree.drawBasisFunctions(fname=fname)
        print(f"{tag} drawBasisFunctions: {len(figs)} figures, "
              f"{fname}.res*.png")
    else:
        # what drawBasisFunctions plots: the resolutions of at most 36
        # prior basis functions
        mats = basis_matrix(model, tree.cov, y=tree.obs, R=R,
                            group_by_resolution=True)
        kept = [i for i, b in enumerate(mats) if b.shape[1] <= 36]
        for i in kept:
            np.save(f"{fname}.res{i}.npy", mats[i])
        print(f"{tag} drawBasisFunctions not run: matplotlib is not "
              f"installed on this machine; the arrays it draws (resolutions "
              f"{kept}) saved to {fname}.res*.npy")
    print(f"{tag} sweep with internals: {ms_keep:.3f} ms/eval, the default "
          f"sweep {ms_base:.3f} ({n_evals} evals each); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"ms_keep": ms_keep, "ms_base": ms_base, "t_basis": t_basis}


#: phase 17b: two sets through one keep_internals sweep, the first at the
#: golden's parameters
KEEP_BATCH = {"l": (2.0, 2.5), "sig": (1.0, 0.9)}


def _stash_leaves(tree, prefix=""):
    """``{path: tensor}`` of a ``keep_internals`` stash tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree} if hasattr(tree, "shape") else {}
    out = {}
    for k, v in items:
        out.update(_stash_leaves(v, f"{prefix}/{k}"))
    return out


def phase_keep_internals_batched(device="cuda", timer=time_ms, n_evals=3,
                                 data="large", r=4, M=4, R=1e-4,
                                 golden=GOLDEN_N10K, sets=KEEP_BATCH):
    """Phase 17b: phase 17's tree with C sets through one ``keep_internals``
    sweep: every stash with the ``[C]`` axis in front, objective and
    posterior of each set against the single ``keep_internals`` sweep at
    phase 17's limits, launches equal, ms; the host basis matrix refuses
    the batch."""
    import torch

    from pymra_torch import Kernel
    from pymra_torch.tree.basis import basis_matrix
    from pymra_torch.tree.sweep import mra_sweep

    tree = _tree(data, r, M, Kernel("exponential", l=2.0), R, device)
    model, y_obs = tree.model, tree.obs
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    C = len(sets["l"])
    tag = f"keep_internals N={model.plan.n_locs} batched"
    print(f"== phase 17b: keep_internals with {C} parameter sets through one "
          f"sweep (phase 17's tree, R={R}, {sets})")

    def keep(cov):
        return mra_sweep(model.dplan, cov, y, R, jitter=model.jitter,
                         keep_internals=True)

    def single(c, t=1.0):
        return keep(Kernel("exponential", l=sets["l"][c] * t,
                           sig=sets["sig"][c]))

    single(0)  # warm-up, uncounted
    before = _launch_snapshot()
    singles = [single(c) for c in range(C)]
    mid = _launch_snapshot()
    res, stash = keep(batched_kernel(sets))
    after = _launch_snapshot()
    per_single = {n: (mid[n] - before[n]) / C for n in KERNEL_NAMES}
    per_batch = {n: after[n] - mid[n] for n in KERNEL_NAMES}
    print(f"{tag} kernel launches per sweep: one set alone "
          f"{ {n: v for n, v in per_single.items() if v} }, {C} sets batched "
          f"{ {n: v for n, v in per_batch.items() if v} }")
    check(per_batch == per_single, f"{tag}: the batch of {C} launched "
          f"{per_batch}, one set alone {per_single}")
    got, want = _stash_leaves(stash), _stash_leaves(singles[0][1])
    check(set(got) == set(want) and all(
        tuple(got[k].shape) == (C,) + tuple(want[k].shape) for k in want),
        f"{tag}: the stashes lack the [C] axis in front")
    stash_off = 0.0
    for c, (one, one_stash) in enumerate(singles):
        for k, w in _stash_leaves(one_stash).items():
            if w.is_floating_point() and w.numel():
                d = float((got[k][c] - w).abs().max())
                stash_off = max(stash_off, d / max(float(w.abs().max()),
                                                   1e-30))
    _anchor(f"{tag} set 0", float(res.objective[0]), golden)
    obj = max(abs(float(res.objective[c]) - float(one.objective))
              / abs(float(one.objective)) for c, (one, _) in
              enumerate(singles))
    print(f"{tag} against each set's keep_internals sweep alone: objective "
          f"rel diff {obj:.3g} (limit {ANCHOR_RTOL}); every stash within "
          f"{stash_off:.3g} of its largest magnitude (reported)")
    check(obj <= ANCHOR_RTOL, f"{tag}: objective off the single sweeps by "
                              f"{obj:.3g}")
    for name, limit in (("mean", KEEP_MEAN_ATOL), ("var", KEEP_VAR_ATOL)):
        diff = max(float((getattr(res, name)[c] - getattr(one, name))
                         .abs().max()) for c, (one, _) in enumerate(singles))
        print(f"{tag} {name} against each set's: max|diff| {diff:.3g} "
              f"(limit {limit})")
        check(diff <= limit, f"{tag} {name} off the single sweeps by "
                             f"{diff:.3g}")
    try:
        basis_matrix(model, batched_kernel(sets), y=y_obs, R=R)
        fail(f"{tag}: the host basis matrix took a batch")
    except NotImplementedError as e:
        print(f"{tag} basis matrix under the batch refused: {e}")
    del stash, singles
    it = iter(np.exp(np.linspace(-0.01, 0.01, n_evals + 1)))

    def batch_at_next():
        t = float(next(it))
        return keep(batched_kernel({"l": [l * t for l in sets["l"]],
                                    "sig": sets["sig"]}))

    ms_batch = timer(batch_at_next, reps=n_evals)
    it = iter(np.exp(np.linspace(-0.01, 0.01, n_evals + 1)))
    ms_single = timer(lambda: single(0, float(next(it))), reps=n_evals)
    print(f"{tag}: {ms_batch:.3f} ms per batched sweep of {C} sets against "
          f"{ms_single:.3f} ms for one set alone ({n_evals} evals each)")
    return {"ms_batch": ms_batch, "ms_single": ms_single,
            "objective": obj, "stash": stash_off, "launches": per_batch}


def phase_tri_route(device="cuda", timer=time_ms, n_evals=10,
                    data="large", r=4, M=4, R=1e-4, golden=GOLDEN_N10K,
                    golden_grad=GOLDEN_GRAD_N10K, rough=None):
    """The triangular leaf route at N=10^4 against the goldens, ms per
    evaluation on both routes, and the float32 roughness of each route at
    the points of ``rough`` (phase 13's ``{R: {"mle", "sd"}}``)."""
    import torch

    from pymra_torch import Kernel, MRAModel, PlanConfig, load_data
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs

    t_phase = time.perf_counter()
    locs, y_obs = load_data(data)
    tag = f"N={len(locs)}"
    print(f"== phase 18: the triangular leaf route at {tag} (bundled {data}, "
          f"r={r}, M={M}, exponential l=2 sig=1, R={R}; PYMRA_LEAF_SOLVE)")
    model = MRAModel(locs, r=r, M=M, dtype=torch.float32,
                     config=PlanConfig(r=r, kmeans_impl="native"),
                     device=device)
    y = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    dplan, jitter = model.dplan, model.jitter
    prep = prepare_obs(dplan, y, R)

    def evaluate(l):
        return mra_sweep(dplan, Kernel("exponential", l=l), None, None,
                         jitter=jitter, prep=prep)

    f = model.loglik_fn(y, R, kernel_builder=exponential_builder)
    ls = np.linspace(1.5, 2.5, n_evals + 1)
    out = {}
    with leaf_route("tri"):
        res = evaluate(2.0)
        _anchor(f"{tag} triangular route", float(res.objective), golden)
        _posterior_finite(f"{tag} triangular route", res, len(locs))
        _, grad = value_and_grad(f, 2.0, 1.0)
        _held(f"{tag} triangular route", grad, golden_grad, GRAD_RTOL)
    for route in ROUTES:
        with leaf_route(route):
            out[route] = {"ms_fwd": _sweep_timer(evaluate, ls, timer),
                          "ms_grad": _grad_timer(f, ls, timer)}
    print(f"{tag} ms/eval (full likelihood+posterior; value and gradient; "
          f"{n_evals} evals, l in [1.5, 2.5]): "
          + "; ".join(f"{route} {t['ms_fwd']:.3f}, {t['ms_grad']:.3f}"
                      for route, t in out.items()))
    for rr, pt in (rough or {}).items():
        f_r = model.loglik_fn(y, rr, kernel_builder=exponential_builder)
        for route in ROUTES:
            with leaf_route(route):
                out[route][f"roughness_{rr}"] = roughness(
                    f"{tag} R={rr} route {route}", f_r, pt["mle"], pt["sd"])
    print(f"phase 18 wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_tri_n1m(n1m, device="cuda", timer=time_ms, golden=GOLDEN_N1M,
                  n_evals=8, n_grad=5, pairs=4):
    """Phase 18b: the triangular route on phase 5's N=10^6 plan and data
    (before they are freed): the objective against its golden, the
    posterior finite, likelihood-only ms on both routes; the value and
    gradient on the triangular route held to a five-point difference of
    its own loglik (phase 8's check), with KP's pullback mode (K2's
    backward at the leaves) launched once in it, peak memory with autograd
    on both routes, and ms per value-and-gradient evaluation on both routes
    in ``pairs`` alternating pairs (``n_grad`` evaluations each)."""
    from pymra_torch import Kernel
    from pymra_torch.ops import linalg as tl
    from pymra_torch.tree.sweep import mra_sweep, prepare_obs

    model, y = n1m["model"], n1m["y"]
    n = model.dplan.n_locs
    tag = f"N={n}"
    print(f"== phase 18b: the triangular leaf route at {tag} (phase 5's "
          "grid and data, l=0.05, R=1e-2)")
    dplan, jitter = model.dplan, model.jitter
    prep = prepare_obs(dplan, y, 1e-2)

    def evaluate(l, post=False):
        return mra_sweep(dplan, Kernel("exponential", l=l), None, None,
                         compute_posterior=post, jitter=jitter, prep=prep)

    thetas = np.linspace(0.04, 0.06, n_evals + 1)
    out = {}
    with leaf_route("tri"):
        _anchor(f"{tag} triangular route", float(evaluate(0.05).objective),
                golden)
        _posterior_finite(f"{tag} triangular route", evaluate(0.05, True), n)
    for route in ROUTES:
        with leaf_route(route):
            out[route] = _sweep_timer(evaluate, thetas, timer)
    print(f"{tag} likelihood-only ms/eval ({n_evals} evals, l in [0.04, "
          "0.06]): " + "; ".join(f"{route} {ms:.3f}"
                                 for route, ms in out.items()))

    f = model.loglik_fn(y, 1e-2, kernel_builder=exponential_builder)
    peak = {}
    before = launches_of(tl, "cholesky_pullback_tile")
    with leaf_route("tri"):
        peak["tri"], fd, ad = gradient_vs_difference(
            f, f"{tag} triangular route", device)
    tile = launches_of(tl, "cholesky_pullback_tile") - before
    print(f"{tag} triangular route: KP's pullback mode launched {tile} "
          "time(s) in one value-and-gradient evaluation (the leaves)")
    check(device == "cpu" or tile == 1,
          f"{tag} triangular route: K2's backward at the leaves launched "
          f"KP's pullback mode {tile} times in one evaluation, not once")
    for route in ROUTES[:-1]:
        with leaf_route(route):
            _reset_peak(device)
            value_and_grad(f, 0.05, 1.0)
            peak[route] = _peak_gib(device)
    ls = np.linspace(0.04, 0.06, n_grad + 1)
    grad_ms = {route: [] for route in ROUTES}
    for k in range(pairs):
        for route in (ROUTES if k % 2 == 0 else ROUTES[::-1]):
            with leaf_route(route):
                grad_ms[route].append(_grad_timer(f, ls, timer))
    print(f"{tag} value and gradient ms/eval ({pairs} alternating pairs of "
          f"{n_grad} evals, l in [0.04, 0.06]): " + "; ".join(
              f"{route} median {np.median(v):.3f} (" + ", ".join(
                  f"{x:.3f}" for x in v) + ")" for route, v in grad_ms.items())
          + "; peak device memory with autograd " + ", ".join(
              f"{route} {gib:.2f} GiB" for route, gib in peak.items()))
    return {"ms_fwd": out, "ms_grad": grad_ms, "peak": peak, "fd": fd,
            "ad": ad}


# ---------------------------------------------------------------------------
# phases 20, 20b: the sharded paths, ranks time-sliced on the one card
# ---------------------------------------------------------------------------

#: phase 20: ranks of the sharded N=10^6 path. NCCL refuses two ranks on
#: one card, so they share it over gloo, which stages every collective
#: through the host: their times are not a scaling figure
SHARD_RANKS = 2
#: every rank world's join deadline, and its collectives' timeout: a rank
#: that fails or hangs fails the phase by then (seconds)
SHARD_DEADLINE_S = 240
#: phase 20 against the serial sweep on the same card: the objective (phase
#: 5's, l=0.05) within this relative difference, the posterior mean and
#: variance within these times their largest magnitude, and the gradient
#: in (l, sig) (phase 8's autograd) within this relative difference. With
#: one rank the sharded code is bit-identical to the serial sweep (checked
#: first, in this process); with two the cross-rank sums reorder float32
#: sums and each rank's batched products run at half the batch. In the CPU
#: float32 rehearsal (``tools/float32_sharded.py``, N=64^2 and 128^2) the
#: objective moved by at most 1.0e-7, the posterior not at all (the CPU's
#: batched products do not depend on the batch) and the gradient by at
#: most 4.3e-8. On an NVIDIA H100 (700 W) at N=10^6 two ranks moved the
#: objective by 1.5e-7, the gradient by 1.5e-6 and the posterior mean and
#: variance by 4.4e-3 and 8.4e-4 of their scale at the worst location
#: (median 7.3e-6 and 7.9e-7): the float32 posterior's own sensitivity,
#: which phase 17 meets against float64 too
SHARD_OBJ_RTOL = 1e-5
SHARD_POST_RTOL = {"mean": 2e-2, "var": 5e-3}
SHARD_GRAD_RTOL = 1e-4
#: phase 20b: a chain x data mesh of 4 ranks on phase 13's N=10^4 tree at
#: phase 13's R, a short HMC (phase 13's leapfrog count), from phase 13's
#: fit; each chain's last log_prob against a fresh serial evaluation within
#: this times max(1, |log_prob|) (CPU float32 rehearsal: 7.0e-7; an NVIDIA
#: H100 (700 W): 2.8e-7)
CHAIN_MESH = {"chain": 2, "data": 2}
CHAIN_RUN = {"num_warmup": 10, "num_samples": 10, "num_leapfrog": 4}
CHAIN_REEVAL_RTOL = 1e-5
#: phase 20c: phase 13c's first sets through one sharded sweep on phase
#: 20's ranks, and phase 20b's mesh with this many chains a chain rank, run
#: in lockstep (one batched sharded evaluation of all of them a step)
SHARD_BATCH = 2
LOCKSTEP_CHAINS = 2
#: the faults the ranks can be told to inject (for the tests): rank 1
#: drops its messages from the transition level's cross-rank sum, or every
#: rank's gradient misses its cross-rank mean (phase 20); rank 1 drops set
#: 1 of a batch from its partial sums, messages and totals (phase 20c)
FAULTS = ("transition", "grad")
BATCH_FAULTS = ("set1",)


def run_ranks(target, n_ranks: int, tmp: str, args: tuple,
              deadline: float = SHARD_DEADLINE_S) -> None:
    """Start ``n_ranks`` processes (spawn) running ``target(rank, n_ranks,
    tmp, *args)``; join them by ``deadline`` seconds, kill any still
    running, and fail unless every one exited 0."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, n_ranks, tmp) + args,
                         daemon=True) for rank in range(n_ranks)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    check(not hung, f"ranks {hung} still running after {deadline} s: "
                    "killed")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * n_ranks, f"ranks exited with codes {codes}")


def _rank_reports(tmp, n_ranks) -> list:
    out = []
    for r in range(n_ranks):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def _rank_setup(rank, n_ranks, tmp, device, mesh_shape, fault):
    """A rank's process group (gloo, a file store in ``tmp``), its mesh,
    its kernels (loaded from the parent's build) and its fault."""
    import datetime

    import torch
    import torch.distributed as dist

    from pymra_torch.parallel import initialize_distributed, make_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        from pymra_torch.ops.cuda import build

        build.load_library()
    initialize_distributed(
        "gloo", device_type=device,
        store=dist.FileStore(os.path.join(tmp, "store"), n_ranks),
        world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_DEADLINE_S))
    mesh = make_mesh(mesh_shape, device_type=device, backend="gloo")
    if fault == "transition" and rank == 1:
        from pymra_torch.tree import sweep

        orig = sweep._all_reduce

        def dropped(x, group, what):
            return orig(x * 0 if what == "messages" else x, group, what)

        sweep._all_reduce = dropped
    elif fault == "grad":
        from pymra_torch.parallel import sharded

        sharded.mean_grad = lambda x, group: x
    elif fault == "set1" and rank == 1:
        import torch

        from pymra_torch.tree import sweep

        orig_packed = sweep._all_reduce_packed
        one = torch.tensor([1], device=device)

        def dropped_set1(tensors, group, what):
            return orig_packed([t.index_fill(0, one, 0.0) if t.dim() else t
                                for t in tensors], group, what)

        sweep._all_reduce_packed = dropped_set1
    elif fault is not None:
        check(fault in FAULTS + BATCH_FAULTS, f"unknown fault {fault!r}")
    return mesh


def _rank_done(tmp, rank, out):
    import torch.distributed as dist

    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


@contextlib.contextmanager
def timed_collectives(device):
    """Host milliseconds, calls and bytes of the sweep's forward
    collectives by kind (``"messages"``, ``"totals"``, ``"posterior"``),
    each between two synchronizations of the card (so the time is the
    collective's, with the ranks' skew, not the kernels' before it)."""
    import torch

    from pymra_torch.tree import sweep

    stats: dict = {}
    orig = sweep._all_reduce

    def timed(x, group, what):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(x, group, what)
        if device != "cpu":
            torch.cuda.synchronize()
        s = stats.setdefault(what, {"calls": 0, "ms": 0.0, "bytes": 0})
        s["calls"] += 1
        s["ms"] += 1e3 * (time.perf_counter() - t0)
        s["bytes"] += x.numel() * x.element_size()
        return out

    sweep._all_reduce = timed
    try:
        yield stats
    finally:
        sweep._all_reduce = orig


def _rank_timer(device):
    if device != "cpu":
        return time_ms

    def host(fn, reps=10):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return host


def _rank_launches() -> dict:
    from pymra_torch.ops import linalg as tl

    return {"launches": {n: launches_of(tl, n) for n, *_ in KERNELS},
            "twins": sum(getattr(tl, f"{wrapper_of(n)[0]}_ref").cuda_calls
                         for n, *_ in KERNELS),
            "composed": sum(getattr(tl, n).composed for n in COMPOSING)}


def _rank_sharded(rank, n_ranks, tmp, device, R, n_evals, fault):
    """Phase 20 on one rank: the plan from ``tmp``, full sweeps with the
    posterior and value-and-gradient evaluations on the rank's share."""
    import torch

    from pymra_torch import Kernel, MRAModel
    from pymra_torch.ops import linalg as tl
    from pymra_torch.parallel import pad_plan_for_sharding, sharded_sweep
    from pymra_torch.parallel.sharded import sharded_loglik_fn
    from pymra_torch.tree.sweep import prepare_obs
    from pymra_torch.utils.checkpoint import load_plan

    mesh = _rank_setup(rank, n_ranks, tmp, device, {"data": n_ranks}, fault)
    plan = load_plan(os.path.join(tmp, "plan.npz"))
    y = torch.as_tensor(np.load(os.path.join(tmp, "y.npy")), device=device)
    model = MRAModel(plan.locs, plan.r, plan=plan, dtype=torch.float32,
                     device=device)
    dplan_p = pad_plan_for_sharding(model.dplan, n_ranks)
    prep = prepare_obs(dplan_p, y, R)
    f = sharded_loglik_fn(model.dplan, y, R, mesh, jitter=model.jitter,
                          kernel_builder=exponential_builder)

    def evaluate(l, post=True):
        return sharded_sweep(dplan_p, Kernel("exponential", l=l), y, R, mesh,
                             compute_posterior=post, jitter=model.jitter,
                             prep=prep)

    timer = _rank_timer(device)
    thetas = np.linspace(0.04, 0.06, n_evals + 1)
    reset_counters(tl)
    _reset_peak(device)
    full = evaluate(0.05)
    value, grad = value_and_grad(f, 0.05, 1.0)
    ms_full = _sweep_timer(evaluate, thetas, timer)
    ms_grad = _grad_timer(f, thetas, timer)
    out = {"crit": dplan_p.int_shard_from, "objective": float(full.objective),
           "value": value, "grad": grad, "ms_full": ms_full,
           "ms_grad": ms_grad, "peak_gib": _peak_gib(device),
           **_rank_launches()}
    with timed_collectives(device) as stats:
        evaluate(0.05)
        value_and_grad(f, 0.05, 1.0)
    out["collectives"] = stats
    if rank == 0:
        np.save(os.path.join(tmp, "mean.npy"), full.mean.cpu().numpy())
        np.save(os.path.join(tmp, "var.npy"), full.var.cpu().numpy())
    _rank_done(tmp, rank, out)


def _check_launches(tag, ranks, names):
    for r, o in enumerate(ranks):
        missing = [n for n in names if o["launches"][n] == 0]
        check(not missing, f"{tag} rank {r}: kernels of the path never "
                           f"launched: {missing}")
        check(o["twins"] == 0, f"{tag} rank {r}: a plain twin ran on a "
                               "CUDA tensor")
        check(o["composed"] == 0, f"{tag} rank {r}: K8/KC/K3 composed "
                                  "other kernels")


def one_rank_identity(n1m, device, R, tmp):
    """The sharded sweep on a world of one rank in this process (gloo)
    against phase 5's serial result: the same batches, so bit for bit."""
    import datetime

    import torch.distributed as dist

    from pymra_torch import Kernel
    from pymra_torch.parallel import (
        initialize_distributed,
        make_mesh,
        sharded_sweep,
    )

    model, full = n1m["model"], n1m["full"]
    initialize_distributed(
        "gloo", device_type=device,
        store=dist.FileStore(os.path.join(tmp, "store1"), 1), world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=SHARD_DEADLINE_S))
    try:
        one = sharded_sweep(model.dplan, Kernel("exponential", l=0.05),
                            n1m["y"], R, make_mesh({"data": 1}, device,
                                                   "gloo"),
                            jitter=model.jitter)
    finally:
        dist.destroy_process_group()
    same = [bool((a == b).all()) for a, b in
            ((one.objective, full.objective), (one.mean, full.mean),
             (one.var, full.var))]
    print(f"N={model.dplan.n_locs} sharded code on one rank against phase "
          f"5: objective, mean, var bit-identical {same}")
    check(all(same), "the sharded sweep on one rank differs from the "
                     "serial sweep")


def phase_sharded(n1m, grad_n1m, device="cuda", n_ranks=SHARD_RANKS,
                  R=1e-2, golden=GOLDEN_N1M, n_evals=3, fault=None) -> list:
    """Phase 20: phase 5's N=10^6 tree and data sharded over ``n_ranks``
    processes on the one card (gloo): objective against the golden and
    phase 5's, posterior against phase 5's, gradient against phase 8's.
    Returns the ranks' reports (each rank's kernel launches included)."""
    import tempfile

    import torch

    from pymra_torch.parallel.sharded import int_shard_level
    from pymra_torch.utils.accounting import sweep_cost
    from pymra_torch.utils.checkpoint import save_plan

    model, full = n1m["model"], n1m["full"]
    n = model.dplan.n_locs
    tag = f"N={n} sharded"
    crit = int_shard_level(model.dplan, n_ranks)
    print(f"== phase 20: the sharded main path at N={n} (phase 5's grid and "
          f"data, l=0.05, R={R}): {n_ranks} ranks time-sliced on one card "
          f"over gloo, int_shard_from {crit} (M={model.dplan.M})")
    check(crit <= model.dplan.M, f"{tag}: no interior level shards")
    t_phase = time.perf_counter()
    if device != "cpu":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_plan(os.path.join(tmp, "plan.npz"), model.plan)
        np.save(os.path.join(tmp, "y.npy"), n1m["y"].cpu().numpy())
        t_save = time.perf_counter() - t0
        one_rank_identity(n1m, device, R, tmp)
        run_ranks(_rank_sharded, n_ranks, tmp, (device, R, n_evals, fault))
        ranks = _rank_reports(tmp, n_ranks)
        mean = np.load(os.path.join(tmp, "mean.npy"))
        var = np.load(os.path.join(tmp, "var.npy"))
    r0 = ranks[0]
    for r, o in enumerate(ranks):
        check(o["crit"] == crit, f"{tag} rank {r}: int_shard_from "
                                 f"{o['crit']}, expected {crit}")
        check(all(o[k] == r0[k] for k in ("objective", "value", "grad")),
              f"{tag}: the ranks disagree: rank 0 {r0['objective']!r} "
              f"{r0['grad']}, rank {r} {o['objective']!r} {o['grad']}")
    _anchor(tag, r0["objective"], golden)
    _rel(f"{tag} objective against phase 5's serial", r0["objective"],
         float(full.objective), SHARD_OBJ_RTOL)
    for name, got, want in (("mean", mean, full.mean), ("var", var,
                                                         full.var)):
        want = want.cpu().numpy()
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{tag} posterior {name} not finite of shape {want.shape}")
        d = np.abs(got - want) / max(float(np.max(np.abs(want))), 1e-30)
        rel, med = float(d.max()), float(np.median(d))
        print(f"{tag} posterior {name} against phase 5's: max |diff| "
              f"{rel:.3g} of its largest magnitude, median {med:.3g} "
              f"(limit {SHARD_POST_RTOL[name]})")
        check(rel <= SHARD_POST_RTOL[name], f"{tag} posterior {name} off "
                                            f"by {rel:.3g}")
    # phase 8's autograd gradient is in log-parameters at l=0.05, sig=1
    ad = {"l": 0.05 * r0["grad"]["l"], "sig": r0["grad"]["sig"]}
    for k in ("l", "sig"):
        _rel(f"{tag} dloglik/dlog {k} against phase 8's serial", ad[k],
             grad_n1m["ad"][k], SHARD_GRAD_RTOL)
    if device != "cpu":
        _check_launches(tag, ranks, GRADIENT_KERNELS)
    cost = sweep_cost(model.dplan, compute_posterior=True,
                      int_shard_from=crit)
    label = (f"{n_ranks} ranks time-sliced on one card over gloo (host "
             "staging): not a scaling figure")
    for r, o in enumerate(ranks):
        print(f"{tag} rank {r}: full sweep {o['ms_full']:.3f} ms/eval, value "
              f"and gradient {o['ms_grad']:.3f} ms/eval ({n_evals} evals, l "
              f"in [0.04, 0.06]; {label}); peak device memory "
              f"{o['peak_gib']:.2f} GiB; launches {o['launches']}")
        print(f"{tag} rank {r}: forward collectives over one full sweep and "
              f"one value-and-gradient evaluation (host ms between card "
              f"synchronizations): {o['collectives']}")
    print(f"{tag} sweep_cost collective bytes per level (level -1: the "
          f"posterior; the JAX package's model): "
          f"{cost.psum_bytes_per_level}")
    print(f"{tag}: plan and data written in {t_save:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ranks


def _rank_sharded_batched(rank, n_ranks, tmp, device, R, sets, n_evals,
                          fault):
    """Phase 20c on one rank: the sets through one sharded sweep with the
    posterior, and through ``sharded_loglik_fn(..., batched=True)``'s value
    and gradient."""
    import torch

    from pymra_torch import MRAModel
    from pymra_torch.ops import linalg as tl
    from pymra_torch.parallel import pad_plan_for_sharding, sharded_sweep
    from pymra_torch.parallel.sharded import sharded_loglik_fn
    from pymra_torch.tree.sweep import prepare_obs
    from pymra_torch.utils.checkpoint import load_plan

    mesh = _rank_setup(rank, n_ranks, tmp, device, {"data": n_ranks}, fault)
    plan = load_plan(os.path.join(tmp, "plan.npz"))
    y = torch.as_tensor(np.load(os.path.join(tmp, "y.npy")), device=device)
    model = MRAModel(plan.locs, plan.r, plan=plan, dtype=torch.float32,
                     device=device)
    dplan_p = pad_plan_for_sharding(model.dplan, n_ranks)
    prep = prepare_obs(dplan_p, y, R)
    f = sharded_loglik_fn(model.dplan, y, R, mesh, jitter=model.jitter,
                          kernel_builder=exponential_builder, batched=True)

    def evaluate(t=1.0):
        return sharded_sweep(dplan_p, batched_kernel(
            {"l": [l * t for l in sets["l"]], "sig": sets["sig"]}), y, R,
            mesh, jitter=model.jitter, prep=prep)

    timer = _rank_timer(device)
    reset_counters(tl)
    _reset_peak(device)
    full = evaluate()
    values, grads = batched_value_and_grad(f, sets)
    shifts = np.exp(np.linspace(-0.01, 0.01, n_evals + 1))
    it = iter(shifts)
    ms_full = timer(lambda: evaluate(float(next(it))), reps=n_evals)
    it = iter(shifts)

    def value_and_grad_at_next():
        t = float(next(it))
        return batched_value_and_grad(f, {"l": [l * t for l in sets["l"]],
                                          "sig": sets["sig"]})

    ms_grad = timer(value_and_grad_at_next, reps=n_evals)
    out = {"objective": full.objective.tolist(), "values": values.tolist(),
           "grads": {k: v.tolist() for k, v in grads.items()},
           "ms_full": ms_full, "ms_grad": ms_grad,
           "peak_gib": _peak_gib(device), **_rank_launches()}
    if rank == 0:
        np.save(os.path.join(tmp, "mean.npy"), full.mean.cpu().numpy())
        np.save(os.path.join(tmp, "var.npy"), full.var.cpu().numpy())
    _rank_done(tmp, rank, out)


def phase_sharded_batched(n1m, batch13c, device="cuda",
                          n_ranks=SHARD_RANKS, R=SAMPLER_R,
                          sets=None, n_evals=3, fault=None) -> list:
    """Phase 20c: phase 13c's first ``SHARD_BATCH`` N=10^6 sets through one
    sharded sweep on phase 20's ranks: the ranks bit-identical, each set's
    loglik and gradient against 13c's serial batch, the posterior against
    the serial batched sweep's, at phase 20's limits. ``batch13c`` is
    phase 13c's N=10^6 report. Returns the ranks' reports."""
    import tempfile

    import torch

    from pymra_torch.utils.checkpoint import save_plan

    sets = sets or {k: v[:SHARD_BATCH] for k, v in BATCH_N1M.items()}
    C = len(sets["l"])
    model = n1m["model"]
    n = model.dplan.n_locs
    tag = f"N={n} sharded batched"
    print(f"== phase 20c: {C} parameter sets through one sharded sweep at "
          f"N={n} (phase 5's grid and data, R={R}, {sets}): {n_ranks} ranks "
          "time-sliced on one card over gloo")
    t_phase = time.perf_counter()
    serial = model.sweep(batched_kernel(sets), n1m["y"], R)
    want = _host(serial)
    want_obj = serial.objective.detach().cpu().double().numpy()
    del serial
    if device != "cpu":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        save_plan(os.path.join(tmp, "plan.npz"), model.plan)
        np.save(os.path.join(tmp, "y.npy"), n1m["y"].cpu().numpy())
        run_ranks(_rank_sharded_batched, n_ranks, tmp,
                  (device, R, sets, n_evals, fault))
        ranks = _rank_reports(tmp, n_ranks)
        got = {"mean": np.load(os.path.join(tmp, "mean.npy")),
               "var": np.load(os.path.join(tmp, "var.npy"))}
    r0 = ranks[0]
    for r, o in enumerate(ranks):
        check(all(o[k] == r0[k] for k in ("objective", "values", "grads")),
              f"{tag}: the ranks disagree: rank 0 {r0['values']} "
              f"{r0['grads']}, rank {r} {o['values']} {o['grads']}")
    worst = {"objective": 0.0, "loglik": 0.0, "grad": 0.0}
    for c in range(C):
        worst["objective"] = max(worst["objective"], abs(
            r0["objective"][c] - want_obj[c]) / abs(want_obj[c]))
        ref = batch13c["values"][c]
        worst["loglik"] = max(worst["loglik"],
                              abs(r0["values"][c] - ref) / abs(ref))
        for k in ("l", "sig"):
            ref = batch13c["grads"][k][c]
            worst["grad"] = max(worst["grad"],
                                abs(r0["grads"][k][c] - ref) / abs(ref))
    print(f"{tag}: ranks bit-identical; against the serial batch: objective "
          f"rel diff {worst['objective']:.3g}, loglik (13c) "
          f"{worst['loglik']:.3g} (limit {SHARD_OBJ_RTOL}), gradient (13c) "
          f"{worst['grad']:.3g} (limit {SHARD_GRAD_RTOL})")
    for key, limit in (("objective", SHARD_OBJ_RTOL),
                       ("loglik", SHARD_OBJ_RTOL), ("grad", SHARD_GRAD_RTOL)):
        check(worst[key] <= limit, f"{tag}: {key} off the serial batch by "
                                   f"{worst[key]:.3g}")
    moments = _moments_off(f"{tag} against the serial batched sweep", got,
                           want, SHARD_POST_RTOL)
    if device != "cpu":
        _check_launches(tag, ranks, GRADIENT_KERNELS)
    label = (f"{n_ranks} ranks time-sliced on one card over gloo (host "
             "staging): not a scaling figure")
    for r, o in enumerate(ranks):
        print(f"{tag} rank {r}: full sweep of {C} sets {o['ms_full']:.3f} "
              f"ms/eval, batched value and gradient {o['ms_grad']:.3f} "
              f"ms/eval ({n_evals} evals; {label}); peak device memory "
              f"{o['peak_gib']:.2f} GiB; launches {o['launches']}")
    print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s")
    for o in ranks:
        o["worst"], o["moments"] = worst, moments
    return ranks


def _rank_chains(rank, n_ranks, tmp, device, R, run, start, seed, fault,
                 lockstep=1):
    """Phase 20b on one rank: HMC on its chain over its data share; with
    ``lockstep = k > 1`` (phase 20c) on its ``k`` chains in lockstep, one
    batched sharded evaluation of all of them a step."""
    import torch

    from pymra_torch import MRAModel
    from pymra_torch.infer import hmc
    from pymra_torch.ops import linalg as tl
    from pymra_torch.parallel.chains import (
        gather_chains,
        shard_chains,
        shard_generators,
    )
    from pymra_torch.parallel.sharded import sharded_loglik_fn
    from pymra_torch.utils.checkpoint import load_plan

    mesh = _rank_setup(rank, n_ranks, tmp, device, CHAIN_MESH, fault)
    plan = load_plan(os.path.join(tmp, "plan.npz"))
    y = torch.as_tensor(np.load(os.path.join(tmp, "y.npy")), device=device)
    model = MRAModel(plan.locs, plan.r, plan=plan, dtype=torch.float32,
                     device=device)
    f = sharded_loglik_fn(model.dplan, y, R, mesh, axis="data",
                          jitter=model.jitter,
                          kernel_builder=exponential_builder,
                          batched=lockstep > 1)
    chains = CHAIN_MESH["chain"] * lockstep
    gen = torch.Generator().manual_seed(seed)
    init = {k: start[k] + 0.01 * torch.randn(chains, generator=gen,
                                             dtype=torch.float64)
            for k in SAMPLER_PARAMS}
    counter = CountingLogProb(log_posterior(f))
    reset_counters(tl)
    _reset_peak(device)
    t0 = time.perf_counter()
    res = hmc(counter, shard_chains(init, mesh, "chain"),
              shard_generators(gen, chains, mesh, "chain"),
              batched=lockstep > 1, **run)
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "evals": counter.calls, "rows": counter.rows,
           "peak_gib": _peak_gib(device), **_rank_launches(),
           "accept": res.accept_rate.tolist(),
           "samples": {k: v.tolist() for k, v in res.samples.items()},
           "log_prob": res.log_prob.tolist()}
    every = gather_chains({"samples": res.samples, "log_prob": res.log_prob},
                          mesh, "chain")
    out["gathered"] = {"samples": {k: v.tolist() for k, v in
                                   every["samples"].items()},
                       "log_prob": every["log_prob"].tolist()}
    # each chain's last draw, evaluated again on the serial sweep (no
    # collective: every rank does its own); in lockstep the batch that
    # draw's evaluation belonged to, again through the serial batched sweep
    # (a batch rounds otherwise than one point alone)
    logp = log_posterior(model.loglik_fn(y, R,
                                         kernel_builder=exponential_builder,
                                         batched=lockstep > 1))
    if lockstep > 1:
        out["serial_last"] = []
        for c in range(res.log_prob.shape[0]):
            theta = {k: res.samples[k][c, -1].clone() for k in SAMPLER_PARAMS}
            rec = counter.seen.get(_key(theta))
            check(rec is not None, f"rank {rank} chain {c}: no evaluation "
                                   "at its last draw")
            out["serial_last"].append(fresh_evaluation(logp, rec, theta)[0])
    else:
        with torch.no_grad():
            out["serial_last"] = [float(logp({k: res.samples[k][c, -1]
                                              for k in SAMPLER_PARAMS}))
                                  for c in range(res.log_prob.shape[0])]
    _rank_done(tmp, rank, out)


def phase_chains(start, device="cuda", data="large", r=4, M=4, R=SAMPLER_R,
                 run=CHAIN_RUN, seed=0, fault=None, lockstep=1,
                 beside=None) -> list:
    """Phase 20b: HMC on a chain x data mesh of 4 ranks time-sliced on the
    card: data partners draw bit-identical chains, the gathered draws are
    finite and healthy, each chain's last log_prob matches a serial
    evaluation. With ``lockstep = k > 1`` (phase 20c) each chain rank runs
    ``k`` chains in lockstep, its evaluations per transition reported
    beside ``beside`` (phase 20b's reports). Returns the ranks' reports."""
    import tempfile

    import torch

    from pymra_torch import PlanConfig, build_plan, load_data
    from pymra_torch.utils.checkpoint import save_plan
    from pymra_torch.utils.health import check_samples

    locs, y_obs = load_data(data)
    n_ranks = CHAIN_MESH["chain"] * CHAIN_MESH["data"]
    tag = f"N={len(locs)} chains x data"
    phase = "20b"
    if lockstep > 1:
        tag, phase = f"{tag} lockstep", "20c"
    print(f"== phase {phase}: HMC on a {CHAIN_MESH} mesh at N={len(locs)} "
          f"(bundled {data}, r={r}, M={M}, R={R}, {run}), {n_ranks} ranks "
          f"time-sliced on one card over gloo, {lockstep} chain(s) a chain "
          f"rank{' in lockstep' if lockstep > 1 else ''}, from {start}")
    t_phase = time.perf_counter()
    plan = build_plan(locs, r, M=M, config=PlanConfig(r=r,
                                                      kmeans_impl="native"))
    x0 = {"log_l": float(np.log(start["l"])),
          "log_sig": float(np.log(start["sig"]))}
    with tempfile.TemporaryDirectory() as tmp:
        save_plan(os.path.join(tmp, "plan.npz"), plan)
        np.save(os.path.join(tmp, "y.npy"), np.asarray(y_obs, np.float32))
        run_ranks(_rank_chains, n_ranks, tmp,
                  (device, R, run, x0, seed, fault, lockstep))
        ranks = _rank_reports(tmp, n_ranks)
    n_data = CHAIN_MESH["data"]
    worst = 0.0
    for r, o in enumerate(ranks):
        lead = ranks[r - r % n_data]
        check(o["samples"] == lead["samples"]
              and o["log_prob"] == lead["log_prob"],
              f"{tag}: rank {r}'s draws differ from its data partner "
              f"{r - r % n_data}'s")
        check(o["gathered"] == ranks[0]["gathered"],
              f"{tag}: rank {r} gathered other draws than rank 0")
        for c, lp in enumerate(o["log_prob"]):
            scale = max(1.0, abs(o["serial_last"][c]))
            diff = abs(lp[-1] - o["serial_last"][c])
            worst = max(worst, diff / scale)
            check(diff <= CHAIN_REEVAL_RTOL * scale,
                  f"{tag} rank {r} chain {c}: last log_prob {lp[-1]!r}, "
                  f"serial {o['serial_last'][c]!r}")
    draws = {k: torch.tensor(v) for k, v in
             ranks[0]["gathered"]["samples"].items()}
    check(all(bool(torch.isfinite(v).all()) for v in draws.values()),
          f"{tag}: draws not finite")
    health = check_samples(draws)
    check(health.ok, f"{tag}: draws unhealthy: {health}")
    if device != "cpu":
        _check_launches(tag, ranks, GRADIENT_KERNELS)
    label = (f"{n_ranks} ranks time-sliced on one card over gloo (host "
             "staging): not a scaling figure")
    total = run["num_warmup"] + run["num_samples"]
    for r, o in enumerate(ranks):
        print(f"{tag} rank {r}: {o['evals']} evaluations ({o['rows']} points)"
              f" in {o['wall_s']:.2f} s, {1e3 * o['wall_s'] / total:.1f} ms "
              f"per transition of its {len(o['accept'])} chain(s), "
              f"{o['evals'] / total:.3f} calls per transition ({label}); "
              f"acceptance {o['accept']}; peak device memory "
              f"{o['peak_gib']:.2f} GiB; launches {o['launches']}")
        if beside is not None:
            b = beside[r]
            print(f"{tag} rank {r} beside phase 20b's (one chain a rank): "
                  f"{o['evals'] / total:.3f} batched calls per transition "
                  f"against {b['evals'] / total:.3f}, "
                  f"{1e3 * o['wall_s'] / total:.1f} ms per transition "
                  f"against {1e3 * b['wall_s'] / total:.1f}")
    means = {k: v.mean(1).tolist() for k, v in draws.items()}
    print(f"{tag}: data partners' draws bit-identical; chain means of the "
          f"gathered draws {means}, check_samples ok; last log_prob against "
          f"a serial evaluation: max diff {worst:.3g} of max(1, |log_prob|) "
          f"(limit {CHAIN_REEVAL_RTOL}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ranks


# ---------------------------------------------------------------------------

#: every kernel: (wrapper name, source in ops/cuda/csrc, the TPU kernel it
#: replaces, the path shape of its record: (batch, P), or K5's (batch, P,
#: Q))
KERNELS = (
    ("leaf_factor", "leaf_factor.cu",
     "pymra_tpu/ops/pallas/linalg.py:255,309", LEAF_MAIN[-1]),
    ("cholesky_jittered", "cholesky_jittered.cu",
     "pymra_tpu/ops/pallas/linalg.py:123", CHOL_MAIN[-1]),
    ("triangular_inverse_lower", "tri_inv.cu",
     "pymra_tpu/ops/pallas/linalg.py:439", TRI_MAIN[-1]),
    ("triangular_inverse_lower_wide", "tri_inv_wide.cu",
     "pymra_tpu/ops/pallas/linalg.py:439,1072", WIDE_MAIN[-1]),
    ("cholesky", "cholesky.cu", "pymra_tpu/ops/pallas/linalg.py:99",
     TRI_MAIN[-1]),
    ("solve_triangular_batched", "tri_solve.cu",
     "pymra_tpu/ops/pallas/linalg.py:366", SOLVE_MAIN[-1][:3]),
    ("cholesky_pullback", "tri_solve.cu",
     "pymra_tpu/ops/pallas/linalg.py:1161", (4096, 8)),
    ("cholesky_pullback_tile", "tri_solve.cu",
     "pymra_tpu/ops/pallas/linalg.py:1161,1212", CHOL_SIDE[-1]),
    ("cholesky_logdet", "chol_logdet.cu",
     "pymra_tpu/ops/pallas/linalg.py:394", LOGDET_MAIN[-1]),
    ("cholesky_inv_logdet", "chol_inv_logdet.cu",
     "pymra_tpu/ops/pallas/linalg.py:175", LOGDET_MAIN[-1]),
    ("cholesky_blocked", "chol_wide.cu",
     "pymra_tpu/ops/pallas/linalg.py:1097", WIDE_MAIN[-1]),
    ("cholesky_cascade", "chol_wide.cu", "pymra_tpu/ops/pallas/linalg.py:976",
     WIDE_MAIN[-1]),
    ("leaf_pullback", "leaf_pullback.cu",
     "pymra_tpu/ops/pallas/linalg.py:932 (_leaf_factor_bwd: XLA, no Pallas "
     "kernel)", LEAF_PULLBACK_MAIN[0]),
)
KERNEL_NAMES = tuple(n for n, *_ in KERNELS)
#: the two wrappers of the wide kernel (64 < P <= 256); other widths
#: compose other kernels and count in ``.composed``
WIDE = ("cholesky_blocked", "cholesky_cascade")
#: the wrappers that count their calls that compose other kernels in
#: ``.composed`` (K3 wider than 256 too)
COMPOSING = WIDE + ("triangular_inverse_lower",)
#: kernels that run only in backward passes (checked in phases 3b-3c)
BACKWARD_KERNELS = ("cholesky_pullback", "cholesky_pullback_tile",
                    "leaf_pullback")
FORWARD_KERNELS = ("leaf_factor", "cholesky_jittered")
#: the pullback does the Cholesky backward's solves, so K5 runs only on the
#: dense-R path (phase 10's whitening); K1's backward refactors and inverts
#: the prior block itself, so K4 and K3 run on the dense-R path only (K6's
#: backward)
GRADIENT_KERNELS = FORWARD_KERNELS + ("leaf_pullback", "cholesky_pullback")
#: the dense-R and wide-leaf paths (phases 10-11) leave K1; the wide kernel
#: runs there as KC (the sweep's escalated factorizations), K8 being its
#: one-factor entry point; no gradient there reaches a factor 9 to 64 wide
#: (the dense-R blocks of 49 are free of the parameters), so neither does
#: KP's pullback mode; nor K1's backward (no K1 there)
SLICE3_KERNELS = tuple(n for n in KERNEL_NAMES[1:]
                       if n not in ("cholesky_blocked",
                                    "cholesky_pullback_tile",
                                    "leaf_pullback"))


def reset_counters(tl):
    for name, *_ in KERNELS:
        wrapper, attr = wrapper_of(name)
        setattr(getattr(tl, wrapper), attr, 0)
        getattr(tl, wrapper + "_ref").cuda_calls = 0
    for name in COMPOSING:
        getattr(tl, name).composed = 0


def read_counters(tl, title, names):
    """Print the launch counts of a path; every kernel in ``names`` must
    have launched, no twin may have run on a CUDA tensor, and K8, KC and
    K3 may not have composed other kernels (every matrix the paths factor
    or invert is at most 256 wide)."""
    launches = {n: launches_of(tl, n) for n, *_ in KERNELS}
    twins = {f"{w}_ref": getattr(tl, f"{w}_ref").cuda_calls
             for w in dict.fromkeys(wrapper_of(n)[0] for n, *_ in KERNELS)}
    composed = {n: getattr(tl, n).composed for n in COMPOSING}
    print(f"== {title}")
    print(f"kernel launches {launches}; twin calls on CUDA tensors {twins}; "
          f"composed K8/KC/K3 calls {composed}")
    missing = [n for n in names if launches[n] == 0]
    check(not missing, f"kernels of the path never launched: {missing}")
    check(all(v == 0 for v in twins.values()),
          "a plain twin ran on a CUDA tensor in the path")
    check(all(v == 0 for v in composed.values()),
          f"K8/KC/K3 composed other kernels in the path: {composed}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from pymra_torch.ops import linalg as tl

    phase_device()
    phase_build()
    err, times = phase_kernels(chol_side=CHOL_SIDE, solve_side=SOLVE_SIDE,
                               logdet_side=LOGDET_SIDE)
    err_bwd, bwd_times = phase_backward(pullback_side=CHOL_SIDE)
    err_leaf, leaf_times = phase_leaf_pullback()
    matern_rec = phase_matern_kernel()
    err_bwd.update(err_leaf)
    bwd_times.update(leaf_times)
    for name in BACKWARD_KERNELS:
        err[name] = err_bwd[name]
    times.update(bwd_times)

    reset_counters(tl)
    ms_n10k = phase_n10k()
    n1m = phase_n1m()
    forward = read_counters(tl, "phase 6: launch counters over phases 4-5",
                            FORWARD_KERNELS)

    reset_counters(tl)
    ms_grad = phase_grad_n10k()
    grad_n1m = phase_grad_n1m(n1m, n1m["ms_lik"])
    gradient = read_counters(
        tl, "phase 9: launch counters over phases 7-8", GRADIENT_KERNELS)
    phase_leaf_pullback_n1m(n1m)

    reset_counters(tl)
    samplers = phase_samplers(ms_grad)
    nuts_n1m = phase_nuts_n1m(n1m, grad_n1m["theta"], grad_n1m["ms"])
    batch13c = phase_batched(n1m)
    phase_samplers_batched(samplers)
    phase_nuts_n1m_batched(n1m, grad_n1m["theta"], nuts_n1m)
    phase_batched_posterior(n1m)
    sampler = read_counters(
        tl, "phase 14: launch counters over phases 13-13f",
        GRADIENT_KERNELS)

    reset_counters(tl)
    phase_tri_n1m(n1m)
    tri_n1m = read_counters(
        tl, "phase 18b: launch counters over the N=10^6 triangular route",
        TRI_KERNELS)

    # the ranks count their own launches (they reset and read them around
    # their run); the parent launches nothing meanwhile
    sharded = phase_sharded(n1m, grad_n1m)
    chains = phase_chains(samplers["mle"])
    sharded_batched = phase_sharded_batched(n1m, batch13c["n1m"])
    lockstep = phase_chains(samplers["mle"], lockstep=LOCKSTEP_CHAINS,
                            beside=chains)

    del n1m  # its N=10^6 plan and data
    torch.cuda.empty_cache()
    reset_counters(tl)
    phase_dense_r_batched(phase_dense_r())
    torch.cuda.empty_cache()
    phase_wide()
    slice3 = read_counters(
        tl, "phase 12: launch counters over phases 10-11 (10b included)",
        SLICE3_KERNELS)

    torch.cuda.empty_cache()
    reset_counters(tl)
    phase_matrix_cov(ms_coord=ms_n10k)
    phase_matern()
    phase_keep_internals()
    phase_keep_internals_batched()
    before = {n: launches_of(tl, n) for n in KERNEL_NAMES}
    phase_tri_route(rough=samplers["roughness"])
    tri_n10k = {n: launches_of(tl, n) - before[n] for n in KERNEL_NAMES}
    side = read_counters(
        tl, "phase 19: launch counters over phases 15-18 (17b included; "
        "18b: above)",
        SIDE_KERNELS)
    print(f"phase 18 alone: kernel launches {tri_n10k}")
    print_precision()

    rec = []
    for name, src, replaces, shape in KERNELS:
        b, p = shape[:2]
        launches = (forward if name in FORWARD_KERNELS else
                    gradient if name in GRADIENT_KERNELS else slice3)
        n_launch = launches[name]
        if name == "cholesky_pullback_tile":
            # its path: phase 18b, the N=10^6 triangular route's gradient
            n_launch = tri_n1m[name]
        extra = {}
        if name in WIDE:
            # one kernel behind both wrappers: its launches on the path are
            # those of either wrapper
            extra = {"launches_by_wrapper": {n: slice3[n] for n in WIDE},
                     "composed_ms": times[(name, b, p)].pop("composed_ms"),
                     "small": {f"{sb}x{sp}x{sp}": times[(name, sb, sp)]
                               for sb, sp in WIDE_MAIN[:-1]}}
            n_launch = sum(slice3[n] for n in WIDE)
        if name == "cholesky_jittered":
            extra = {"backward": {f"{bb}x{bp}x{bp}": t for (k, bb, bp), t
                                  in bwd_times.items()
                                  if k == "cholesky_jittered_backward"}}
        if name in LIBRARY:
            # the clean batch's times, where one library attempt is the
            # whole function: the kernel's verdict against its library
            extra["clean"] = {f"{key[1]}x{key[2]}x{key[2]}": t
                              for key, t in times.items()
                              if key[0] == name + "_clean"}
        if name == "cholesky_pullback":
            extra = {"fuses": "_cholesky_bwd: the L^T Lbar product, K5 "
                              "_tri_solve_kernel (:366) twice and the "
                              "symmetrization",
                     "levels": {f"{lb}x{lp}x{lp}": times[(name, lb, lp)]
                                for lb, lp in PULLBACK_MAIN
                                if (lb, lp) != (b, p)}}
        if name == "cholesky_pullback_tile":
            extra = {"fuses": "_cholesky_bwd at 9 <= P <= 64 on the "
                              "register-tiled core (chol_tile.cuh's "
                              "pullback mode)",
                     "path": "phase 18b, the N=10^6 triangular route's "
                             "value and gradient (K2's backward at the "
                             "leaves)",
                     "side_shapes": {f"{sb}x{sp}x{sp}": times[(name, sb, sp)]
                                     for sb, sp in CHOL_SIDE
                                     if (sb, sp) != (b, p)}}
        if name == "solve_triangular_batched":
            extra = {"other_shapes": {
                f"{sb}x{sp}x{sq}{' transposed' if st else ''}":
                    times[(name, sb, sp)]
                for sb, sp, sq, st in SOLVE_MAIN[:-1]}}
            extra["side_shapes"] = {
                f"{sb}x{sp}x{sq}{' transposed' if st else ''}":
                    times[(name, sb, sp, sq)]
                for sb, sp, sq, st in SOLVE_SIDE}
        if name in ("cholesky_jittered", "cholesky_logdet"):
            sides = CHOL_SIDE if name == "cholesky_jittered" else LOGDET_SIDE
            extra["side_shapes"] = {f"{sb}x{sp}x{sp}": times[(name, sb, sp)]
                                    for sb, sp in sides}
        if name == "triangular_inverse_lower":
            extra = {"small": {f"{sb}x{sp}x{sp}": times[(name, sb, sp)]
                               for sb, sp in TRI_MAIN[:-1]}}
        if name == "triangular_inverse_lower_wide":
            extra = {"composed_ms": times[(name, b, p)].pop("composed_ms"),
                     "small": {f"{sb}x{sp}x{sp}": times[(name, sb, sp)]
                               for sb, sp in WIDE_MAIN[:-1]}}
        rec.append({"name": name, "route": "cuda",
                    "source": f"pymra_torch/ops/cuda/csrc/{src}",
                    "replaces": replaces, "launches": n_launch,
                    "launches_gradient_path": gradient[name],
                    "launches_sampler_path": sampler[name],
                    "launches_dense_r_wide_path": slice3[name],
                    "launches_side_paths": side[name],
                    "launches_tri_n10k": tri_n10k[name],
                    "launches_tri_n1m": tri_n1m[name],
                    "launches_sharded_n1m_per_rank": [
                        o["launches"][name] for o in sharded],
                    "launches_sharded_chains_per_rank": [
                        o["launches"][name] for o in chains],
                    "launches_sharded_batched_per_rank": [
                        o["launches"][name] for o in sharded_batched],
                    "launches_lockstep_chains_per_rank": [
                        o["launches"][name] for o in lockstep],
                    "max_abs_err": err[name],
                    "max_abs_err_backward": err_bwd.get(name),
                    **times[(name, b, p)],
                    "shape": "x".join(map(str, (shape + (p,))[:3])),
                    **extra})
    rec.append({"name": "matern_cuda", "route": "cuda",
                "source": "pymra_torch/ops/cuda/csrc/matern.cu",
                "replaces": "none: the JAX package's matern_general is XLA "
                            "elementwise arithmetic",
                "shape": "x".join(map(str, MATERN_SHAPE)), **matern_rec})
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
