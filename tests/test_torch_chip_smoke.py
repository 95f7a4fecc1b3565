"""``chip_smoke.py`` rehearsed on the CPU at tiny sizes.

On the CPU every wrapper runs its plain twin, so these runs check the
script's control flow, its test matrices (escalated, exact-zero, all-fail
and masked members), its checks and its work counts — not the CUDA
kernels, which only the card runs. Timings here come from a host clock and
mean nothing.
"""
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from pymra_torch import Kernel, MRAModel, PlanConfig, load_data
from pymra_torch.ops import linalg as tl
from pymra_torch.tree import sweep
from pymra_torch.tree.plan import tpu_shaped_M
from pymra_torch.utils import gen_locations_2d

from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _host_timer(fn, reps=10):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _no_device_timer(fn, reps=10):
    # the profiler's device timer needs a card; here only the call runs
    fn()
    return None, 0


def test_kernel_phase_passes_with_twins():
    err, times = chip_smoke.phase_kernels(
        "cpu", ragged=9, chol_main=((8, 4),), leaf_main=((6, 17),),
        tri_main=((5, 17),),
        solve_main=((8, 4, 4, True), (6, 17, 1, False)),
        logdet_main=((7, 9),),
        wide_widths=(65, 130), wide_main=((6, 96),), timer=_host_timer,
        dev_timer=_no_device_timer)
    # on the CPU each wrapper runs its twin, so kernel and twin agree
    # exactly — but the blocked inverse (P > 64, the wide K3's record),
    # which is the twin on blocks and matmuls against plain forward
    # substitution over the whole width
    blocked = err.pop("triangular_inverse_lower_wide")
    assert err == dict.fromkeys(set(chip_smoke.KERNEL_NAMES)
                                - {"triangular_inverse_lower_wide"}
                                - set(chip_smoke.BACKWARD_KERNELS), 0.0)
    assert 0 < blocked < 1e-6
    assert set(times) == {("cholesky_jittered", 8, 4), ("leaf_factor", 6, 17),
                          ("cholesky", 5, 17),
                          ("triangular_inverse_lower", 5, 17),
                          ("solve_triangular_batched", 8, 4),
                          ("solve_triangular_batched", 6, 17),
                          ("cholesky_logdet", 7, 9),
                          ("cholesky_inv_logdet", 7, 9),
                          ("cholesky_blocked", 6, 96),
                          ("cholesky_cascade", 6, 96),
                          ("triangular_inverse_lower_wide", 6, 96),
                          ("cholesky_jittered_clean", 8, 4),
                          ("cholesky_logdet_clean", 7, 9),
                          ("cholesky_inv_logdet_clean", 7, 9),
                          ("cholesky_cascade_clean", 6, 96)}
    for key, rec in times.items():
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                           "operations")
        assert (rec["library_ms"] is None) == (key[0] == "leaf_factor")
        assert rec["device_ms"] is None and rec["device_launches"] == 0
        # K8, KC and the wide K3 are also timed as the compositions they
        # replaced
        assert ("composed_ms" in rec) == (
            key[0] in chip_smoke.WIDE + ("triangular_inverse_lower_wide",))


def test_kernel_phase_times_jittered_kernels_on_both_batches():
    # K2, K6, K7 and KC are timed on the escalating batch (up to three
    # attempts a member) and on a clean one (one), each beside its twin and
    # its library call; the clean batch's work counts one attempt a member
    _, times = chip_smoke.phase_kernels(
        "cpu", ragged=5, chol_main=((6, 3),), leaf_main=((5, 16),),
        tri_main=((5, 16),), solve_main=((6, 3, 1, False),),
        logdet_main=((5, 33),),
        wide_widths=(65,), wide_main=((6, 70),), timer=_host_timer,
        dev_timer=_no_device_timer)
    mains = {"cholesky_jittered": (6, 3), "cholesky_logdet": (5, 33),
             "cholesky_inv_logdet": (5, 33), "cholesky_cascade": (6, 70)}
    assert set(chip_smoke.LIBRARY) == set(mains)
    for name, (b, p) in mains.items():
        for key in (name, name + "_clean"):
            rec = times[key, b, p]
            assert rec["ms"] > 0 and rec["plain_ms"] > 0
            assert rec["library_ms"] > 0
    m, jit = (torch.as_tensor(x) for x in chip_smoke.clean_case(
        np.random.default_rng(1), 5, 33))
    ld, f = tl.cholesky_logdet(m, jit)
    assert (f == 1.0).all()
    assert chip_smoke.work("cholesky_logdet", [m, jit], [ld, f])[1] == (
        5 * 33 ** 3 / 3)


def test_work_counts_bytes_and_escalated_attempts():
    # K2 at 8 x 4: one member escalated once, one twice and one (all-fail)
    # three times; bytes are the inputs read once, the outputs written once,
    # and of a symmetric or lower-triangular input only its 4*5/2 = 10
    # lower entries per member
    m, jit = (torch.as_tensor(x) for x in chip_smoke.chol_case(
        np.random.default_rng(0), 8, 4))
    out = tl.cholesky_jittered(m, jit)
    nbytes, flops, flops64 = chip_smoke.work("cholesky_jittered", [m, jit],
                                             list(out))
    assert nbytes == 4 * (8 * 10 + 8 + 8 * 16 + 2 * 8)
    assert flops == (8 + 1 + 1 + 2) * 4 ** 3 / 3 and flops64 == 0
    lt = torch.as_tensor(chip_smoke.lower_case(np.random.default_rng(1), 3,
                                               4))
    b = torch.zeros(3, 4, 2)
    assert chip_smoke.work("solve_triangular_batched", [lt, b], [b]) == (
        4 * (3 * 10 + 2 * 3 * 8), 3 * 16 * 2, 0.0)
    assert chip_smoke.work("triangular_inverse_lower", [lt], [lt])[0] == (
        4 * (3 * 10 + 3 * 16))
    assert chip_smoke.work("cholesky", [m], [m])[0] == 4 * (8 * 10 + 8 * 16)
    # K1: C and A_oo symmetric, the knot mask dense; Li and four [B]
    # outputs (two log-determinants, two factors) written
    c, k, a = (torch.as_tensor(x) for x in chip_smoke.leaf_case(
        np.random.default_rng(2), 6, 17, escalate=True))
    out = tl.leaf_factor(c, k, a, 1e-3)
    assert chip_smoke.work("leaf_factor", [c, k, a], list(out))[0] == (
        4 * (2 * 6 * 153 + 6 * 17 + 6 * 289 + 4 * 6))
    # K6 writes two [B] outputs, K7 the inverse too; the work counts the
    # attempts each member took (members 1-3 escalate: 2, 2 and 3)
    m, jit = (torch.as_tensor(x) for x in chip_smoke.chol_case(
        np.random.default_rng(3), 5, 4))
    ld, f = tl.cholesky_logdet(m, jit)
    assert chip_smoke.work("cholesky_logdet", [m, jit], [ld, f]) == (
        4 * (5 * 10 + 5 + 2 * 5), (5 + 1 + 1 + 2) * 4 ** 3 / 3, 0.0)
    out = tl.cholesky_inv_logdet(m, jit)
    assert chip_smoke.work("cholesky_inv_logdet", [m, jit], list(out)) == (
        4 * (5 * 10 + 5 + 5 * 16 + 2 * 5), (5 + 1 + 1 + 2) * 2 * 4 ** 3 / 3,
        0.0)
    out = tl.cholesky_cascade(m, jit)
    assert chip_smoke.work("cholesky_cascade", [m, jit], list(out))[1:] == (
        (5 + 1 + 1 + 2) * 4 ** 3 / 3, 0.0)
    assert chip_smoke.work("cholesky_blocked", [m], [m]) == (
        4 * (5 * 10 + 5 * 16), 5 * 4 ** 3 / 3, 0.0)
    # wider than 64 (the wide kernel): each 64-wide diagonal block (here
    # 64 and 36) factored and inverted in float32, b^3/3 each, and the rest
    # of the P^3/3, the panels and downdates, in float64; KC charges each
    # attempt (members 1-3 of wide_case escalate: 2, 2 and 3 attempts)
    diag = (64 ** 3 + 36 ** 3) / 3
    assert chip_smoke.wide_flops(100) == (2 * diag, 100 ** 3 / 3 - diag)
    assert chip_smoke.wide_flops(64) == (64 ** 3 / 3, 0.0)
    mw, jw = (torch.as_tensor(x) for x in chip_smoke.wide_case(
        np.random.default_rng(4), 4, 100))
    out = tl.cholesky_cascade(mw, jw)
    assert chip_smoke.work("cholesky_cascade", [mw, jw], list(out)) == (
        4 * (4 * 5050 + 4 + 4 * 10000 + 2 * 4),
        (4 + 1 + 1 + 2) * 2 * diag, (4 + 1 + 1 + 2) * (100 ** 3 / 3 - diag))
    assert chip_smoke.work("cholesky_blocked", [mw], [mw])[1:] == (
        4 * 2 * diag, 4 * (100 ** 3 / 3 - diag))
    # the fused pullback reads the lower triangles of L and Lbar (phi(L^T
    # Lbar) needs no more of Lbar) and two [B] vectors and writes Abar and
    # jbar; its product and two solves are P^3/3 + 2 P^3 flops a member
    l, _, f = tl.cholesky_jittered(m, jit)
    lbar, ldbar = torch.zeros_like(l), torch.zeros_like(f)
    out = tl.cholesky_pullback(l, lbar, ldbar, f)
    assert chip_smoke.work("cholesky_pullback", [l, lbar, ldbar, f],
                           list(out)) == (
        4 * (5 * 10 + 5 * 10 + 5 + 5 + 5 * 16 + 5),
        5 * (4 ** 3 / 3 + 2 * 4 ** 3), 0.0)
    assert chip_smoke.bound_ms(3.35e9, 1.0) == (1.0, "bytes")
    assert chip_smoke.bound_ms(1.0, 67e9) == (1.0, "operations")
    # float64 operations at the FP64 tensor cores' 67 TFLOP/s, summed with
    # the float32 ones
    assert chip_smoke.bound_ms(1.0, 33.5e9, 33.5e9) == (1.0, "operations")


def test_kernel_scaling_times_k1_k4_and_k3(monkeypatch):
    # tools/kernel_scaling.py on CPU tensors, its timer replaced by the host
    # clock: one row per kernel, the rate from chip_smoke.work's float32
    # operations (work returns three counts: the tool read two)
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_scaling", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "tools", "kernel_scaling.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    monkeypatch.setattr(chip_smoke, "time_ms", _host_timer)
    rng = np.random.default_rng(0)
    leaf = [torch.as_tensor(x) for x in chip_smoke.leaf_case(
        rng, 4, 17, escalate=True)]
    chol = torch.as_tensor(chip_smoke.chol_case(rng, 4, 17)[0])
    low = torch.as_tensor(chip_smoke.lower_case(rng, 4, 17))
    row = ks._time(4, 17, leaf, chol, low)
    assert set(row) == set(ks.NAMES)
    assert all(r["ms"] > 0 and r["gflop_per_s"] > 0 for r in row.values())
    wide = ks._time(2, 96, None,
                    low=torch.as_tensor(chip_smoke.lower_case(rng, 2, 96)))
    assert set(wide) == {"triangular_inverse_lower"}


def test_kernel_scaling_times_k6_k7_per_step(monkeypatch):
    # tools/kernel_scaling.py --logdet on CPU tensors, its timer replaced
    # by the host clock: K6, K7, their library calls and K3 a row, the
    # time of a step being the call's over P
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_scaling", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "tools", "kernel_scaling.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=10: _host_timer(fn, 2))
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn: (_host_timer(fn, 2), 1.0))
    monkeypatch.setattr(ks, "LOGDET_B", 4)
    res = ks._time_logdet(np.random.default_rng(0), "cpu", (5, 9))
    assert set(res) == {5, 9}
    assert set(res[9]) == {"triangular_inverse_lower", "cholesky_logdet",
                           "cholesky_logdet_library", "cholesky_inv_logdet",
                           "cholesky_inv_logdet_library"}
    for p, row in res.items():
        for rec in row.values():
            assert rec["ms"] > 0 and rec["device_launches"] == 1.0
            assert rec["us_per_step"] == pytest.approx(
                rec["device_ms"] * 1e3 / p)


def test_kernel_scaling_times_k5_and_the_pullback_at_path_shapes(
        monkeypatch):
    # tools/kernel_scaling.py --solve on CPU tensors, its timers replaced by
    # the host clock: K5 and its library call at each SOLVE_MAIN shape, the
    # pullback at each PULLBACK_MAIN shape with the longer device loop
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_scaling", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "tools", "kernel_scaling.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    reps = []
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=10: _host_timer(fn, 1))
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, n=10: (
        reps.append(n) or _host_timer(fn, 1), 1.0))
    monkeypatch.setattr(chip_smoke, "SOLVE_MAIN",
                        ((8, 4, 4, True), (6, 17, 1, False)))
    monkeypatch.setattr(chip_smoke, "PULLBACK_MAIN", ((4, 8), (16, 4)))
    res = ks._time_solve(np.random.default_rng(0), "cpu")
    assert set(res) == {
        "solve_triangular_batched 8x4x4 transposed",
        "solve_triangular 8x4x4 transposed",
        "solve_triangular_batched 6x17x1", "solve_triangular 6x17x1",
        "cholesky_pullback 4x8x8", "cholesky_pullback 16x4x4"}
    assert all(r["ms"] > 0 and r["device_launches"] == 1.0
               for r in res.values())
    assert reps == [10] * 4 + [chip_smoke.PULLBACK_DEVICE_REPS] * 2


def test_kernel_scaling_times_k2_and_its_pullback_at_the_side_shapes(
        monkeypatch):
    # tools/kernel_scaling.py --jittered on CPU tensors, its timers
    # replaced by the host clock: K2 on both batches and its library call
    # at each CHOL_MAIN and CHOL_SIDE shape, the pullback at each CHOL_SIDE
    # shape with the longer device loop
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_scaling", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "tools", "kernel_scaling.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    reps = []
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=10: _host_timer(fn, 1))
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, n=10: (
        reps.append(n) or _host_timer(fn, 1), 1.0))
    monkeypatch.setattr(chip_smoke, "CHOL_MAIN", ((8, 4),))
    monkeypatch.setattr(chip_smoke, "CHOL_SIDE", ((5, 17),))
    res = ks._time_jittered(np.random.default_rng(0), "cpu")
    assert set(res) == {
        "cholesky_jittered clean 8x4x4", "library clean 8x4x4",
        "cholesky_jittered chol_case 8x4x4",
        "cholesky_jittered clean 5x17x17", "library clean 5x17x17",
        "cholesky_jittered chol_case 5x17x17", "cholesky_pullback 5x17x17"}
    assert all(r["ms"] > 0 and r["device_launches"] == 1.0
               for r in res.values())
    assert reps == [10] * 6 + [chip_smoke.PULLBACK_DEVICE_REPS]


def test_kernel_scaling_times_the_pullback_mode_by_width_and_batch(
        monkeypatch):
    # tools/kernel_scaling.py --pullback on CPU tensors, its timers
    # replaced by the host clock: a row per (B, P) with its bound; the
    # kernel's usage read from the build directory (none here), and the
    # occupancy rules of sm_90 (K4's 80 registers gave 12 blocks an SM)
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "kernel_scaling", os.path.join(os.path.dirname(chip_smoke.__file__),
                                       "tools", "kernel_scaling.py"))
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    reps = []
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=10: _host_timer(fn, 1))
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, n=10: (
        reps.append(n) or _host_timer(fn, 1), 1.0))
    monkeypatch.setattr(ks, "resource_usage", lambda pattern: {
        "_ZN12_GLOBAL__N_118chol_pullback_tileILi4EEEvPKfS2_S2_S2_PfS3_i":
            {"regs": 80, "stack": 0, "shared": 9000, "local": 0}})
    res = ks._time_pullback(np.random.default_rng(0), "cpu", widths=(9, 17),
                            batches=(4,))
    assert set(res) == {"cholesky_pullback 4x9x9", "cholesky_pullback 4x17x17"}
    assert reps == [chip_smoke.PULLBACK_DEVICE_REPS] * 2
    assert res["cholesky_pullback 4x9x9"]["kernel"] is None
    row = res["cholesky_pullback 4x17x17"]
    assert row["kernel"] == "chol_pullback_tile<4>" and row["regs"] == 80
    assert row["blocks_per_sm"] == 12 and row["bound_ms"] > 0
    assert ks.occupancy(80, 0) == 12 and ks.occupancy(64, 0) == 16
    # the kernel it replaced: 33 KB of dynamic shared memory at P = 64
    assert ks.occupancy(40, 2 * 64 * 65 * 4) == 6


def test_solve_and_pullback_are_timed_at_their_paths_shapes(monkeypatch):
    # K5's record is the one call the dense-R path makes per evaluation
    # (phase 10's tree and R: yw = L_R^-1 y0 at the 256 leaves of 49,
    # forward; L_R and y0 are free of theta, so no backward solve), and the
    # N=10^4 gradient hands the pullback each of its interior levels twice,
    # shapes PULLBACK_MAIN times
    locs, y = load_data("large")
    model = MRAModel(locs, r=4, M=4, dtype=torch.float32, device="cpu",
                     config=PlanConfig(r=4, kmeans_impl="native"))
    solves, pullbacks = [], []
    real_solve, real_pullback = sweep.solve_triangular_batched, \
        tl.cholesky_pullback
    monkeypatch.setattr(sweep, "solve_triangular_batched",
                        lambda l, b, t=False: solves.append(
                            (*b.shape, t)) or real_solve(l, b, t))
    monkeypatch.setattr(tl, "cholesky_pullback",
                        lambda l, *a: pullbacks.append(l.shape[:2])
                        or real_pullback(l, *a))
    th = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in (("l", 2.0), ("sig", 1.0))}
    model.sweep(Kernel("exponential", l=th["l"], sig=th["sig"]),
                torch.as_tensor(y, dtype=torch.float32),
                chip_smoke.correlated_r(locs, "cpu"),
                compute_posterior=False).loglik.backward()
    assert solves == [chip_smoke.SOLVE_MAIN[-1]]
    assert chip_smoke.KERNELS[[n for n, *_ in chip_smoke.KERNELS].index(
        "solve_triangular_batched")][3] == chip_smoke.SOLVE_MAIN[-1][:3]
    pullbacks.clear()
    f = model.loglik_fn(torch.as_tensor(y, dtype=torch.float32), 1e-4,
                        kernel_builder=chip_smoke.exponential_builder)
    chip_smoke.value_and_grad(f, 2.0, 1.0)
    n10k = [(4 ** m, 4) for m in range(4)]
    assert sorted(pullbacks) == sorted(2 * n10k)
    assert set(n10k) <= set(chip_smoke.PULLBACK_MAIN)
    assert set(chip_smoke.PULLBACK_MAIN) <= set(chip_smoke.PULLBACK_SHAPES)


def test_backward_phase_passes_with_twins():
    err, times = chip_smoke.phase_backward(
        "cpu", chol_main=((8, 4),), leaf_main=((6, 17),),
        logdet_main=((7, 9),), wide_main=((5, 70),),
        pullback_shapes=((8, 4), (9, 49)), pullback_main=((8, 4),),
        timer=_host_timer,
        dev_timer=_no_device_timer, pullback_side=((5, 17),))
    assert err == dict.fromkeys(
        ["cholesky_pullback", "cholesky_pullback_tile", "cholesky_jittered",
         "leaf_factor", "cholesky_logdet", "cholesky_inv_logdet",
         "cholesky_cascade", "cholesky_blocked"], 0.0)
    # the pullback is also checked and timed at the side paths' shapes,
    # above P = 8 under the record of its pullback mode
    assert set(times) == {("cholesky_jittered_backward", 8, 4),
                          ("cholesky_pullback", 8, 4),
                          ("cholesky_pullback_tile", 5, 17)}
    assert times["cholesky_jittered_backward", 8, 4]["ms"] > 0
    assert times["cholesky_pullback", 8, 4]["library_ms"] is None


def test_leaf_pullback_phase_passes_with_twins():
    # K1's backward: on the CPU kernel and twin are the same function; the
    # first shape is two copies of leaf_case's members
    err, times = chip_smoke.phase_leaf_pullback(
        "cpu", shapes=((8, 17), (6, 49)), sets=2, timer=_host_timer,
        dev_timer=_no_device_timer)
    assert err == {"leaf_pullback": 0.0}
    assert set(times) == {("leaf_pullback", 8, 17), ("leaf_pullback", 6, 49)}
    rec = times["leaf_pullback", 8, 17]
    assert rec["ms"] > 0 and rec["plain_ms"] > 0 and rec["bound_ms"] > 0
    assert rec["library_ms"] is None and rec["plain_device_ms"] is None
    # bytes: C, li and Xbar's lower triangles, the mask, fp and two
    # cotangents read; two squares written
    nbytes, flops, flops64 = chip_smoke.work(
        "leaf_pullback", chip_smoke.leaf_pullback_case(
            np.random.default_rng(0), 8, 17, "cpu", sets=2),
        [torch.zeros(8, 17, 17)] * 2)
    assert nbytes == 4 * (3 * 8 * 17 * 18 // 2 + 8 * 17 + 3 * 8
                          + 2 * 8 * 17 * 17)
    assert flops == 8 * 17 ** 3 and flops64 == 8 * 4 * 17 ** 3 / 3


def _fake_profile(recorded, other=0):
    """A ``torch.profiler.profile`` stand-in whose profiles recorded
    ``recorded`` launches of a port kernel (2 us each) and ``other`` of a
    library kernel."""
    import types

    cuda = torch.autograd.DeviceType.CUDA

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            evts = [types.SimpleNamespace(
                device_type=cuda, key="chol_pullback_lanes<8>",
                self_device_time_total=2.0 * recorded, count=recorded)]
            if other:
                evts.append(types.SimpleNamespace(
                    device_type=cuda, key="sm90_gemm",
                    self_device_time_total=1.0 * other, count=other))
            return evts
    return Profile


@pytest.mark.parametrize("recorded, other, want", [
    (100, 0, (0.002, 1.0)), (95, 0, (0.002, 1.0)), (80, 0, (None, 0.8)),
    (95, 5, (None, 1.0))])
def test_device_ms_reads_the_recorded_launches(monkeypatch, recorded, other,
                                               want):
    # all 100 launches recorded: their summed time; 95 of them and nothing
    # else: the mean of those 95 a launch; fewer, or another device
    # activity beside them: not measured
    launched = [0]
    monkeypatch.setattr(torch.profiler, "profile",
                        _fake_profile(recorded, other))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "_spin", lambda: None)
    monkeypatch.setattr(chip_smoke, "_wrapper_launches", lambda: launched[0])

    def call():
        launched[0] += 1

    got = chip_smoke.device_ms(call, reps=100)
    assert got[1] == pytest.approx(want[1])
    if want[0] is None:
        assert got[0] is None
    else:
        assert got[0] == pytest.approx(want[0])


def test_compare_refuses_differing_factors_and_nan_patterns():
    a = torch.tensor([1.0, 2.0])
    with pytest.raises(SystemExit, match="factors differ"):
        chip_smoke.compare("x", (a, a), (a, a + 1), factor_idx={1})
    with pytest.raises(SystemExit, match="non-finite"):
        chip_smoke.compare("x", (torch.tensor([1.0, float("nan")]),),
                           (a,), factor_idx=set())
    with pytest.raises(SystemExit, match="max"):
        chip_smoke.compare("x", (a + 1e-2,), (a,), factor_idx=set())


def test_check_tri_inv_holds_patterns_and_zeros_above_the_diagonal():
    # K3's check: tri_case's members 1-4 are non-finite in the twin; a
    # result with their NaN moved, or a healthy member with a nonzero above
    # its diagonal, fails; the error is the healthy members'
    lt = torch.as_tensor(chip_smoke.tri_case(np.random.default_rng(5), 6,
                                             12))
    want = tl.triangular_inverse_lower_ref(lt)
    assert torch.isfinite(want[0]).all() and torch.isfinite(want[5]).all()
    assert not any(torch.isfinite(want[b]).all() for b in (1, 2, 3, 4))
    assert chip_smoke.check_tri_inv("t", want.clone(), lt) == 0.0
    near = want.clone()
    near[0, 3, 1] += 1e-6
    assert 0 < chip_smoke.check_tri_inv("t", near, lt) < 1e-5
    moved = want.clone()
    moved[2] = torch.where(torch.isnan(moved[2]), torch.inf, moved[2])
    with pytest.raises(SystemExit, match="inf / NaN pattern"):
        chip_smoke.check_tri_inv("t", moved, lt)
    upper = want.clone()
    upper[5, 0, 7] = 1e-30
    with pytest.raises(SystemExit, match="above the diagonal"):
        chip_smoke.check_tri_inv("t", upper, lt)


def test_compare_per_member_holds_each_member_to_its_own_scale():
    # a K2 backward's outputs: a [B, P, P] gradient and the jitter's [B],
    # with member 1 escalated (jitter gradient 1.5e4); dropping the healthy
    # member's jitter gradient passes the whole-output tolerance (1.5) and
    # fails its own (1e-5 + 1e-4 * 1.0)
    abar = torch.full((2, 3, 3), 0.5)
    jbar = torch.tensor([1.0, 1.5e4])
    dropped = torch.tensor([0.0, 1.5e4])
    chip_smoke.compare("x", (abar, dropped), (abar, jbar))
    with pytest.raises(SystemExit, match=r"output 1 .* at \(0,\)"):
        chip_smoke.compare("x", (abar, dropped), (abar, jbar),
                           per_member=True)
    # the escalated member's own scale covers its float32 rounding
    near = torch.tensor([1.0, 1.5e4 + 1.0])
    assert chip_smoke.compare("x", (abar, near), (abar, jbar),
                              per_member=True) == 1.0
    # NaN members (all-fail) carry no scale and still need equal patterns
    nan = torch.tensor([1.0, float("nan")])
    assert chip_smoke.compare("x", (abar, nan), (abar, nan),
                              per_member=True) == 0.0


def _flagship_golden(side):
    """The float64 objective of the phase-5 tree at ``side``^2 locations,
    standing in for its golden."""
    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    return float(MRAModel(
        locs, r=8, M=tpu_shaped_M(len(locs), 8), dtype=torch.float64,
        config=PlanConfig(r=8, kmeans_impl="native"), device="cpu").objective(
            Kernel("exponential", l=0.05), y.astype(np.float64), 1e-2))


def test_main_path_phases_pass_on_small_inputs():
    side = 40
    chip_smoke.reset_counters(tl)
    chip_smoke.phase_n10k("cpu", timer=_host_timer, n_evals=1)
    chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                         golden=_flagship_golden(side), n_evals=1)
    # CPU tensors never launch a kernel or count as twin calls on CUDA
    assert tl.cholesky_jittered.launches == tl.leaf_factor.launches == 0
    assert tl.cholesky_jittered_ref.cuda_calls == 0
    assert tl.leaf_factor_ref.cuda_calls == 0


def _small_golden_gradient():
    """Float64 gradient of the bundled small tree (held to the JAX package
    by tests/test_torch_loglik.py), standing in for the N=10^4 golden."""
    locs, y = load_data("small")
    model = MRAModel(locs, r=4, dtype=torch.float64, device="cpu",
                     config=PlanConfig(r=4, kmeans_impl="native"))
    f = model.loglik_fn(y, 1e-4,
                        kernel_builder=chip_smoke.exponential_builder)
    return chip_smoke.value_and_grad(f, 2.0, 1.0)[1]


def test_gradient_phases_pass_on_small_inputs():
    # the five-point check needs N = 128^2 for its float32 noise to sit
    # well inside the tolerance
    side = 128
    n1m = chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                               golden=_flagship_golden(side), n_evals=1)
    chip_smoke.reset_counters(tl)
    chip_smoke.phase_grad_n10k("cpu", timer=_host_timer, n_evals=1,
                               data="small", M=-1,
                               golden=_small_golden_gradient())
    out = chip_smoke.phase_grad_n1m(n1m, n1m["ms_lik"], "cpu",
                                    timer=_host_timer, n_evals=1)
    for k in ("l", "sig"):
        assert abs(out["ad"][k] - out["fd"][k]) <= (
            chip_smoke.FD_RTOL * abs(out["fd"][k]))
    for name, *_ in chip_smoke.KERNELS:
        assert chip_smoke.launches_of(tl, name) == 0
        wrapper = chip_smoke.wrapper_of(name)[0]
        assert getattr(tl, f"{wrapper}_ref").cuda_calls == 0


def test_gradient_check_rejects_a_dropped_leaf_backward(monkeypatch):
    # the five-point check's tolerance is tight enough to see the leaf
    # stage's gradient go missing
    side = 128
    n1m = chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                               golden=_flagship_golden(side), n_evals=1)
    real = sweep.leaf_factor
    monkeypatch.setattr(sweep, "leaf_factor", lambda *a: tuple(
        t.detach() for t in real(*a)))
    with pytest.raises(SystemExit, match="off the difference"):
        chip_smoke.phase_grad_n1m(n1m, n1m["ms_lik"], "cpu",
                                  timer=_host_timer, n_evals=1)


def test_dense_r_phase_passes_on_the_n10k_tree():
    # the real configuration and its frozen goldens, on the CPU twins
    chip_smoke.reset_counters(tl)
    out = chip_smoke.phase_dense_r("cpu", timer=_host_timer, n_evals=1)
    assert out["ms_full"] > 0 and out["ms_grad"] > 0
    assert all(chip_smoke.launches_of(tl, n) == 0
               for n in chip_smoke.KERNEL_NAMES)


def test_dense_r_phase_rejects_a_dropped_whitening():
    # with R's correlations dropped (its diagonal only) the objective
    # leaves the correlated golden
    real = chip_smoke.correlated_r

    def diagonal_only(locs, device, **kw):
        r = real(locs, device, **kw)
        return torch.diag(torch.diagonal(r))

    chip_smoke.correlated_r = diagonal_only
    try:
        with pytest.raises(SystemExit, match=r"\(b\) objective off"):
            chip_smoke.phase_dense_r("cpu", timer=_host_timer, n_evals=1)
    finally:
        chip_smoke.correlated_r = real


def test_wide_phase_passes_on_small_inputs():
    # the N=10^4 M=3 tree against its frozen golden; the N=10^6 M=6 grid
    # cut to 128^2 at M=3 (64 leaves of 256), the five-point check's size,
    # at l=0.02: at l=0.05 those leaves' float32 loglik is too rough for a
    # five-point difference at this size (6.3e-3 from the gradient, which
    # is 2.8e-4 from float64; tools/float32_wide_leaves.py)
    chip_smoke.reset_counters(tl)
    out = chip_smoke.phase_wide("cpu", timer=_host_timer, n_evals=1,
                                side=128, big_M=3, big_l=0.02, grad_evals=1)
    for k in ("l", "sig"):
        assert abs(out["ad"][k] - out["fd"][k]) <= (
            chip_smoke.FD_RTOL * abs(out["fd"][k]))
    for name in chip_smoke.KERNEL_NAMES:
        assert chip_smoke.launches_of(tl, name) == 0
        wrapper = chip_smoke.wrapper_of(name)[0]
        assert getattr(tl, f"{wrapper}_ref").cuda_calls == 0


def test_script_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU exit")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=chip_smoke.__file__.rsplit("/", 1)[0],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


#: phase 13's runs cut to a few transitions each
SMALL_RUNS = {
    "nuts": {"chains": 2, "num_warmup": 20, "num_samples": 10,
             "max_depth": 5},
    "hmc": {"chains": 2, "num_warmup": 10, "num_samples": 10,
            "num_leapfrog": 4},
    "advi": {"steps": 5, "num_mc": 2},
    "smc": {"n_particles": 16, "n_mutations": 2, "max_stages": 10},
}
TINY_RUNS = {**SMALL_RUNS, "nuts": {"chains": 2, "num_warmup": 6,
                                    "num_samples": 4, "max_depth": 3}}


def test_sampler_phase_passes_on_small_inputs():
    # the bundled small data (N=100) on the CPU twins, every sampler and
    # check of phase 13
    chip_smoke.reset_counters(tl)
    out = chip_smoke.phase_samplers(5.0, "cpu", data="small", M=-1,
                                    runs=SMALL_RUNS, timer=_host_timer)
    assert set(out) >= {"nuts", "hmc", "advi", "smc", "roughness"}
    nuts = out["nuts"]
    assert nuts["evals_per_draw"] >= 1 and nuts["ms_per_eval"] > 0
    for run in (nuts, out["hmc"]):
        assert run["ms_per_eval_alone"] > 0 and run["alone_spread_ms"] >= 0
        assert run["host_ms_per_eval"] == pytest.approx(
            run["ms_per_eval"] - run["ms_per_eval_alone"])
    assert sum(nuts["depth_histogram"]) == 2 * 10
    assert nuts["reeval_rel"] == 0.0 and out["hmc"]["reeval_rel"] == 0.0
    assert out["smc"]["betas"][-1] == 1.0
    assert set(out["roughness"]) == set(chip_smoke.ROUGH_RS)
    for rough in out["roughness"].values():
        assert rough["roughness"] >= 0 and rough["sd"] > 0
    for name in chip_smoke.KERNEL_NAMES:
        assert chip_smoke.launches_of(tl, name) == 0
        wrapper = chip_smoke.wrapper_of(name)[0]
        assert getattr(tl, f"{wrapper}_ref").cuda_calls == 0


def _stale_gradient(logp):
    """The right value with the previous call's gradient."""
    last = {}

    def wrapped(theta):
        value = logp(theta)
        params = [theta[k] for k in chip_smoke.SAMPLER_PARAMS]
        grad = torch.autograd.grad(value, params, retain_graph=True)
        prev = last.get("grad", grad)
        last["grad"] = grad
        return value.detach() + sum((t - t.detach()) * g
                                    for t, g in zip(params, prev))

    return wrapped


def _drifting_value(logp):
    """A value that moves by 1e-3 with every call."""
    calls = [0]

    def wrapped(theta):
        calls[0] += 1
        return logp(theta) + 1e-3 * calls[0]

    return wrapped


@pytest.mark.parametrize("wrap", [_stale_gradient, _drifting_value])
def test_sampler_phase_rejects_a_stale_log_prob(wrap):
    with pytest.raises(SystemExit, match="at the last draw"):
        chip_smoke.phase_samplers(5.0, "cpu", data="small", M=-1,
                                  runs=TINY_RUNS, mle_steps=3,
                                  timer=_host_timer, wrap=wrap)


def test_n1m_nuts_phase_passes_on_small_inputs():
    side = 40
    n1m = chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                               golden=_flagship_golden(side), n_evals=1)
    out = chip_smoke.phase_nuts_n1m(
        n1m, {"l": 0.05, "sig": 1.0}, 5.0, "cpu",
        run={"chains": 2, "num_warmup": 4, "num_samples": 4,
             "max_depth": 3}, timer=_host_timer)
    assert out["evals_per_draw"] >= 1 and np.isfinite(out["roughness"])
    assert sum(out["depth_histogram"]) == 2 * 4


# ---------------------------------------------------------------------------
# phases 15-19: the side paths, on the bundled small data (N=100)
# ---------------------------------------------------------------------------

def _small_side_goldens():
    """Float64 goldens of the bundled small tree for phases 15-18, from the
    port's float64 path (held to the JAX package by the port's other
    tests): the objective of the facade's tree (phases 15, 17), and the
    objective and gradient at l=2, sig=1 of the natively planned tree for
    the Matern at each of phase 16's R and the exponential (phase 18)."""
    from tests.test_golden_anchors import BUNDLED_SMALL_OBJECTIVE

    locs, y = load_data("small")
    model = MRAModel(locs, r=4, dtype=torch.float64, device="cpu",
                     config=PlanConfig(r=4, kmeans_impl="native"))
    n_obs = int(np.isfinite(y).sum())

    def golden(builder, R):
        f = model.loglik_fn(y, R, kernel_builder=builder)
        value, grad = chip_smoke.value_and_grad(f, 2.0, 1.0)
        return {"objective": -2.0 * value - n_obs * np.log(2.0 * np.pi),
                **grad}

    exp = golden(chip_smoke.exponential_builder, 1e-4)
    return {"facade": BUNDLED_SMALL_OBJECTIVE,
            "matern": {R: golden(chip_smoke.matern_builder, R)
                       for R in chip_smoke.GOLDEN_MATERN_N10K},
            "tri": exp["objective"],
            "tri_grad": {k: exp[k] for k in ("l", "sig")}}


SMALL = dict(data="small", M=-1)
#: phase 18's roughness points on the small tree: l, sig near its MLE
SMALL_ROUGH = {1e-2: {"mle": {"l": 2.0, "sig": 1.0}, "sd": 0.05}}


def _side_phases(goldens, tmp_path, over=None):
    """Phases 15-18 on the small tree, ``over`` ({phase: golden})
    replacing a phase's goldens."""
    over = over or {}
    kw = dict(SMALL, timer=_host_timer)
    out = {
        15: chip_smoke.phase_matrix_cov(
            "cpu", n_evals=1, golden=over.get(15, goldens["facade"]),
            ms_coord=1.0, **kw),
        16: chip_smoke.phase_matern(
            "cpu", dev_timer=_no_device_timer, n_evals=1,
            golden=over.get(16, goldens["matern"]), **kw),
        17: chip_smoke.phase_keep_internals(
            "cpu", n_evals=1, golden=over.get(17, goldens["facade"]),
            out_dir=str(tmp_path), **kw),
        18: chip_smoke.phase_tri_route(
            "cpu", n_evals=1, golden=over.get(18, goldens["tri"]),
            golden_grad=goldens["tri_grad"], rough=SMALL_ROUGH, **kw),
    }
    return out


def test_side_path_phases_pass_on_small_inputs(tmp_path):
    chip_smoke.reset_counters(tl)
    out = _side_phases(_small_side_goldens(), tmp_path)
    assert out[15]["ms"] > 0 and out[16]["ms_grad"] > 0
    assert out[17]["t_basis"] > 0
    assert set(out[18]) == set(chip_smoke.ROUTES)
    assert all(r["roughness_0.01"] >= 0 for r in out[18].values())
    # the drawing (matplotlib here), or the arrays it draws
    assert list(tmp_path.glob("phase17_basis_functions.res*"))
    for name in chip_smoke.KERNEL_NAMES:
        assert chip_smoke.launches_of(tl, name) == 0
        wrapper = chip_smoke.wrapper_of(name)[0]
        assert getattr(tl, f"{wrapper}_ref").cuda_calls == 0
    assert "PYMRA_LEAF_SOLVE" not in __import__("os").environ


@pytest.mark.parametrize("phase", [15, 16, 17, 18])
def test_side_path_phases_reject_a_wrong_golden(phase, tmp_path):
    goldens = _small_side_goldens()
    wrong = {15: goldens["facade"] * 1.005, 17: goldens["facade"] * 1.005,
             18: goldens["tri"] * 1.005,
             16: {R: {**g, "objective": g["objective"] * 1.005}
                  for R, g in goldens["matern"].items()}}
    with pytest.raises(SystemExit, match="off its golden"):
        _side_phases(goldens, tmp_path, {phase: wrong[phase]})


@pytest.mark.parametrize("phase", [16, 18])
def test_side_path_phases_reject_a_dropped_gradient(phase, monkeypatch):
    # phase 16: the Matern's gradient in l through its Bessel K dropped;
    # phase 18: the triangular route's prior log-determinant (K6) detached
    import pymra_torch.kernels as tk

    goldens = _small_side_goldens()
    if phase == 16:
        real = tk.matern_general
        monkeypatch.setattr(tk, "matern_general", lambda d, l, sig, nu: (
            real(d, l.detach(), sig, nu) + 0.0 * l))
        run = lambda: chip_smoke.phase_matern(  # noqa: E731
            "cpu", dev_timer=_no_device_timer, n_evals=1,
            golden=goldens["matern"], timer=_host_timer, **SMALL)
    else:
        real = sweep.cholesky_logdet
        monkeypatch.setattr(sweep, "cholesky_logdet", lambda m, j: tuple(
            t.detach() for t in real(m, j)))
        run = lambda: chip_smoke.phase_tri_route(  # noqa: E731
            "cpu", n_evals=1, golden=goldens["tri"],
            golden_grad=goldens["tri_grad"], timer=_host_timer, **SMALL)
    with pytest.raises(SystemExit, match="off its golden"):
        run()


def test_kernel_phase_checks_and_times_the_side_shapes():
    # K2 and K6 recorded under (name, b, p), K5 under (name, b, p, q), each
    # held to its twin and timed beside its library call
    _, times = chip_smoke.phase_kernels(
        "cpu", ragged=5, chol_main=((6, 3),), leaf_main=((5, 16),),
        tri_main=((5, 16),), solve_main=((6, 3, 1, False),),
        logdet_main=((5, 9),), wide_widths=(65,), wide_main=((6, 70),),
        timer=_host_timer, dev_timer=_no_device_timer,
        chol_side=((4, 49),), solve_side=((4, 49, 16, False),
                                          (3, 20, 20, True)),
        logdet_side=((4, 33),))
    for key in (("cholesky_jittered", 4, 49), ("cholesky_jittered_clean", 4,
                                                 49),
                ("solve_triangular_batched", 4, 49, 16),
                ("solve_triangular_batched", 3, 20, 20),
                ("cholesky_logdet", 4, 33), ("cholesky_logdet_clean", 4, 33)):
        assert times[key]["ms"] > 0 and times[key]["library_ms"] > 0
    # K7 shares K6's loop but is timed at the main shapes only
    assert ("cholesky_inv_logdet", 4, 33) not in times


@pytest.fixture(scope="module")
def tri_n1m_inputs():
    """Phase 5 on a 128^2 grid (leaves of 64; the five-point check's
    float32 noise sits well inside its tolerance there, as in phase 8's
    rehearsal) and its float64 objective as the golden."""
    side = 128
    golden = _flagship_golden(side)
    return chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                                golden=golden, n_evals=1), golden


def test_tri_n1m_phase_passes_on_small_inputs(tri_n1m_inputs):
    # the objective, the likelihood-only and value-and-gradient timings on
    # both routes, the triangular route's gradient against the difference
    n1m, golden = tri_n1m_inputs
    out = chip_smoke.phase_tri_n1m(n1m, "cpu", timer=_host_timer,
                                   golden=golden, n_evals=1, n_grad=1,
                                   pairs=2)
    for key in ("ms_fwd", "ms_grad"):
        assert set(out[key]) == set(chip_smoke.ROUTES)
    assert all(len(v) == 2 for v in out["ms_grad"].values())
    for k in ("l", "sig"):
        assert abs(out["ad"][k] - out["fd"][k]) <= (
            chip_smoke.FD_RTOL * abs(out["fd"][k]))


def test_tri_n1m_phase_rejects_a_wrong_leaf_pullback(tri_n1m_inputs,
                                                     monkeypatch):
    # K2's backward at the leaves (the pullback above P = 8, the card's
    # pullback mode) returning half its Abar: the triangular route's
    # gradient leaves the five-point difference
    n1m, golden = tri_n1m_inputs
    real = tl.cholesky_pullback

    def half(l, lbar, ldbar=None, f=None):
        abar, jbar = real(l, lbar, ldbar, f)
        if tl.jittered_tier(l.shape[-1]) == 0:
            return abar, jbar
        return 0.5 * abar, None if jbar is None else 0.5 * jbar

    half.launches = half.tile_launches = 0  # the wrapper's counters
    monkeypatch.setattr(tl, "cholesky_pullback", half)
    with pytest.raises(SystemExit, match="off the difference"):
        chip_smoke.phase_tri_n1m(n1m, "cpu", timer=_host_timer,
                                 golden=golden, n_evals=1, n_grad=1,
                                 pairs=1)


# ---------------------------------------------------------------------------
# phases 20, 20b: the sharded paths, on gloo worlds of CPU processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_inputs():
    """Phase 5 on a 64^2 grid (interior levels shard at 2 ranks), its
    float64 objective as the golden, and the serial gradient standing in
    for phase 8's."""
    side = 64
    golden = _flagship_golden(side)
    n1m = chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                               golden=golden, n_evals=1)
    f = n1m["model"].loglik_fn(n1m["y"], 1e-2,
                               kernel_builder=chip_smoke.exponential_builder)
    _, g = chip_smoke.value_and_grad(f, 0.05, 1.0)
    return n1m, {"ad": {"l": 0.05 * g["l"], "sig": g["sig"]}}, golden


def test_sharded_phase_passes_on_small_inputs(sharded_inputs):
    from pymra_torch.utils.accounting import sweep_cost

    n1m, grad, golden = sharded_inputs
    ranks = chip_smoke.phase_sharded(n1m, grad, "cpu", golden=golden,
                                     n_evals=1)
    assert len(ranks) == chip_smoke.SHARD_RANKS
    cost = sweep_cost(n1m["model"].dplan, int_shard_from=2)
    for o in ranks:
        assert o["crit"] == 2
        # one transition message per forward: the cost model's bytes
        msgs = o["collectives"]["messages"]
        assert msgs["bytes"] == msgs["calls"] * cost.psum_bytes_per_level[0][1]
        assert set(o["launches"]) == set(chip_smoke.KERNEL_NAMES)


@pytest.mark.parametrize("fault", chip_smoke.FAULTS)
def test_sharded_phase_rejects_an_injected_fault(fault, sharded_inputs):
    # a rank that leaves its messages out of the transition level's sum;
    # a gradient without the cross-rank mean
    n1m, grad, golden = sharded_inputs
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.phase_sharded(n1m, grad, "cpu", golden=golden,
                                 n_evals=1, fault=fault)


def test_chains_phase_passes_on_small_inputs():
    ranks = chip_smoke.phase_chains({"l": 2.0, "sig": 1.0}, "cpu",
                                    data="small", M=-1)
    assert len(ranks) == 4
    for o in ranks:
        assert len(o["gathered"]["log_prob"]) == chip_smoke.CHAIN_MESH["chain"]
        assert o["evals"] >= chip_smoke.CHAIN_RUN["num_warmup"]


# ---------------------------------------------------------------------------
# phases 13c-13e: parameter sets batched through one sweep
# ---------------------------------------------------------------------------

N1M_SMALL_NUTS = {"chains": 2, "num_warmup": 4, "num_samples": 4,
                  "max_depth": 3}


@pytest.fixture(scope="module")
def batched_inputs():
    """Phase 5 at a 40^2 grid and phase 13 (small runs, no roughness) on
    the bundled small data: what phases 13c-13e take; phase 13b's report
    (which 13e prints beside its own) as its test above leaves it."""
    chip_smoke.reset_counters(tl)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, for the module's setup
    try:
        side = 40
        n1m = chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                                   golden=_flagship_golden(side), n_evals=1)
        serial = chip_smoke.phase_samplers(5.0, "cpu", data="small", M=-1,
                                           runs=SMALL_RUNS,
                                           timer=_host_timer, rough_rs=())
        nuts_n1m = {"ms_per_draw": 200.0, "evals_per_draw": 2.0}
    finally:
        torch.set_num_threads(threads)
    return n1m, serial, nuts_n1m


def _phase_13c(n1m):
    return chip_smoke.phase_batched(n1m, "cpu", timer=_host_timer,
                                    data="small", M=-1, n_evals=1)


def test_batched_phase_passes_on_small_inputs(batched_inputs):
    out = _phase_13c(batched_inputs[0])
    for tree in ("n10k", "n1m"):
        run = out[tree]
        assert run["worst"]["value"] <= chip_smoke.BATCH_OBJ_RTOL
        assert run["worst"]["grad"] <= chip_smoke.BATCH_GRAD_RTOL
        assert run["ms_batch"] > 0 and run["ms_single"] > 0
        # on the CPU no kernel launches, batched or not
        assert set(run["launches"].values()) == {0}


@pytest.fixture(scope="module")
def n1m_64():
    """Phase 5 at a 64^2 grid: 64 leaves of 64 (K1's route)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, for the module's setup
    try:
        return chip_smoke.phase_n1m("cpu", timer=_host_timer, side=64,
                                    golden=_flagship_golden(64), n_evals=1)
    finally:
        torch.set_num_threads(threads)


def test_leaf_pullback_n1m_phase_passes_on_small_inputs(n1m_64,
                                                        monkeypatch):
    calls = []
    real = tl.leaf_pullback
    monkeypatch.setattr(tl, "leaf_pullback",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    out = chip_smoke.phase_leaf_pullback_n1m(n1m_64, "cpu",
                                             timer=_host_timer, n_evals=1)
    assert out["worst"] == {"value": 0.0, "grad": 0.0}
    assert [len(v) for v in out["ms"].values()] == [2, 2]
    # the batched backward reached K1's backward once an evaluation, at
    # the four sets' leaves of 64
    assert calls and set(calls) == {(4, 64, 64, 64)}


def test_leaf_pullback_n1m_phase_rejects_a_wrong_backward(n1m_64,
                                                          monkeypatch):
    # K1's backward with A_oo's cotangent halved: the gradient leaves the
    # twin's
    real = tl.leaf_pullback
    monkeypatch.setattr(tl, "leaf_pullback", lambda *a: (
        lambda cbar, abar: (cbar, 0.5 * abar))(*real(*a)))
    with pytest.raises(SystemExit, match="off the twin's"):
        chip_smoke.phase_leaf_pullback_n1m(n1m_64, "cpu",
                                           timer=_host_timer, n_evals=1)


def test_batched_phase_rejects_a_batch_out_of_order(batched_inputs,
                                                    monkeypatch):
    # the batched loglik with its sets rolled: each value is another set's
    real = MRAModel.loglik_fn

    def rolled(self, *a, batched=False, **k):
        f = real(self, *a, batched=batched, **k)
        return (lambda th: f(th).roll(1)) if batched else f

    monkeypatch.setattr(MRAModel, "loglik_fn", rolled)
    with pytest.raises(SystemExit, match="batched loglik off"):
        _phase_13c(batched_inputs[0])


def test_batched_sampler_phases_pass_on_small_inputs(batched_inputs):
    n1m, serial, nuts_n1m = batched_inputs
    out = chip_smoke.phase_samplers_batched(serial, "cpu", runs=SMALL_RUNS)
    for name in ("nuts", "hmc"):
        run = out[name]
        assert run["reeval_rel"] == 0.0
        # lockstep: a transition costs the most points among its chains
        assert run["calls_per_transition"] >= run["evals_per_draw"] >= 1
        assert run["ms_per_draw"] > 0
    # SMC evaluates its particles in one call each time
    assert out["smc"]["calls"] < serial["smc"]["evals"]
    assert np.isfinite(out["advi"]["elbo_last"])
    chains = chip_smoke.N1M_BATCHED_NUTS["chains"]
    nb = chip_smoke.phase_nuts_n1m_batched(
        n1m, {"l": 0.05, "sig": 1.0}, nuts_n1m, "cpu",
        run={**N1M_SMALL_NUTS, "chains": chains})
    assert nb["reeval_rel"] == 0.0 and sum(nb["depth_histogram"]) == (
        chains * N1M_SMALL_NUTS["num_samples"])
    for name in chip_smoke.KERNEL_NAMES:
        wrapper = chip_smoke.wrapper_of(name)[0]
        assert getattr(tl, f"{wrapper}_ref").cuda_calls == 0


def test_batched_sampler_phase_rejects_a_drifting_log_prob(batched_inputs):
    with pytest.raises(SystemExit, match="at the last draw"):
        chip_smoke.phase_samplers_batched(batched_inputs[1], "cpu",
                                          runs=TINY_RUNS,
                                          wrap=_drifting_value)


# ---------------------------------------------------------------------------
# phases 13f, 10b, 17b, 20c: the posterior, dense R, keep_internals and the
# sharded sweep under a batch of parameter sets
# ---------------------------------------------------------------------------

def _set0_posterior(monkeypatch):
    """Fault: the batched posterior of set 0 written into every set."""
    real = sweep._posterior

    def set0(*a, **k):
        mean, var = real(*a, **k)
        if mean.dim() > 1:
            mean, var = mean[:1].expand_as(mean), var[:1].expand_as(var)
        return mean, var

    monkeypatch.setattr(sweep, "_posterior", set0)


def _phase_13f(n1m):
    return chip_smoke.phase_batched_posterior(
        n1m, "cpu", timer=_host_timer, dev_timer=_no_device_timer,
        data="small", M=-1, n_evals=1,
        golden_n10k=_small_side_goldens()["tri"],
        golden_n1m=_flagship_golden(40))


def test_batched_posterior_phase_passes_on_small_inputs(batched_inputs):
    out = _phase_13f(batched_inputs[0])
    for tree in ("n10k", "n1m"):
        run = out[tree]
        assert run["objective"] <= chip_smoke.BATCH_OBJ_RTOL
        assert run["mean"].shape[0] == len(chip_smoke.POST_BATCH_N10K["l"])
        # on the CPU no kernel launches, batched or not
        assert set(run["launches"].values()) == {0}


def test_batched_posterior_phase_rejects_set_0_in_every_set(
        batched_inputs, monkeypatch):
    _set0_posterior(monkeypatch)
    with pytest.raises(SystemExit, match="posterior (mean|var) off"):
        _phase_13f(batched_inputs[0])


def _small_dense():
    """Phase 10 on the bundled small tree (its grid spacing 1/9 as the
    correlation length) against the port's float64 objective and gradient
    there, standing in for the frozen goldens."""
    locs, y = load_data("small")
    model = MRAModel(locs, r=4, dtype=torch.float64, device="cpu",
                     config=PlanConfig(r=4, kmeans_impl="native"))
    R = chip_smoke.correlated_r(locs, "cpu", rho=1 / 9).double()
    g = chip_smoke.sweep_value_and_grad(model, y, R, 2.0, 1.0)
    return chip_smoke.phase_dense_r(
        "cpu", timer=_host_timer, n_evals=1, data="small", M=-1, rho=1 / 9,
        golden_diag=float(model.objective(Kernel("exponential", l=2.0), y,
                                          1e-4)),
        golden={k: g[k] for k in ("objective", "l", "sig")}), g


def test_dense_r_batched_phase_passes_on_small_inputs():
    dense, g = _small_dense()
    out = chip_smoke.phase_dense_r_batched(
        dense, "cpu", timer=_host_timer, n_evals=1,
        golden={k: g[k] for k in ("objective", "l", "sig")})
    assert out["worst"]["loglik"] <= chip_smoke.BATCH_OBJ_RTOL
    assert set(out["launches"].values()) == {0}


def test_dense_r_batched_phase_rejects_set_0s_whitened_basis(monkeypatch):
    dense, g = _small_dense()
    real = sweep._shared_solve

    def set0(L, B, nd, kernel):
        X = real(L, B, nd, kernel)
        return X[:1].expand_as(X) if nd else X

    monkeypatch.setattr(sweep, "_shared_solve", set0)
    # set 0's gradient takes the other sets' share: off its golden
    with pytest.raises(SystemExit, match="off (its golden|float64)"):
        chip_smoke.phase_dense_r_batched(
            dense, "cpu", timer=_host_timer, n_evals=1,
            golden={k: g[k] for k in ("objective", "l", "sig")})


def _phase_17b():
    from tests.test_golden_anchors import BUNDLED_SMALL_OBJECTIVE

    return chip_smoke.phase_keep_internals_batched(
        "cpu", timer=_host_timer, n_evals=1, golden=BUNDLED_SMALL_OBJECTIVE,
        **SMALL)


def test_keep_internals_batched_phase_passes_on_small_inputs():
    out = _phase_17b()
    assert out["objective"] <= chip_smoke.BATCH_OBJ_RTOL
    assert out["stash"] <= 1e-6


def test_keep_internals_batched_phase_rejects_set_0_in_every_set(
        monkeypatch):
    _set0_posterior(monkeypatch)
    with pytest.raises(SystemExit, match="off the single sweeps"):
        _phase_17b()


def _batch13c(n1m):
    """Phase 13c's N=10^6 serial batch, on the rehearsal's grid."""
    f = n1m["model"].loglik_fn(n1m["y"], chip_smoke.SAMPLER_R,
                               kernel_builder=chip_smoke.exponential_builder,
                               batched=True)
    values, grads = chip_smoke.batched_value_and_grad(f, chip_smoke.BATCH_N1M)
    return {"values": values.tolist(),
            "grads": {k: v.tolist() for k, v in grads.items()}}


def test_sharded_batched_phase_passes_on_small_inputs(sharded_inputs):
    n1m = sharded_inputs[0]
    ranks = chip_smoke.phase_sharded_batched(n1m, _batch13c(n1m), "cpu",
                                             n_evals=1)
    assert len(ranks) == chip_smoke.SHARD_RANKS
    assert ranks[0]["worst"]["grad"] <= chip_smoke.SHARD_GRAD_RTOL
    chains = chip_smoke.phase_chains({"l": 2.0, "sig": 1.0}, "cpu",
                                     data="small", M=-1,
                                     lockstep=chip_smoke.LOCKSTEP_CHAINS)
    for o in chains:
        assert len(o["accept"]) == chip_smoke.LOCKSTEP_CHAINS
        # lockstep: one batched call a step for both chains of the rank
        assert o["rows"] > o["evals"] >= chip_smoke.CHAIN_RUN["num_warmup"]


def test_sharded_batched_phase_rejects_a_dropped_set(sharded_inputs):
    # rank 1 leaves set 1 of the batch out of its partial sums
    n1m = sharded_inputs[0]
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.phase_sharded_batched(n1m, _batch13c(n1m), "cpu",
                                         n_evals=1, fault="set1")
