"""``chip_smoke.py`` rehearsed on the CPU at tiny sizes.

On the CPU every wrapper runs its plain twin, so these runs check the
script's control flow, its test matrices (escalated, exact-zero, all-fail
and masked members) and its checks — not the CUDA kernels, which only the
card runs. Timings here come from a host clock and mean nothing.
"""
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from pymra_torch import Kernel, MRAModel, PlanConfig
from pymra_torch.ops import linalg as tl
from pymra_torch.tree.plan import tpu_shaped_M
from pymra_torch.utils import gen_locations_2d


def _host_timer(fn, reps=10):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def test_kernel_phase_passes_with_twins():
    err, times = chip_smoke.phase_kernels(
        "cpu", ragged=9, chol_main=((8, 4),), leaf_main=((6, 17),),
        timer=_host_timer)
    assert err == {"cholesky_jittered": 0.0, "leaf_factor": 0.0}
    assert set(times) == {("cholesky_jittered", 8, 4),
                          ("leaf_factor", 6, 17)}


def test_compare_refuses_differing_factors_and_nan_patterns():
    a = torch.tensor([1.0, 2.0])
    with pytest.raises(SystemExit, match="factors differ"):
        chip_smoke.compare("x", (a, a), (a, a + 1), factor_idx={1})
    with pytest.raises(SystemExit, match="non-finite"):
        chip_smoke.compare("x", (torch.tensor([1.0, float("nan")]),),
                           (a,), factor_idx=set())
    with pytest.raises(SystemExit, match="max"):
        chip_smoke.compare("x", (a + 1e-2,), (a,), factor_idx=set())


def test_main_path_phases_pass_on_small_inputs():
    side = 40
    locs = gen_locations_2d(side)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(len(locs)).astype(np.float32)
    y[rng.random(len(locs)) > 0.9] = np.nan
    golden = float(MRAModel(
        locs, r=8, M=tpu_shaped_M(len(locs), 8), dtype=torch.float64,
        config=PlanConfig(r=8, kmeans_impl="native")).objective(
            Kernel("exponential", l=0.05), y.astype(np.float64), 1e-2))
    chip_smoke.reset_counters(tl)
    chip_smoke.phase_n10k("cpu", timer=_host_timer, n_evals=1)
    chip_smoke.phase_n1m("cpu", timer=_host_timer, side=side,
                         golden=golden, n_evals=1)
    # CPU tensors never launch a kernel or count as twin calls on CUDA
    assert tl.cholesky_jittered.launches == tl.leaf_factor.launches == 0
    assert tl.cholesky_jittered_ref.cuda_calls == 0
    assert tl.leaf_factor_ref.cuda_calls == 0


def test_script_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU exit")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=chip_smoke.__file__.rsplit("/", 1)[0],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
