"""K3 ``triangular_inverse_lower`` at both of its widths on the card —
``tri_inv.cu`` (the register-tiled core's inverse mode) up to 64 and
``tri_inv_wide.cu`` for 64 < P <= 256 — held here by what runs on the CPU.

* The twin against the JAX K3 on its Pallas route (``PYMRA_PALLAS=force``,
  float32, batch >= 128, 8 < P <= 80: ``_tri_inv_impl`` takes the lane
  kernel, interpreted on the CPU as ``tests/test_pallas.py`` runs it),
  members with an exactly zero diagonal entry and with a NaN included:
  identical inf and NaN patterns (both spread them over whole rows), the
  finite entries within rtol 1e-4 / atol 1e-5 (float32 rounding of the same
  operations).
* The whole-row substitution the kernels run for such members
  (``chol_tile::substitute``, with ``chol_tile::regular`` deciding who
  takes it), compiled from the shipped header on the host without
  contraction: bit for bit the twin, inf and NaN included.
* The width dispatch and the counters on ``meta`` tensors, with the
  library replaced by a recorder: one launch of the tiled kernel up to 64
  (at ``tile_tier(P)``), one of the wide kernel for 65..256, the
  composition over the tiled kernel above 256 (``.composed``); on the CPU
  the composition over the twin, no counter moved.
"""
import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import chip_smoke
from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
PALLAS_WIDTHS = [9, 17, 33, 48, 49, 64]
BATCH = 128


def _case(p, seed=0):
    """``chip_smoke.lower_case`` with member 1's diagonal entry P // 2 set to
    zero and a NaN below member 2's diagonal."""
    lt = chip_smoke.lower_case(np.random.default_rng(seed + p), BATCH, p)
    lt[1, p // 2, p // 2] = 0.0
    lt[2, p - 1, min(3, p - 1)] = np.nan
    return lt


def _same_pattern(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL + RTOL * np.abs(want[fin]).max())


@pytest.mark.parametrize("p", PALLAS_WIDTHS)
def test_twin_matches_the_pallas_kernel(monkeypatch, p):
    lt = _case(p)
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        assert jl.pallas_available()
        want = np.asarray(jl.triangular_inverse_lower(jnp.asarray(lt)))
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()
    got = tl.triangular_inverse_lower(torch.as_tensor(lt)).numpy()
    _same_pattern(got, want)
    # the zero and the NaN spread above the diagonal of their rows too;
    # the healthy members keep exact zeros there
    assert not np.isfinite(got[1][p // 2:]).any()
    assert np.isnan(got[2][p - 1]).all()
    assert (np.triu(got[3:], 1) == 0).all()


# ---------------------------------------------------------------------------
# the whole-row substitution, from the shipped header on the host
# ---------------------------------------------------------------------------

_HOST_CUDA = """#pragma once
#include <math.h>
#define __device__
#define __forceinline__ inline
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx;
inline void __syncthreads() {}
"""
_HOST_MAIN = """#include "chol_tile.cuh"
// each member by substitute() (one thread's loop over every column) where
// regular() refuses an entry of its lower triangle; ok[b] = 1 where not
extern "C" void invert(const float* l, float* x, int* ok, long batch,
                       int p) {
  for (long b = 0; b < batch; ++b) {
    const float* lb = l + b * p * p;
    bool reg = true;
    for (int i = 0; i < p; ++i)
      for (int k = 0; k <= i; ++k)
        reg &= chol_tile::regular(lb[i * p + k], i == k);
    ok[b] = reg;
    if (!reg) chol_tile::substitute(lb, x + b * p * p, p, p, 0, 1);
  }
}
"""


@pytest.fixture(scope="module")
def host_invert(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from pymra_torch.ops.cuda import build

    tmp = tmp_path_factory.mktemp("tri_inv_host")
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    (tmp / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp / "main.cpp").write_text(_HOST_MAIN)
    so = tmp / "libtriinv.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(tmp), "-I", csrc,
                    str(tmp / "main.cpp"), "-o", str(so)], check=True)
    fn = ctypes.CDLL(str(so)).invert
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]

    def invert(lt):
        lt = np.ascontiguousarray(lt, np.float32)
        x = np.zeros_like(lt)
        ok = np.zeros(len(lt), np.int32)
        fn(lt.ctypes.data, x.ctypes.data, ok.ctypes.data, len(lt),
           lt.shape[-1])
        return x, ok.astype(bool)
    return invert


@pytest.mark.parametrize("p", [1, 5, 17, 64, 100])
def test_core_substitution_is_the_twin(host_invert, p):
    # chip_smoke's K3 members: healthy, a zero diagonal entry, a NaN, a
    # subnormal diagonal entry and an inverse that overflows from finite
    # entries in range; the core takes the first and the last, the
    # substitution the others, bit for bit the twin's
    lt = chip_smoke.tri_case(np.random.default_rng(p), 6, p)
    x, ok = host_invert(lt)
    np.testing.assert_array_equal(ok, [True, False, False, False, True,
                                       True])
    want = tl.triangular_inverse_lower_ref(torch.as_tensor(lt)).numpy()
    for b in np.flatnonzero(~ok):
        np.testing.assert_array_equal(x[b], want[b])
        assert not np.isfinite(want[b]).all()
    if p >= 3:  # three diagonal entries of 1e-20: the overflow, in the core
        assert not np.isfinite(want[4]).all()


def test_core_refuses_what_the_quotient_does_not_divide(host_invert):
    # regular(): a diagonal entry in [2^-126, 2^126], every entry finite
    diag = [1.0, -1.0, 2.0 ** -126, 2.0 ** 126, -(2.0 ** 126), 0.0, -0.0,
            1e-39, 2.0 ** 127, np.inf, np.nan]
    lt = np.stack([np.array([[d, 0.0], [0.5, 1.0]]) for d in diag]
                  + [np.array([[1.0, 0.0], [v, 1.0]])
                     for v in (3e38, np.inf, -np.inf, np.nan)])
    # the entry above the diagonal is never read
    lt[:, 0, 1] = np.nan
    _, ok = host_invert(lt)
    np.testing.assert_array_equal(
        ok, [True] * 5 + [False] * 6 + [True, False, False, False])


# ---------------------------------------------------------------------------
# the width dispatch on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The kernel library replaced by a recorder; ``meta`` tensors stand
    in for CUDA ones (the device check is skipped)."""
    calls = []
    lib = types.SimpleNamespace(
        pymra_tri_inv=lambda l, x, n, p, tier, dev, stream: calls.append(
            ("tri_inv", n, p, tier)) or 0,
        pymra_tri_inv_wide=lambda l, x, n, p, dev, stream: calls.append(
            ("tri_inv_wide", n, p)) or 0)
    monkeypatch.setattr(tl, "_on_card", lambda name, mat: None)
    monkeypatch.setattr(tl.build, "load_library", lambda: lib)
    monkeypatch.setattr(tl, "_where", lambda t: (0, 0))
    for attr in ("launches", "wide_launches", "composed"):
        monkeypatch.setattr(tl.triangular_inverse_lower, attr, 0)
    return calls


def _meta(b, p):
    return torch.empty((b, p, p), device="meta")


def _counts():
    f = tl.triangular_inverse_lower
    return f.launches, f.wide_launches, f.composed


def test_dispatch_one_launch_a_call_by_width(recorded):
    for p in (1, 16, 17, 49, 64):
        assert tl._tri_inv_fwd(_meta(3, p)).shape == (3, p, p)
    assert recorded == [("tri_inv", 3, p, tl.tile_tier(p))
                        for p in (1, 16, 17, 49, 64)]
    assert _counts() == (5, 0, 0)
    recorded.clear()
    for p in (65, 128, 169, 256):
        assert tl._tri_inv_fwd(_meta(2, p)).shape == (2, p, p)
    assert recorded == [("tri_inv_wide", 2, p) for p in (65, 128, 169, 256)]
    assert _counts() == (5, 4, 0)
    # an empty batch launches nothing
    tl._tri_inv_fwd(_meta(0, 96))
    assert _counts() == (5, 4, 0)


def test_dispatch_composes_above_256(recorded):
    # 257 splits at 192 (and 192 at 128, 128 at 64), 65 at 64: every
    # diagonal block goes to the tiled kernel, the rest to matmuls
    out = tl._tri_inv_fwd(_meta(2, 257))
    assert out.shape == (2, 257, 257)
    assert recorded == [("tri_inv", 2, 64, 64)] * 4 + [("tri_inv", 2, 1, 16)]
    assert _counts() == (5, 0, 1)


@pytest.mark.parametrize("make, match", [
    (lambda: torch.empty((2, 96, 96), dtype=torch.float64, device="meta"),
     "takes float32"),
    (lambda: torch.empty((2, 40, 40), device="meta").transpose(-1, -2),
     "contiguous"),
    (lambda: torch.empty((2, 0, 0), device="meta"), "outside 1..256")])
def test_launch_refuses_inputs_the_kernels_do_not_take(recorded, make,
                                                       match):
    with pytest.raises((TypeError, ValueError), match=match):
        tl._tri_inv_launch(make())
    assert recorded == []


def test_cpu_runs_the_composition_over_the_twin(monkeypatch):
    # the JAX package's _tri_inv_recursive structure above 64, the twin
    # itself up to 64; nothing counted, no twin call counted as on a card
    rng = np.random.default_rng(3)
    before = _counts(), tl.triangular_inverse_lower_ref.cuda_calls
    for p in (40, 130):
        lt = torch.as_tensor(chip_smoke.lower_case(rng, 4, p))
        got = tl.triangular_inverse_lower(lt)
        want = tl._tri_inv_blocked(lt, tl.triangular_inverse_lower_ref)
        assert torch.equal(got, want)
        if p <= tl.MAX_P:
            assert torch.equal(got, tl.triangular_inverse_lower_ref(lt))
        else:
            _same_pattern(got.numpy(),
                          tl.triangular_inverse_lower_ref(lt).numpy())
    assert (_counts(), tl.triangular_inverse_lower_ref.cuda_calls) == before
