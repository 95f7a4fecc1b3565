"""K5 ``solve_triangular_batched`` and KP ``cholesky_pullback`` at 9 <= P
<= 64 on the card — ``tri_solve.cu``, the register-tiled core's solve and
pullback modes — held here by what runs on the CPU.

* The core's solve mode (``chol_tile::solve``: the tile map of L, X on a
  (64 / C) x C grid of threads, one step a column with its buffers, and
  ``chol_tile::substitute_solve`` for the members ``chol_tile::regular``
  refuses), compiled from the shipped header on the host without
  contraction, its 64 threads run one after another between the
  barriers: bit for bit the twin, in both directions, at the widths of
  every tier and B one column wide, eight wide, as wide as L and twelve
  slabs wide, on ``chip_smoke.tri_case``'s members (a zero, a NaN, a
  subnormal diagonal entry, an inverse that overflows); the threads run in
  either order give the same bits (no two threads touch one buffer entry
  between two barriers).
* The core's pullback mode (``chol_tile::pullback``: the whole square on
  the tile map, L in shared memory, the product and the two substitution
  sweeps; a subnormal diagonal entry's row and column scaled into the
  quotient's range, the twin's zero terms for a non-finite Lbar'), from
  the same host build, against the twin ``cholesky_pullback_ref`` at P in
  {9, 16, 17, 33, 49, 64} with and without ``ldbar`` and ``f``, on
  ``chip_smoke.chol_case``'s factors (escalated members and an all-fail
  NaN member), one with a subnormal diagonal entry and one with an inf in
  Lbar: within phase 3b's 1e-5 + 1e-4 max|twin| of each member (the
  twin's product is a matmul, summed in another order), NaN and inf
  patterns identical; the threads in either order give the same bits.
* The twin against the JAX K5 (its Pallas kernel interpreted on the CPU,
  as ``tests/test_pallas.py`` runs it) at the paths' shapes: one
  right-hand side at P = 49 (the dense-R whitening) and 8 x 8, both
  directions, rtol 1e-4 / atol 1e-5 (float32 rounding of the same
  operations).
* The launch and the counters on ``meta`` tensors, with the library
  replaced by a recorder: one launch a call at ``tile_tier(P)`` and
  ``solve_cols(Q)``.
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

# the CUDA names chol_tile.cuh uses, for compiling it on the host
_HOST_CUDA = """#pragma once
#include <math.h>
#define __device__
#define __forceinline__ inline
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx;
inline void __syncthreads() {}
"""
_HOST_MAIN = """#include "chol_tile.cuh"
// the member's 64 threads, each part run in turn (in reverse with `rev`)
// between the barriers, which need nothing more
template <class Part>
struct HostTeam {
  Part parts[chol_tile::kThreads];
  bool rev;
  template <class F> void each(F f) {
    for (int u = 0; u < chol_tile::kThreads; ++u) {
      const int t = rev ? chol_tile::kThreads - 1 - u : u;
      f(parts[t], t);
    }
  }
  template <class F> bool any(F f) {
    bool r = false;
    each([&](Part& pt, int t) { r = f(pt, t) || r; });
    return r;
  }
  void sync() {}
};

// every member and slab as the card's blocks run them; ok[m] = 0 where
// the member took substitute_solve
extern "C" int solve(const float* l, const float* b, float* x, int* ok,
                     long batch, int p, int q, int trans, int tier,
                     int cols, int rev) {
  return chol_tile::solve_dispatch(
      chol_tile::tier_nb(tier), cols, trans, [&](auto nbv, auto cv,
                                                  auto tv) {
    constexpr int NB = decltype(nbv)::value, C = decltype(cv)::value;
    constexpr bool T = decltype(tv)::value != 0;
    using Part = chol_tile::SolvePart<NB, C>;
    for (long m = 0; m < batch; ++m)
      for (int s = 0; s < (q + C - 1) / C; ++s) {
        auto* team = new HostTeam<Part>();
        team->rev = rev;
        chol_tile::SolveBuffers<NB, C> buf;
        chol_tile::solve<NB, C, T>(*team, buf, l + m * p * p,
                                   b + m * p * q, x + m * p * q, p, q, s);
        ok[m] = !team->any([](const Part& pt, int) { return pt.odd; });
        delete team;
      }
  });
}

// KP's pullback mode on every member as the card's blocks run it (ldbar
// and f may be null: no jbar then)
extern "C" int pullback(const float* l, const float* lbar,
                        const float* ldbar, const float* f, float* abar,
                        float* jbar, long batch, int p, int tier, int rev) {
  auto run = [&](auto nbv) {
    constexpr int NB = decltype(nbv)::value;
    using Part = chol_tile::PullbackPart<NB>;
    for (long m = 0; m < batch; ++m) {
      auto* team = new HostTeam<Part>();
      auto* buf = new chol_tile::PullbackBuffers<NB>();
      team->rev = rev;
      chol_tile::pullback<NB>(*team, *buf, l + m * p * p, lbar + m * p * p,
                              ldbar ? ldbar + m : nullptr, abar + m * p * p,
                              f ? jbar + m : nullptr, f ? f[m] : 0.f, p);
      delete buf;
      delete team;
    }
    return 1;
  };
  switch (chol_tile::tier_nb(tier)) {
    case 2: return run(chol_tile::Int<2>());
    case 4: return run(chol_tile::Int<4>());
    case 6: return run(chol_tile::Int<6>());
    case 8: return run(chol_tile::Int<8>());
    default: return 0;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The core's solve and pullback modes, one host build for both."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from pymra_torch.ops.cuda import build

    tmp = tmp_path_factory.mktemp("tri_solve_host")
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    (tmp / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp / "main.cpp").write_text(_HOST_MAIN)
    so = tmp / "libtrisolve.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(tmp), "-I", csrc,
                    str(tmp / "main.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_solve(host_lib):
    fn = host_lib.solve
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 6

    def solve(lt, b, trans, rev=False):
        lt = np.ascontiguousarray(lt, np.float32)
        b = np.ascontiguousarray(b, np.float32)
        x = np.full_like(b, np.float32(7.0))
        ok = np.zeros(len(lt), np.int32)
        p, q = b.shape[-2:]
        assert fn(lt.ctypes.data, b.ctypes.data, x.ctypes.data, ok.ctypes.data,
                  len(lt), p, q, int(trans), tl.tile_tier(p),
                  tl.solve_cols(q), int(rev))
        return x, ok.astype(bool)
    return solve


@pytest.mark.parametrize("p", [1, 5, 17, 49, 64])
def test_core_solve_is_the_twin(host_solve, p):
    # tri_case: healthy members 0 and 5, member 4 in range but its solution
    # overflows (the core); members 1-3 with a zero, a NaN and a subnormal
    # diagonal entry (substitute_solve)
    rng = np.random.default_rng(p)
    lt = chip_smoke.tri_case(rng, 6, p)
    for q in sorted({1, 8, p, 96}):
        b = rng.standard_normal((6, p, q)).astype(np.float32)
        for trans in (False, True):
            x, ok = host_solve(lt, b, trans)
            np.testing.assert_array_equal(ok, [True, False, False, False,
                                               True, True])
            want = tl.solve_triangular_batched_ref(
                torch.as_tensor(lt), torch.as_tensor(b), trans).numpy()
            # equal where not NaN (inf included, a zero of either sign),
            # NaN where the twin's is
            np.testing.assert_array_equal(x, want)
            assert np.isfinite(want[[0, 5]]).all()
            assert not np.isfinite(want[1]).all()
            x_rev, _ = host_solve(lt, b, trans, rev=True)
            np.testing.assert_array_equal(x_rev.view(np.uint32),
                                          x.view(np.uint32))


@pytest.fixture(scope="module")
def host_pullback(host_lib):
    fn = host_lib.pullback
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long] + [ctypes.c_int] * 3

    def pullback(lt, lbar, ldbar=None, f=None, rev=False):
        lt, lbar = (np.ascontiguousarray(x, np.float32) for x in (lt, lbar))
        b, p = lt.shape[:2]
        abar = np.full_like(lt, np.float32(7.0))
        jbar = np.full(b, np.float32(7.0))
        ld, fv = (None if x is None else np.ascontiguousarray(x, np.float32)
                  for x in (ldbar, f))
        assert fn(lt.ctypes.data, lbar.ctypes.data,
                  None if ld is None else ld.ctypes.data,
                  None if fv is None else fv.ctypes.data, abar.ctypes.data,
                  jbar.ctypes.data, b, p, tl.tile_tier(p), int(rev))
        return abar, (None if f is None else jbar)
    return pullback


@pytest.mark.parametrize("p", [9, 16, 17, 33, 49, 64])
def test_core_pullback_is_the_twin(host_pullback, p):
    # K2's factors of chol_case (member 1 and 2 escalated, member 3 the
    # all-fail NaN factor), member 4 with a subnormal diagonal entry (its
    # row and column scaled by 2^64 before the quotient; with ldbar its
    # ldbar / L[j][j] may overflow) and member 5
    # with an inf in Lbar's lower triangle (the twin's product turns it
    # into NaN below it through L's zeros above the diagonal)
    rng = np.random.default_rng(100 + p)
    m, jit = chip_smoke.chol_case(rng, 7, p)
    l, _, f = tl.cholesky_jittered_ref(torch.as_tensor(m),
                                       torch.as_tensor(jit))
    lt = l.numpy().copy()
    lt[4, p // 2, p // 2] = 1e-39
    lbar = rng.standard_normal(lt.shape).astype(np.float32)
    lbar[5, p // 2, 1] = np.inf
    ldbar = rng.standard_normal(7).astype(np.float32)
    f = f.numpy()
    for ld, ff in ((None, None), (ldbar, f), (ldbar, None), (None, f)):
        abar, jbar = host_pullback(lt, lbar, ld, ff)
        want = tl.cholesky_pullback_ref(
            *(None if x is None else torch.as_tensor(x)
              for x in (lt, lbar, ld, ff)))
        got = [torch.as_tensor(abar)] + (
            [] if ff is None else [torch.as_tensor(jbar)])
        want = [want[0]] + ([] if ff is None else [want[1]])
        chip_smoke.compare(f"pullback P={p}", got, want, per_member=True)
        for g, w in zip(got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert torch.equal(torch.isinf(g), torch.isinf(w))
        assert torch.isfinite(got[0][[0, 1, 2, 6]]).all()
        assert torch.isnan(got[0][3]).all()
        assert torch.isnan(got[0][5]).any()
        rev = host_pullback(lt, lbar, ld, ff, rev=True)
        np.testing.assert_array_equal(rev[0].view(np.uint32),
                                      abar.view(np.uint32))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("p, q", [(49, 1), (8, 8)])
def test_twin_matches_the_pallas_kernel(p, q, trans):
    rng = np.random.default_rng(p + q)
    lt = chip_smoke.lower_case(rng, 6, p)
    b = rng.standard_normal((6, p, q)).astype(np.float32)
    got = tl.solve_triangular_batched(torch.as_tensor(lt), torch.as_tensor(b),
                                      trans).numpy()
    want = np.asarray(jl.solve_triangular_batched(jnp.asarray(lt),
                                                  jnp.asarray(b), trans))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("q, cols", [(1, 1), (2, 2), (3, 4), (4, 4),
                                     (5, 8), (8, 8), (9, 8), (96, 8)])
def test_solve_cols_is_the_least_grid_width_holding_q(q, cols):
    assert tl.solve_cols(q) == cols


# ---------------------------------------------------------------------------
# the launch on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The kernel library replaced by a recorder; ``meta`` tensors stand
    in for CUDA ones (the device check is skipped)."""
    calls = []
    lib = types.SimpleNamespace(
        pymra_tri_solve=lambda l, b, x, n, p, q, trans, tier, cols, dev,
        stream: calls.append((n, p, q, trans, tier, cols)) or 0)
    monkeypatch.setattr(tl, "_check_square", lambda name, t: t.shape[-1])
    monkeypatch.setattr(tl.build, "load_library", lambda: lib)
    monkeypatch.setattr(tl, "_where", lambda t: (0, 0))
    monkeypatch.setattr(tl.solve_triangular_batched, "launches", 0)
    return calls


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_launch_one_call_at_its_tier_and_slab_width(recorded):
    cases = [(256, 49, 1, False), (4096, 8, 8, True), (3, 64, 96, False),
             (3, 1, 2, True), (3, 17, 5, False), (3, 33, 17, True)]
    for n, p, q, trans in cases:
        out = tl._tri_solve_fwd(_meta(n, p, p), _meta(n, p, q), trans)
        assert out.shape == (n, p, q)
    assert recorded == [(n, p, q, int(trans), tl.tile_tier(p),
                         tl.solve_cols(q)) for n, p, q, trans in cases]
    assert tl.solve_triangular_batched.launches == len(cases)
    # slabs of 8 columns above 8: 17 columns take three blocks a member
    assert [-(-q // tl.solve_cols(q)) for _, _, q, _ in cases] == [
        1, 1, 12, 1, 1, 3]
    # an empty batch launches nothing
    tl._tri_solve_fwd(_meta(0, 5, 5), _meta(0, 5, 3), False)
    assert tl.solve_triangular_batched.launches == len(cases)
