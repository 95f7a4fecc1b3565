"""The port's covariance families and distances against ``pymra_tpu``,
and K1's backward ``leaf_pullback`` (``ops/cuda/csrc/leaf_pullback.cu``)
held by what runs on the CPU.

Covariances: same float64 inputs (numpy, seeded) through both packages.
Tolerance: rtol 1e-12 — both compute the same float64 expression, so only
the last-ulp rounding of exp/sin/cos may differ; atol 1e-15 covers the
kanter taper's values that are analytically 0 near the support edge.

K1's backward:

* on CPU tensors the gradient through ``leaf_factor`` is bit for bit the
  composition it ran before the kernel (``_leaf_parts``,
  ``_leaf_posterior_pullback``, ``_leaf_prior_pullback``), and no launch
  is counted; ``launch_count`` sums the new counter;
* the kernel's merged, triangular formula (three products over triangles,
  ``1/2 q I`` inside the first) emulated in float64 numpy equals the
  twin's four products to 1e-12 at P = 16, 49 and 64;
* the kernel source compiled on the host (g++, no contraction, stubs for
  the CUDA names; 64 threads meet at its barriers) against the twin
  ``leaf_pullback_ref`` on
  ``chip_smoke.leaf_case``'s members (masked slots, a fully masked leaf,
  factors 1e2 and 1e4, an all-fail member) and on members with an inf or a
  NaN cotangent, with each cotangent present or absent: within phase 3b's
  1e-5 + 1e-4 max|twin| of each member, non-finite patterns identical,
  the same bits on a second run with every cotangent;
* the launch on ``meta`` tensors, the library replaced by a recorder.
"""
import ctypes
import math
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import chip_smoke
from pymra_tpu import kernels as jk
from pymra_tpu.ops import distances as jd
from pymra_torch import kernels as tk
from pymra_torch.ops import distances as td
from pymra_torch.ops import linalg as tl
from tests.torch_fixtures import jax_native_planner  # noqa: F401

RTOL, ATOL = 1e-12, 1e-15


def _pts(seed, shape):
    return np.random.default_rng(seed).random(shape)


def _both(fn_t, fn_j, a, b, **kw):
    ta = torch.as_tensor(a)
    tb = None if b is None else torch.as_tensor(b)
    ja = jnp.asarray(a, dtype=jnp.float64)
    jb = None if b is None else jnp.asarray(b, dtype=jnp.float64)
    return (fn_t(ta, tb, **kw).numpy(), np.asarray(fn_j(ja, jb, **kw)))


FAMILIES = ["identity", "exponential", "matern12", "matern32", "matern52",
            "gaussian"]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("self_pair", [False, True])
def test_family_matches_jax_batched_2d(name, self_pair):
    a = _pts(0, (3, 6, 2))
    b = None if self_pair else _pts(1, (3, 5, 2))
    got, want = _both(tk.get_kernel(name), jk.get_kernel(name), a, b,
                      l=0.37, sig=1.7)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax_circular_1d(name):
    a, b = _pts(2, (7, 1)), _pts(3, (4, 1))
    got, want = _both(tk.get_kernel(name), jk.get_kernel(name), a, b,
                      l=0.21, circular=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_matern_closed_forms_match_jax(nu):
    a, b = _pts(4, (9, 2)), _pts(5, (6, 2))
    got, want = _both(tk.matern, jk.matern, a, b, l=0.3, sig=0.9, nu=nu)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_general_nu_matern_is_not_ported_yet():
    # (named before the port had it) general nu through the Bessel K of
    # pymra_torch/ops/special.py, against the JAX package's, batched and
    # circular as the families above
    a, b = _pts(10, (3, 9, 2)), _pts(11, (3, 6, 2))
    for nu in (0.7, 1.2, 3.4):
        got, want = _both(tk.matern, jk.matern, a, b, l=0.3, sig=1.4, nu=nu)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got, want = _both(tk.matern, jk.matern, _pts(12, (7, 1)), None, l=0.21,
                      nu=0.8, circular=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.diag(got) == 1.0)


@pytest.mark.parametrize("radius", [0.35, 9])
def test_kanter_matches_jax(radius):
    # radius 9 is an ensemble size converted through determine_radius
    from pymra_torch.utils import gen_locations_2d

    a = gen_locations_2d(8)
    got, want = _both(tk.kanter, jk.kanter, a, None, radius=radius)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got == 0.0).any() and np.all(np.diag(got) == 1.0)


@pytest.mark.parametrize("k,ndim", [(1, 2), (9, 2), (12, 2), (30, 2),
                                    (49, 2), (6, 1)])
def test_determine_radius_matches_jax(k, ndim):
    assert tk.determine_radius(k, 0.1, ndim) == jk.determine_radius(
        k, 0.1, ndim)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_sqdist_matches_jax(d):
    # d <= 4 sums direct differences; d > 4 takes the clamped expansion
    # with exact diagonal zeros
    a, b = _pts(6, (2, 8, d)), _pts(7, (2, 5, d))
    for bb in (b, None):
        got, want = _both(td.sqdist, jd.sqdist, a, bb)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    self_d = td.sqdist(torch.as_tensor(a))
    assert torch.all(torch.diagonal(self_d, dim1=-2, dim2=-1) == 0.0)


def test_kernel_module_holds_tensor_params():
    kern = tk.Kernel("matern32", l=0.3, sig=2.0)
    assert isinstance(kern, torch.nn.Module)
    assert set(kern.params) == {"l", "sig"}
    assert all(p.dtype == torch.float64 and p.ndim == 0
               for p in kern.params.values())
    a = _pts(8, (5, 2))
    jkern = jk.Kernel("matern32", l=0.3, sig=2.0)
    np.testing.assert_allclose(kern(torch.as_tensor(a)).numpy(),
                               np.asarray(jkern(jnp.asarray(a))),
                               rtol=RTOL, atol=ATOL)
    k2 = kern.replace(l=0.5)
    assert float(k2.l) == 0.5 and float(k2.sig) == 2.0
    with pytest.raises(KeyError, match="available"):
        tk.Kernel("nope")
    # the dense-matrix covariance: an nn.Module holding the matrix as a
    # buffer, gathering blocks by location index as the JAX package's
    mat = _pts(13, (6, 6))
    mk = tk.MatrixKernel(mat)
    assert isinstance(mk, torch.nn.Module) and mk.matrix.dtype == torch.float64
    idx = np.array([[[2], [0], [5]], [[1], [1], [4]]])
    np.testing.assert_array_equal(
        mk(torch.as_tensor(idx)).numpy(),
        np.asarray(jk.MatrixKernel(mat)(idx.astype(np.float64))))


def test_float32_locations_compute_in_float32():
    # a float64 0-dim parameter must not promote float32 locations, and it
    # is rounded to float32 once, as JAX rounds its weakly typed scalars
    a = _pts(9, (6, 2)).astype(np.float32)
    got = tk.Kernel("exponential", l=0.3)(torch.as_tensor(a))
    want = np.asarray(jk.Kernel("exponential", l=0.3)(
        jnp.asarray(a, dtype=jnp.float32)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)



# ---------------------------------------------------------------------------
# K1's backward: leaf_pullback
# ---------------------------------------------------------------------------

def _leaf_inputs(p, b=6, seed=0):
    """``chip_smoke.leaf_case``'s hard members (masked slots, a fully masked
    leaf, factors 1e2 and 1e4, an all-fail member), K1's forward on them
    and random cotangents of its three differentiable outputs."""
    rng = np.random.default_rng(seed + p)
    c, k, a = chip_smoke.leaf_case(rng, b, p, escalate=True, hard=True)
    li, _, _, fp, _ = tl.leaf_factor(*(torch.as_tensor(x) for x in (c, k, a)),
                                     1e-3)
    f32 = np.float32
    bars = (rng.standard_normal(c.shape).astype(f32),
            rng.standard_normal(b).astype(f32),
            rng.standard_normal(b).astype(f32))
    return c, k, a, li, fp, bars


def _before_the_kernel(c, k, li, fp, libar, ldpbar, ldqbar, jitter):
    """K1's backward as it read before the kernel, kept verbatim."""
    shape, p = c.shape, c.shape[-1]
    cf = c.reshape(-1, p, p)
    k_leaf, pair, _, s = tl._leaf_parts(cf, k.reshape(-1, p).to(cf.dtype))
    kbar_q = tl._leaf_posterior_pullback(
        li.reshape(-1, p, p), libar.reshape(-1, p, p), ldqbar.reshape(-1))
    kbar = kbar_q + tl._leaf_prior_pullback(
        k_leaf, fp.reshape(-1) * (jitter * s), ldpbar.reshape(-1))
    return (kbar * pair).reshape(shape), (kbar_q * pair).reshape(shape)


@pytest.mark.parametrize("p", [17, 49, 64])
def test_leaf_gradient_on_the_cpu_is_the_composition(p, monkeypatch):
    monkeypatch.setattr(tl.leaf_pullback, "launches", 0)
    monkeypatch.setattr(tl.leaf_pullback_ref, "cuda_calls", 0)
    c, k, a, li, fp, bars = _leaf_inputs(p)
    ct, at = (torch.tensor(x, requires_grad=True) for x in (c, a))
    outs = tl.leaf_factor(ct, torch.as_tensor(k), at, 1e-3)[:3]
    got = torch.autograd.grad(outs, (ct, at),
                              [torch.as_tensor(x) for x in bars])
    want = _before_the_kernel(torch.as_tensor(c), torch.as_tensor(k), li, fp,
                              *(torch.as_tensor(x) for x in bars), 1e-3)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert got[0][[0, 1, 2, 4, 5]].isfinite().all()
    assert got[0][3].isnan().all()  # the all-fail member
    assert tl.leaf_pullback.launches == 0
    assert tl.leaf_pullback_ref.cuda_calls == 0


def test_launch_count_sums_the_leaf_pullback(monkeypatch):
    before = tl.launch_count()
    monkeypatch.setattr(tl.leaf_pullback, "launches",
                        tl.leaf_pullback.launches + 3)
    assert tl.launch_count() == before + 3


def _merged_triangular(x, xbar, q):
    """The kernel's formula in float64 numpy, sums over the kernel's index
    ranges only: G[i, k] = sum_{j <= k} Xbar[i, j] X[k, j] (k <= i), U =
    -G with its diagonal halved plus q / 2, V[i, k] = sum_{k <= j <= i}
    U[i, j] X[j, k], S[a, k] = 1/2 sum_{i >= a} X[i, a] V[i, k] + V[i, a]
    X[i, k] (k <= a); returns S mirrored."""
    b, p = x.shape[:2]
    idx = np.arange(p)
    low = idx[:, None] >= idx[None, :]
    g = np.zeros((b, p, p))
    for j in range(p):
        g += (xbar[:, :, j, None] * x[:, None, :, j]) * (low & (idx >= j))
    u = -g
    u[:, idx, idx] = 0.5 * u[:, idx, idx] + 0.5 * q[:, None]
    v = np.zeros((b, p, p))
    for j in range(p):
        reach = low & (idx[:, None] >= j) & (idx[None, :] <= j)
        v += (u[:, :, j, None] * x[:, None, j, :]) * reach
    s = np.zeros((b, p, p))
    for i in range(p):
        reach = low & (idx[:, None] <= i)
        s += (x[:, i, :, None] * v[:, i, None, :]
              + v[:, i, :, None] * x[:, i, None, :]) * reach
    s = 0.5 * s
    return np.tril(s) + np.swapaxes(np.tril(s, -1), -1, -2)


@pytest.mark.parametrize("p", [16, 49, 64])
def test_merged_triangular_formula_is_the_four_products(p):
    # X a posterior inverse factor of K1 (lower, cond ~1e3 of its square),
    # Xbar whole (its upper triangle must not matter)
    rng = np.random.default_rng(p)
    b = 5
    a = rng.standard_normal((b, p, p))
    k_q = a @ np.swapaxes(a, -1, -2) / p + 1e-3 * np.eye(p)
    x = np.linalg.inv(np.linalg.cholesky(k_q))
    x = np.tril(x)
    xbar = rng.standard_normal((b, p, p))
    q = rng.standard_normal(b)
    got = _merged_triangular(x, xbar, q)
    want = tl._leaf_posterior_pullback(
        torch.as_tensor(x), torch.as_tensor(xbar), torch.as_tensor(q)).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-12 * scale)
    # a slip in the algebra shows: the prior's merged term dropped
    slip = _merged_triangular(x, xbar, 0.0 * q)
    assert np.abs(slip - want).max() > 1e-3 * scale.max()


# the CUDA names leaf_pullback.cu and chol_tile.cuh use, for compiling them
# on the host: 64 threads meet at each barrier
_HOST_CUDA = """#pragma once
#include <math.h>
#include <string.h>
#include <atomic>
#include <barrier>
#define __device__
#define __forceinline__ inline
struct Dim3 { unsigned x, y, z; };
inline thread_local Dim3 threadIdx;
inline std::barrier<>* host_barrier;
inline std::atomic<int> host_or[2];
inline thread_local int host_or_slot;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline long long __double_as_longlong(double v) {
  long long r;
  memcpy(&r, &v, sizeof r);
  return r;
}
inline double __longlong_as_double(long long v) {
  double r;
  memcpy(&r, &v, sizeof r);
  return r;
}
inline int __syncthreads_or(int v) {
  const int s = host_or_slot;
  host_or_slot ^= 1;
  if (v) host_or[s].store(1);
  host_barrier->arrive_and_wait();
  const int r = host_or[s].load();
  host_barrier->arrive_and_wait();
  if (threadIdx.x == 0) host_or[s].store(0);
  return r;
}
"""
_HOST_MAIN = """#include "leaf_pullback.cu"
#include <thread>
#include <vector>
// every member as the card's blocks run it, one block of 64 threads
extern "C" int pullback(const float* c, const float* kmask, const float* li,
                        const float* libar, const float* ldpbar,
                        const float* ldqbar, const float* fp, float jitter,
                        float* cbar, float* abar, long batch, int p,
                        int tier) {
  auto run = [&](auto nbv) {
    constexpr int NB = decltype(nbv)::value;
    auto* sm = new Smem<NB>();
    std::barrier<> bar(kThreads);
    host_barrier = &bar;
    std::vector<std::thread> team;
    for (int tid = 0; tid < kThreads; ++tid)
      team.emplace_back([&, tid] {
        threadIdx.x = tid;
        for (long m = 0; m < batch; ++m) {
          const size_t off = (size_t)m * p * p;
          member<NB>(*sm, c + off, kmask + m * p, li + off,
                     libar ? libar + off : nullptr,
                     ldpbar ? ldpbar + m : nullptr,
                     ldqbar ? ldqbar + m : nullptr, fp ? fp + m : nullptr,
                     jitter, cbar + off, abar + off, p);
          __syncthreads();
        }
      });
    for (auto& th : team) th.join();
    delete sm;
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
def host_pullback(tmp_path_factory):
    """``leaf_pullback.cu`` built on the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from pymra_torch.ops.cuda import build

    tmp = tmp_path_factory.mktemp("leaf_pullback_host")
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    (tmp / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp / "main.cpp").write_text(_HOST_MAIN)
    so = tmp / "libleafpullback.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++20",
                    "-shared", "-fPIC", "-pthread", "-I", str(tmp), "-I",
                    csrc, str(tmp / "main.cpp"), "-o", str(so)], check=True)
    fn = ctypes.CDLL(str(so)).pullback
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_long] +
                   [ctypes.c_int] * 2)

    def pullback(c, k, li, fp, libar, ldpbar, ldqbar, jitter):
        arrs = [None if x is None else np.ascontiguousarray(x, np.float32)
                for x in (c, k, li, libar, ldpbar, ldqbar, fp)]
        cbar, abar = (np.full_like(arrs[0], np.float32(7.0))
                      for _ in range(2))
        b, p = arrs[0].shape[:2]
        assert fn(*(None if x is None else x.ctypes.data for x in arrs),
                  jitter, cbar.ctypes.data, abar.ctypes.data, b, p,
                  tl.tile_tier(p))
        return cbar, abar
    return pullback


#: which cotangents are present: libar, ldpbar, ldqbar
_PRESENT = [(1, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
            (0, 0, 0)]


@pytest.mark.parametrize("p", [1, 5, 16, 17, 33, 49, 64])
def test_host_built_kernel_is_the_twin(host_pullback, p):
    c, k, _, li, fp, bars = _leaf_inputs(p, b=8)
    libar, ldpbar, ldqbar = (x.copy() for x in bars)
    if p >= 2:
        # an inf above the diagonal of Xbar, a NaN below, an inf q and a
        # NaN p (members 4-7 after leaf_case's six)
        libar[6, 0, p - 1] = np.inf
        libar[7, p - 1, 1] = np.nan
    ldqbar[4] = np.inf
    ldpbar[5] = np.nan
    for present in _PRESENT:
        args = [x if on else None
                for x, on in zip((libar, ldpbar, ldqbar), present)]
        got = host_pullback(c, k, li.numpy(), fp.numpy(), *args, 1e-3)
        want = tl.leaf_pullback_ref(
            torch.as_tensor(c), torch.as_tensor(k), li, fp,
            *(None if x is None else torch.as_tensor(x) for x in args), 1e-3)
        got = [torch.as_tensor(g) for g in got]
        chip_smoke.compare(f"leaf_pullback P={p} {present}", got, list(want),
                           per_member=True)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan())
            assert torch.equal(g.isinf(), w.isinf())
        if present == (1, 1, 1):
            assert got[0][[0, 1, 2]].isfinite().all()
            if p >= 2:
                assert got[0][3].isnan().all()  # the all-fail member
            again = host_pullback(c, k, li.numpy(), fp.numpy(), *args, 1e-3)
            for g, h in zip(got, again):
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              h.view(np.uint32))


@pytest.fixture
def recorded(monkeypatch):
    """The kernel library replaced by a recorder; ``meta`` tensors stand
    in for CUDA ones (the device check is skipped)."""
    calls = []

    def record(c, k, li, libar, ldpbar, ldqbar, fp, jitter, cbar, abar, n,
               p, tier, dev, stream):
        calls.append((libar is None, ldpbar is None, ldqbar is None, jitter,
                      n, p, tier))
        return 0

    lib = types.SimpleNamespace(pymra_leaf_pullback=record)
    monkeypatch.setattr(tl, "_check_square", lambda name, t: t.shape[-1])
    monkeypatch.setattr(tl.build, "load_library", lambda: lib)
    monkeypatch.setattr(tl, "_where", lambda t: (0, 0))
    monkeypatch.setattr(tl.leaf_pullback, "launches", 0)
    return calls


def test_leaf_pullback_launches_once_at_its_tier(recorded):
    def meta(*shape):
        return torch.empty(shape, device="meta")

    cases = [((4, 16384), 64, (1, 1, 1)), ((256,), 49, (1, 0, 1)),
             ((3,), 17, (0, 1, 0))]
    for batch, p, present in cases:
        sq, vec = batch + (p, p), batch
        bars = [meta(*s) if on else None
                for s, on in zip((sq, vec, vec), present)]
        cbar, abar = tl.leaf_pullback(meta(*sq), meta(*batch, p), meta(*sq),
                                      meta(*vec), *bars, 1e-6)
        assert cbar.shape == abar.shape == sq
    assert recorded == [
        (not pr[0], not pr[1], not pr[2], 1e-6, math.prod(b), p,
         tl.tile_tier(p)) for b, p, pr in cases]
    assert tl.leaf_pullback.launches == len(cases)
