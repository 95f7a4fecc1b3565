"""The cases of the register-tiled K1 ``leaf_factor`` and K4 ``cholesky``
kernels, on the CPU through their plain twins.

The kernels pad a member to a width tier and escalate per member; the
card's check (``chip_smoke.py`` phase 3) holds them to the twins on the
members built here. These tests hold those members' twin results to the
JAX package's Pallas kernels (interpret mode, as ``tests/test_pallas.py``
runs them) and check that each member really is the case it is named for:
escalated to 1e2 and to 1e4, failing all three factors, fully masked, an
exactly zero pivot. Float32 tolerances as ``tests/test_torch_linalg.py``:
rtol 1e-4 / atol 1e-5, selected factors identical.
"""
import ctypes
import os
import shutil
import subprocess

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


@pytest.mark.parametrize("p, tier", [
    (1, 16), (4, 16), (8, 16), (16, 16), (17, 32), (28, 32), (32, 32),
    (33, 48), (48, 48), (49, 64), (64, 64)])
def test_tile_tier_is_the_least_tier_holding_p(p, tier):
    assert tl.tile_tier(p) == tier


@pytest.mark.parametrize("p", [0, 65])
def test_tile_tier_refuses_widths_outside_one_block(p):
    with pytest.raises(ValueError, match="outside"):
        tl.tile_tier(p)


def _jax_leaf(c, k, a, jitter):
    out = jl._leaf_factor_tuple(
        jnp.asarray(c, dtype=jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(a, dtype=jnp.float32), jitter, tl.FACTORS)
    return [np.asarray(o) for o in out]


# 6: a batch that is not a multiple of any tile or group
@pytest.mark.parametrize("p", [17, 49])
def test_leaf_hard_members_match_pallas(p):
    c, k, a = chip_smoke.leaf_case(np.random.default_rng(p), 6, p,
                                   escalate=True, hard=True)
    jitter = 1e-3
    got = [o.numpy() for o in tl.leaf_factor(
        torch.as_tensor(c), torch.as_tensor(k), torch.as_tensor(a), jitter)]
    want = _jax_leaf(c, k, a, jitter)
    li, ldp, ldq, fp, fq = got
    # members 0, 4, 5 at the base factor, 1 at 1e2, 2 at 1e4, 3 fails all
    for f in (fp, fq):
        assert f.tolist() == [1.0, 1e2, 1e4, 1e4, 1.0, 1.0]
    np.testing.assert_array_equal(fp, want[3])
    np.testing.assert_array_equal(fq, want[4])
    ok = [0, 1, 2, 4, 5]
    assert np.isfinite(ldp[ok]).all() and np.isfinite(ldq[ok]).all()
    assert np.isfinite(li[ok]).all()
    assert np.isnan(ldp[3]) and np.isnan(ldq[3]) and np.isnan(want[1][3])
    # the all-fail member is NaN from its failing column on, and zero
    # above the diagonal
    assert np.isnan(li[3][1:, :2]).all() and (np.triu(li[3], 1) == 0).all()
    np.testing.assert_allclose(ldp[ok], want[1][ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ldq[ok], want[2][ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(li[ok], want[0][ok], rtol=RTOL, atol=ATOL)
    # fully masked leaf: K_leaf = I, jitter scale 2
    np.testing.assert_allclose(li[0], np.eye(p) / np.sqrt(1 + 2 * jitter),
                               rtol=1e-6)


def test_leaf_hard_members_only_with_escalation():
    # phase 3b draws its leaves without the hard members: their inputs stay
    # as they were
    rng = [np.random.default_rng(3) for _ in range(2)]
    plain = chip_smoke.leaf_case(rng[0], 6, 17, escalate=True)
    hard = chip_smoke.leaf_case(rng[1], 6, 17, escalate=True, hard=True)
    for x, y in zip(plain, hard):
        np.testing.assert_array_equal(x[[0, 1, 4, 5]], y[[0, 1, 4, 5]])
    assert not np.array_equal(plain[0][2], hard[0][2])


@pytest.mark.parametrize("p", [4, 17, 64])
def test_cholesky_zero_pivot_member(p):
    # the member chip_smoke adds to K4's batch: exactly zero pivot at
    # column z with 0.5 under it; columns before z stay exact, L[z, z] is
    # 0/0 and L[z+1, z] is 0.5/0 = inf, and the trailing block is NaN
    z = p // 2
    m = np.eye(p, dtype=np.float32)
    m[z, z] = 0.0
    m[z + 1, z] = m[z, z + 1] = 0.5
    l = tl.cholesky(torch.as_tensor(m)[None])[0].numpy()
    np.testing.assert_array_equal(l[:, :z], np.eye(p, dtype=np.float32)[:, :z])
    assert np.isnan(l[z, z]) and np.isposinf(l[z + 1, z])
    assert np.isnan(l[z + 1:, z + 1:][np.tril_indices(p - z - 1)]).all()
    assert (np.triu(l, 1) == 0).all()


@pytest.mark.parametrize("p", [17, 64])
def test_twins_divide_by_the_pivot(p):
    # the column scale the register-tiled core is held to: the twins form
    # L[j:, j] = S[j:, j] / sqrt(S[j, j]) by division, which differs in the
    # last bit from S * (1 / sqrt(S[j, j])) on a random member (so this
    # check can tell them apart); a NaN pivot, like a zero one, turns its
    # column and the trailing block NaN and leaves the columns before it
    # exact, whichever of the two forms the scale takes
    rng = np.random.default_rng(p)
    a = rng.standard_normal((p, p))
    m = (a @ a.T / p + np.eye(p)).astype(np.float32)
    z = p // 2
    bad = np.eye(p, dtype=np.float32)
    bad[z, z] = np.nan
    mt = torch.as_tensor(np.stack([m, bad]))
    l = tl.cholesky_ref(mt).numpy()
    piv = np.sqrt(m[0, 0])
    np.testing.assert_array_equal(l[0][:, 0], m[:, 0] / piv)
    assert (m[:, 0] * (np.float32(1) / piv) != m[:, 0] / piv).any()
    np.testing.assert_array_equal(l[1][:, :z], np.eye(p)[:, :z])
    assert np.isnan(l[1][z:, z]).all()
    assert np.isnan(l[1][z + 1:, z + 1:][np.tril_indices(p - z - 1)]).all()
    assert (np.triu(l[1], 1) == 0).all()


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
extern "C" void quotients(const float* x, const float* den, float* out,
                          long n) {
  for (long i = 0; i < n; ++i) {
    volatile float r = 1.f / den[i];  // as the core takes it, once a step
    out[i] = chol_tile::quotient(x[i], den[i], r);
  }
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_core_quotient_is_the_division(tmp_path):
    # the register-tiled core's column scale, compiled from the shipped
    # header on the host (IEEE fmaf and division, no contraction, as nvcc
    # builds it without fast-math), against x / den in float32 over the
    # whole exponent range and the special values: bit for bit where the
    # header says it is (2^-126 <= |den| <= 2^126, |x| >= 2^-100, quotient
    # in [2^-126, 2^126]; a zero, infinite or NaN x or den), equal but for
    # the sign for a zero x, and else an ulp off or, for a |den| below
    # 2^-128, inf or NaN
    from pymra_torch.ops.cuda import build

    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    (tmp_path / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp_path / "main.cpp").write_text(_HOST_MAIN)
    so = tmp_path / "libquotient.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(tmp_path), "-I", csrc,
                    str(tmp_path / "main.cpp"), "-o", str(so)], check=True)
    fn = ctypes.CDLL(str(so)).quotients
    rng = np.random.default_rng(0)
    n = 400_000
    x = (rng.uniform(1, 2, n) * np.exp2(rng.integers(-150, 128, n))
         * rng.choice([-1, 1], n))
    den = (rng.uniform(1, 2, n) * np.exp2(rng.integers(-149, 128, n))
           * rng.choice([-1, 1], n))
    edge = np.array([0.0, 1e-45, 1e-40, 2.0 ** -126, 2.0 ** -40, 2.0 ** 40,
                     1.0, 3.0, 1e-30, 7e-20, 1e30, np.finfo(np.float32).max,
                     np.inf, np.nan])
    ex, ed = np.meshgrid(np.concatenate([edge, -edge]),
                         np.concatenate([edge, -edge]))
    x = np.ascontiguousarray(np.concatenate([x, ex.ravel()]), np.float32)
    den = np.ascontiguousarray(np.concatenate([den, ed.ravel()]), np.float32)
    got = np.empty_like(x)
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in (x, den, got)),
       ctypes.c_long(x.size))
    with np.errstate(all="ignore"):
        want = x / den
        tq = np.abs(x.astype(np.float64) / den)
    ax, ad = np.abs(x), np.abs(den)
    special = ~np.isfinite(x) | ~np.isfinite(den) | (den == 0)
    exact = special | ((ad >= 2.0 ** -126) & (ad <= 2.0 ** 126)
                       & (ax >= 2.0 ** -100) & (tq >= 2.0 ** -126)
                       & (tq <= 2.0 ** 126))
    assert exact.sum() > n // 3
    np.testing.assert_array_equal(np.isnan(got[exact]), np.isnan(want[exact]))
    num = exact & ~np.isnan(want)
    np.testing.assert_array_equal(got[num].view(np.uint32),
                                  want[num].view(np.uint32))
    zero = ~exact & (x == 0) & (ad >= 2.0 ** -126)
    assert zero.any() and (got[zero] == want[zero]).all()
    rest = ~exact & ~zero
    ulps = np.abs(got[rest].view(np.int32).astype(np.int64)
                  - want[rest].view(np.int32))
    tiny_den = ad[rest] < 2.0 ** -128
    assert (ulps[~tiny_den] <= 1).all()
    # the subnormal pivot: its reciprocal overflows, x / den is finite
    sub = (x == np.float32(1e-30)) & (den == np.float32(1e-40))
    assert np.isinf(got[sub]).all() and np.isfinite(want[sub]).all()
