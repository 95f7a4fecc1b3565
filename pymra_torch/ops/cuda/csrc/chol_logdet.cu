// Batched jittered log-determinant with per-member escalation, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_logdet_kernel
// (K6, the public `cholesky_logdet`). For every member b of a [B, P, P]
// float32 batch (P <= 64) it computes
//
//   ld_b = 1/2 sum_j log d_j,  d_j the downdated pivots of A_b + f jit_b I,
//
// which is sum_j log L_jj of the Cholesky factor without a square root and
// without the factor ever being written. f escalates through factors[0..2]
// while the member's sum is non-finite (NaN for a negative pivot, -inf for
// an exact zero); a member that fails all three keeps its NaN sum and
// reports the last factor. The MRA sweep calls it for the prior
// log-determinant of the leaves that do not take the fused K1: with dense
// measurement error at every P <= 64, and with diagonal measurement error
// for leaves of P < 16.
//
// What bounds it on the card: per member it reads the lower triangle,
// P(P+1)/2 floats, and writes two, against ~P^3/3 flops an attempt; at the
// dense-R path's 256 x 49 that is 1.2 MB and 10 MFLOP, 0.0004 ms at 3.35
// TB/s. 256 members fill two blocks an SM, so what bounds a kernel there
// is the latency of one member's chain of P dependent steps, once per
// attempt. The first kernel (the lower triangle in shared memory, W =
// ceil(P / 8) warps sweeping rows, three shared accesses per
// multiply-subtract and a block barrier a step waiting for the warp with
// the longest rows) took 0.69 us a step there.
//
// Design: K1's prior half (leaf_factor.cu) on a plain input: the
// register-tiled core of chol_tile.cuh in its pivot-only mode
// (Mode::kLogdet), one 64-thread block a member, the lower triangle in
// registers, column j broadcast through the core's double buffer (one
// barrier a step). Every attempt assembles the member in registers straight
// from `a` with f jit_b added on the diagonal, so a retry keeps nothing.
// The host picks the width tier (16, 32, 48 or 64) from P; padding is the
// identity without jitter and no padded pivot is ever taken, so it adds
// exactly nothing to the sum. Every thread sums the same pivots, so the
// escalation loop is block-uniform and a member's bits do not depend on its
// neighbours. Built without fast-math: the escalation relies on IEEE logf
// giving NaN and -inf.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3,
// tools/kernel_scaling.py --logdet; PERF.md): at 256 x 49 on a batch
// where no member escalates 0.017 ms of device time, 0.35 us a step (the
// first kernel 0.034), against 0.059 for `cholesky_ex` and a log-diagonal
// sum; 0.047 with members that take all three attempts (the first kernel
// 0.163).

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::Mode;

// No minimum of blocks an SM: the dense-R path's 256 members fill two an
// SM, so registers do not limit its occupancy (tier 64: 128, no spill).
template <int NB>
__global__ void __launch_bounds__(kThreads)
    chol_logdet_kernel(const float* __restrict__ a,
                       const float* __restrict__ jit, float* __restrict__ ld,
                       float* __restrict__ fsel, int p, float f0, float f1,
                       float f2) {
  constexpr int kBuf = kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  const chol_tile::Place t = chol_tile::place();
  const float* src = a + (size_t)blockIdx.x * p * p;
  const float js = jit[blockIdx.x];
  float s[NB][NB], unused[NB][NB];
  float acc = 0.f, fac = f0;
  for (int att = 0; att < 3; ++att) {
    fac = att == 0 ? f0 : (att == 1 ? f1 : f2);
    const float add = js * fac;
    chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
      const float v = src[i * p + k];
      return i == k ? v + add : v;
    });
    acc = 0.5f * chol_tile::factor<NB, Mode::kLogdet>(s, unused, col,
                                                      nullptr, p, t);
    if (isfinite(acc)) break;
  }
  if (threadIdx.x == 0) {
    ld[blockIdx.x] = acc;
    fsel[blockIdx.x] = fac;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier it does not have.
extern "C" int pymra_chol_logdet(const void* a, const void* jit, void* ld,
                                 void* f, int batch, int p, int tier,
                                 float f0, float f1, float f2, int device,
                                 void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)jit, (float*)ld, (float*)f, p, f0, f1,
        f2);
  };
  switch (nb) {
    case 2: launch(chol_logdet_kernel<2>); break;
    case 4: launch(chol_logdet_kernel<4>); break;
    case 6: launch(chol_logdet_kernel<6>); break;
    default: launch(chol_logdet_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
