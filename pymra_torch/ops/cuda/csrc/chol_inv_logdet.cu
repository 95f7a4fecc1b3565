// Batched jittered inverse Cholesky factor and log-determinant with
// per-member escalation, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// pymra_tpu/ops/pallas/linalg.py::_chol_inv_logdet_kernel (K7, the public
// `cholesky_inv_logdet`). For every member b of a [B, P, P] float32 batch
// (P <= 64) it writes
//
//   X_b  = chol(A_b + f jit_b I)^-1   (lower triangular, zeros above)
//   ld_b = sum_j log L_jj
//
// with the forward-substitution inverse interleaved with the right-looking
// factorization: once column j of L is formed, row j of X is final. The
// factor itself never reaches global memory. f escalates through
// factors[0..2] while ld_b is non-finite (NaN for a negative pivot, -inf
// for an exact zero); a member that fails all three keeps its NaN outputs
// and reports the last factor. The MRA sweep calls it for the posterior
// block K_leaf + A_oo of leaves with 16 <= P <= 64 and dense measurement
// error, where K1's in-kernel K_leaf assembly does not apply.
//
// What bounds it on the card: per member it reads the lower triangle and
// writes P^2 + 2 floats, against ~2 P^3/3 flops an attempt (factor and
// inverse); at the dense-R path's 256 x 49 that is 3.7 MB and 20 MFLOP,
// 0.0011 ms at 3.35 TB/s. 256 members fill two blocks an SM, so what
// bounds a kernel there is the latency of one member's chain of P
// dependent steps, once per attempt. The first kernel (the working matrix
// and X in shared memory, W = ceil(P / 8) warps sweeping rows, two block
// barriers a step) took 0.97 us a step there.
//
// Design: K1's posterior half (leaf_factor.cu) on a plain input: the
// register-tiled core of chol_tile.cuh in its inverse mode
// (Mode::kInverse), one 64-thread block a member, S and X both in
// registers, column j of S and row j of X broadcast through the core's
// double buffers (one barrier a step). Every attempt assembles the member
// in registers straight from `a` with f jit_b added on the diagonal (the
// core sets X to the identity itself), so a retry keeps nothing; X is
// stored from registers after the last attempt, NaN for a member that
// failed all three, as the twin leaves it. The host picks the width tier
// (16, 32, 48 or 64) from P; padding is the identity without jitter and
// never stepped, and its rows and columns are never stored. Every thread
// sums the same pivots, so the escalation loop is block-uniform. Built
// without fast-math: the escalation relies on IEEE sqrtf/logf giving NaN
// and -inf.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3,
// tools/kernel_scaling.py --logdet; PERF.md): at 256 x 49 on a batch
// where no member escalates 0.026 ms of device time, 0.53 us a step (the
// first kernel 0.048), against 0.091 for `cholesky_ex` and
// `solve_triangular` against I; 0.084 with members that take all three
// attempts (the first kernel 0.142).

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::Mode;

// No minimum of blocks an SM: the dense-R path's 256 members fill two an
// SM, so registers do not limit its occupancy (tier 64: 126, no spill).
template <int NB>
__global__ void __launch_bounds__(kThreads)
    chol_inv_logdet_kernel(const float* __restrict__ a,
                           const float* __restrict__ jit,
                           float* __restrict__ xo, float* __restrict__ ld,
                           float* __restrict__ fsel, int p, float f0,
                           float f1, float f2) {
  constexpr int kBuf = kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  __shared__ __align__(16) float xrow[2 * kBuf];
  const chol_tile::Place t = chol_tile::place();
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* src = a + off;
  const float js = jit[blockIdx.x];
  float s[NB][NB], x[NB][NB];
  float acc = 0.f, fac = f0;
  for (int att = 0; att < 3; ++att) {
    fac = att == 0 ? f0 : (att == 1 ? f1 : f2);
    const float add = js * fac;
    chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
      const float v = src[i * p + k];
      return i == k ? v + add : v;
    });
    acc = chol_tile::factor<NB, Mode::kInverse>(s, x, col, xrow, p, t);
    if (isfinite(acc)) break;
  }
  if (threadIdx.x == 0) {
    ld[blockIdx.x] = acc;
    fsel[blockIdx.x] = fac;
  }
  chol_tile::store<NB>(x, xo + off, p, t);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier it does not have.
extern "C" int pymra_chol_inv_logdet(const void* a, const void* jit, void* x,
                                     void* ld, void* f, int batch, int p,
                                     int tier, float f0, float f1, float f2,
                                     int device, void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)jit, (float*)x, (float*)ld, (float*)f,
        p, f0, f1, f2);
  };
  switch (nb) {
    case 2: launch(chol_inv_logdet_kernel<2>); break;
    case 4: launch(chol_inv_logdet_kernel<4>); break;
    case 6: launch(chol_inv_logdet_kernel<6>); break;
    default: launch(chol_inv_logdet_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
