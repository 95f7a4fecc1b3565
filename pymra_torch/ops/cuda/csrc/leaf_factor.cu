// Fused MRA leaf factorization for Hopper (sm_90a).
//
// Replaces the two TPU kernels behind pymra_tpu/ops/pallas/linalg.py::
// leaf_factor (K1): _kleaf_logdet_kernel (K1a, the prior) and
// _kleaf_inv_logdet_kernel (K1b, the posterior). For every leaf b of a batch
// of P x P blocks (P <= 64) it computes, in one launch:
//
//   K_leaf = C ⊙ k k^T + diag(1 - k)            (C = C_own, k = knot mask)
//   s      = mean_j |K_leaf[j, j]| + 1          (the scale-relative jitter)
//   ld_prior = 1/2 sum_j log d_j of K_leaf + f_p * jitter * s * I,
//              d_j the downdated pivots (the factor itself is never formed)
//   X = chol((C + A_oo) ⊙ k k^T + diag(1 - k) + f_q * jitter * s * I)^-1
//   ld_post  = sum_j log L_jj of that factor
//
// with f_p, f_q each escalated through factors[0..2] while the member's
// log-pivot sum is non-finite (NaN for a negative pivot, -inf for an exact
// zero). A member that fails all three keeps its NaN outputs.
//
// What bounds it on the card: at the N=10^6 leaf level (16,384 blocks of
// 64 x 64) it must read C's and A_oo's lower triangles and the mask and
// write X, 0.16 ms at 3.35 TB/s, for P^3 flops a member (0.07 ms at 67
// TFLOP/s). What bounded the first kernel was its serial column loop: 192
// dependent steps a member, each a shared-memory update with three shared
// accesses per multiply-subtract and a barrier for the longest row (6.2
// ms, 2.6% of the bound, on an H100 80GB HBM3 at 700 W; PERF.md).
//
// Design: the register-tiled core of chol_tile.cuh, one 64-thread block
// per leaf. The prior runs the core's pivot-only mode on K_leaf, the
// posterior its inverse mode (S and X both in registers, column j of S and
// row j of X broadcast through the core's double buffers, one barrier a
// step). The knot mask and the jitter scale come in through shared memory
// once; the working matrix is assembled in registers straight from C, k and
// A_oo on every attempt, so K_leaf and K_leaf + A_oo never exist in device
// memory and a retry needs nothing kept. The host picks the width tier
// (16, 32, 48 or 64) from P; padding is the identity without jitter and no
// padded pivot is ever taken, so it adds exactly nothing to a
// log-determinant. Escalation is per block, so per member: every thread
// sums the same pivots, the loop is block-uniform, and a member's bits do
// not depend on its neighbours. Built without fast-math: the escalation
// relies on IEEE sqrtf/logf giving NaN and -inf. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (tools/kernel_timing.py): 1.196 ms a call at
// 16384 x 64, 1.185 ms on the device, 14% of the bound, with the core's
// correctly rounded column quotient (0.972 ms with the reciprocal; the
// first kernel 6.19 ms); at 256 x 49 ~0.13 ms a call, a launch's worth of
// host time.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::Mode;

// At least 12 blocks an SM (at most 85 registers a thread): the 64-wide
// tier would take 164 and fit 6 blocks; at 12, with 120 bytes spilled, it
// ran 0.958 against 1.353 ms at 16384 x 64 (tools/tile_variants.py, H100
// 80GB HBM3, 700 W): the step loop is latency-bound and wants the warps.
template <int NB>
__global__ void __launch_bounds__(kThreads, 12)
    leaf_factor_kernel(const float* __restrict__ c,
                       const float* __restrict__ kmask,
                       const float* __restrict__ a_oo, float jitter,
                       float* __restrict__ li, float* __restrict__ ldp,
                       float* __restrict__ ldq, float* __restrict__ fp,
                       float* __restrict__ fq, int p, float f0, float f1,
                       float f2) {
  constexpr int kBuf = kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  __shared__ __align__(16) float xrow[2 * kBuf];
  __shared__ float km[kBuf];
  __shared__ float dg[kBuf];
  const int tid = threadIdx.x;
  const chol_tile::Place t = chol_tile::place();
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* cb = c + off;
  const float* ab = a_oo + off;

  if (tid < p) km[tid] = kmask[(size_t)blockIdx.x * p + tid];
  __syncthreads();
  if (tid < p) dg[tid] = fabsf(cb[tid * p + tid] * km[tid] + (1.f - km[tid]));
  __syncthreads();
  float sum = 0.f;
  for (int j = 0; j < p; ++j) sum += dg[j];
  const float jit_eff = jitter * (sum / (float)p + 1.f);

  float s[NB][NB], x[NB][NB];

  // ---- prior: pivot-only log-determinant of K_leaf + f_p jit I ----
  float acc = 0.f, fac = f0;
  for (int att = 0; att < 3; ++att) {
    fac = att == 0 ? f0 : (att == 1 ? f1 : f2);
    const float add = jit_eff * fac;
    chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
      float v = cb[i * p + k] * (km[i] * km[k]);
      if (i == k) v = (v + (1.f - km[i])) + add;
      return v;
    });
    acc = 0.5f * chol_tile::factor<NB, Mode::kLogdet>(s, x, col, xrow, p, t);
    if (isfinite(acc)) break;
  }
  if (tid == 0) {
    ldp[blockIdx.x] = acc;
    fp[blockIdx.x] = fac;
  }

  // ---- posterior: inverse factor of K_leaf + A_oo + f_q jit I ----
  for (int att = 0; att < 3; ++att) {
    fac = att == 0 ? f0 : (att == 1 ? f1 : f2);
    const float add = jit_eff * fac;
    chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
      float v = (cb[i * p + k] + ab[i * p + k]) * (km[i] * km[k]);
      if (i == k) v = (v + (1.f - km[i])) + add;
      return v;
    });
    acc = chol_tile::factor<NB, Mode::kInverse>(s, x, col, xrow, p, t);
    if (isfinite(acc)) break;
  }
  if (tid == 0) {
    ldq[blockIdx.x] = acc;
    fq[blockIdx.x] = fac;
  }
  chol_tile::store<NB>(x, li + off, p, t);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier it does not have.
extern "C" int pymra_leaf_factor(const void* c, const void* kmask,
                                 const void* a_oo, float jitter, void* li,
                                 void* ldp, void* ldq, void* fp, void* fq,
                                 int batch, int p, int tier, float f0,
                                 float f1, float f2, int device,
                                 void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)c, (const float*)kmask, (const float*)a_oo, jitter,
        (float*)li, (float*)ldp, (float*)ldq, (float*)fp, (float*)fq, p, f0,
        f1, f2);
  };
  switch (nb) {
    case 2: launch(leaf_factor_kernel<2>); break;
    case 4: launch(leaf_factor_kernel<4>); break;
    case 6: launch(leaf_factor_kernel<6>); break;
    default: launch(leaf_factor_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
