// Batched plain Cholesky factorization for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_kernel (K4,
// the public `cholesky`). For every member b of a [B, P, P] float32 batch
// (P <= 64) it writes the lower factor L with column j equal to
// A'[j:, j] / sqrt(A'[j, j]) (A' the downdated matrix, the diagonal
// included), zeros above the diagonal. No jitter and no escalation: a
// negative or zero pivot turns its column and the trailing block NaN, the
// same pattern as the plain twin `cholesky_ref` and the JAX kernel. The
// MRA sweep calls it in the backward pass of the leaf stage, to refactor
// the prior block K_leaf + fp * jitter * s * I at its selected factor, and
// K8 on its 64-wide diagonal blocks.
//
// What bounds it on the card: at the N=10^6 leaf shape (16,384 blocks of
// 64 x 64) it reads the lower triangle, 136 MB, and writes the whole
// factor, 268 MB (0.12 ms at 3.35 TB/s), for ~1.4 GFLOP (P^3/3 per block,
// 0.02 ms at 67 TFLOP/s), so HBM is the roofline bound. The first kernel
// was bound by its serial column loop instead: 64 steps a member, each a
// shared-memory downdate (three shared accesses per multiply-subtract)
// and a block barrier (1.5 ms, 8% of the bound, on an H100 80GB HBM3 at
// 700 W; PERF.md).
//
// Design: the register-tiled core of chol_tile.cuh in its factor mode, one
// 64-thread block per member: the lower triangle lives in registers, column
// j goes through a shared double buffer once a step (one barrier), the
// column's owners keep L[:, j] in place and the factor is stored straight
// from registers. The host picks the width tier (16, 32, 48 or 64) from P;
// padding is the identity and never factored. Column j is the correctly
// rounded quotient by the pivot, as the twin divides, so a failing pivot's
// inf and NaN spread as the twin's do. Built without fast-math. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_timing.py): 0.363 ms
// a call at 16384 x 64, 0.349 ms on the device, 35% of the bound (0.268 ms
// with the column scaled by the reciprocal; the first kernel 1.51 ms;
// `cholesky_ex` 2.05).

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::Mode;

template <int NB>
__global__ void __launch_bounds__(kThreads)
    cholesky_kernel(const float* __restrict__ a, float* __restrict__ l,
                    int p) {
  constexpr int kBuf = kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  const chol_tile::Place t = chol_tile::place();
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* src = a + off;
  float s[NB][NB], unused[NB][NB];
  chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
    return src[i * p + k];
  });
  chol_tile::factor<NB, Mode::kFactor>(s, unused, col, nullptr, p, t);
  chol_tile::store<NB>(s, l + off, p, t);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier it does not have.
extern "C" int pymra_cholesky(const void* a, void* l, int batch, int p,
                              int tier, int device, void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (float*)l, p);
  };
  switch (nb) {
    case 2: launch(cholesky_kernel<2>); break;
    case 4: launch(cholesky_kernel<4>); break;
    case 6: launch(cholesky_kernel<6>); break;
    default: launch(cholesky_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
