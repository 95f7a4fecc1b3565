// Batched explicit inverse of lower-triangular matrices, P <= 64, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_tri_inv_kernel
// (K3, the public `triangular_inverse_lower`). For every member of a
// [B, P, P] float32 batch of lower factors (P <= 64; only the lower
// triangle is read) it writes X = L^-1 by forward substitution against the
// identity, zeros above the diagonal:
//
//   X[i][c] = (delta_ic - sum_{k<i} L[i][k] X[k][c]) / L[i][i],
//
// the k-sum in ascending order, the operations of the plain twin
// `triangular_inverse_lower_ref` (which subtracts row k's multiple for k =
// 0, 1, ... and divides last) but for FMA contraction. The MRA sweep calls
// it in the backward pass of the leaf stage, to invert the prior block's
// factor refactored at its selected jitter (the prior pullback needs
// K_p^-1), and in K6's backward; tri_inv_wide.cu inverts its 64-wide
// diagonal blocks with the same core.
//
// What bounds it on the card: at 16,384 blocks of 64 x 64 it reads the
// lower triangle, 136 MB, and writes the whole inverse, 268 MB (0.12 ms
// at 3.35 TB/s), for ~1.4 GFLOP (P^3/3 per block), so HBM is the
// roofline bound. The substitution is a serial chain of P steps. The first
// kernel ran it one thread a column with L in shared memory: every
// multiply-subtract loaded two shared operands, a 64-wide member kept 64
// threads busy on P^2/2 dependent steps each, with a division a row (1.355
// ms, 9% of the bound, on an H100 80GB HBM3 at 700 W; PERF.md).
//
// Design: the register-tiled core of chol_tile.cuh in its inverse mode
// (Mode::kTriInv), one 64-thread block a member: L's lower triangle and X
// live in registers in the core's tile map, each step broadcasts column j
// of L and row j of X through the core's double buffer (one barrier a
// step), every thread scales its part of row j by the correctly rounded
// quotient by L[j][j] and updates its rows of X below j on registers. The
// host picks the width tier (16, 32, 48 or 64) from P; padding is the
// identity and never stepped. A member with a non-finite entry below the
// diagonal or a diagonal entry outside the quotient's exact range
// (chol_tile::regular: zero, subnormal, above 2^126, inf or NaN) is
// inverted instead by chol_tile::substitute, the twin's whole-row
// substitution with IEEE division, so its inf and NaN land where the
// twin's do (the twin's updates run over whole rows, so a zero or NaN
// spreads above the diagonal too). For the others the tile map holds the
// twin's values: the only terms it skips are L[i][j] * 0 with a finite
// L[i][j]. Built without fast-math.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3):
// 0.366 ms a call at 16384 x 64, 0.362 ms on the device, 33% of the bound
// (the thread-per-column kernel 1.355, `solve_triangular` 2.151); at 256 x
// 49 0.039 ms a call, 0.017 on the device. At least 16 blocks an SM (64
// registers, 24 bytes spilled): 0.368 against 0.395 ms with no bound (80
// registers) and 0.439 at 12 (tools/tile_variants.py).

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::Mode;

template <int NB>
__global__ void __launch_bounds__(kThreads, 16)
    tri_inv_kernel(const float* __restrict__ l, float* __restrict__ x,
                   int p) {
  constexpr int kBuf = kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  __shared__ __align__(16) float xrow[2 * kBuf];
  __shared__ float diag[kBuf];
  const chol_tile::Place t = chol_tile::place();
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* src = l + off;
  float* dst = x + off;
  if (threadIdx.x < p) diag[threadIdx.x] = src[threadIdx.x * (p + 1)];
  float s[NB][NB], xt[NB][NB];
  bool odd = false;
  chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
    const float v = src[i * p + k];
    odd |= !chol_tile::regular(v, i == k);
    return v;
  });
  if (__syncthreads_or(odd)) {
    chol_tile::substitute(src, dst, p, p, threadIdx.x, kThreads);
    return;
  }
  chol_tile::factor<NB, Mode::kTriInv>(s, xt, col, xrow, p, t,
                                       chol_tile::BlockSync(), diag);
  chol_tile::store<NB>(xt, dst, p, t);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tier it does not have.
extern "C" int pymra_tri_inv(const void* l, void* x, int batch, int p,
                             int tier, int device, void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)l, (float*)x, p);
  };
  switch (nb) {
    case 2: launch(tri_inv_kernel<2>); break;
    case 4: launch(tri_inv_kernel<4>); break;
    case 6: launch(tri_inv_kernel<6>); break;
    default: launch(tri_inv_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}
