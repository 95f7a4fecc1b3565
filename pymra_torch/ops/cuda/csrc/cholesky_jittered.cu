// Batched jittered Cholesky with per-member escalation, for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_jittered_kernel
// (K2). For every member b of a [B, P, P] float32 batch (P <= 64) it
// factors A_b + f * jit_b * I with f = factors[0]; a member whose log-pivot
// sum is non-finite (NaN for a negative pivot, -inf for an exact zero) is
// factored again at the next factor. Members that succeed keep their first
// result; a member that fails all attempts keeps the NaN factor of its last
// one. The factor is right-looking: column j is a[j:, j] / sqrt(a[j][j]),
// the diagonal included, then the trailing block is downdated; the upper
// triangle of the output is written as zeros. ld is sum_j log L_jj.
//
// Where it runs: the main path's interior levels hand it the r x r blocks
// (r = 4 or 8, B up to 4096): a few hundred flops and under 500 bytes a
// member. The side paths hand it leaf blocks: the triangular leaf route's
// posterior factor and keep_internals' two leaf factors (256 x 49 at
// N=10^4, 16384 x 64 at N=10^6), dense R's R blocks (P = 49) and leaves
// with 9 <= P < 16. Either way the bound is HBM (at 16384 x 64: the lower
// triangle read, the factor written, 0.12 ms at 3.35 TB/s), and what a
// member costs is the latency of its serial chain of P column steps.
//
// Design, P <= 8 (the interior blocks; the host passes tier 0): a sub-warp
// group of G = 4 or 8 lanes per member (subwarp.cuh), G the next power of
// two >= P, so at P = 8 a warp factors four members with every lane busy
// instead of one member on 8 of 32 lanes. Lane i holds row i in registers;
// in column step j the pivot and column j come from lane j by __shfl_sync,
// with no shared memory and no barrier. The warp's members come in and go
// out through a shared-memory tile with coalesced accesses. Each lane keeps
// its original row, so a retry reads nothing from device memory. The
// groups of a warp escalate independently, but a shuffle needs every lane
// of the warp: the warp loops while any of its members still fails, and a
// member that has succeeded recomputes its attempt at its selected factor,
// which reproduces its first result bit for bit.
//
// Design, 9 <= P <= 64 (the host passes the width tier 16, 32, 48 or 64):
// the register-tiled core of chol_tile.cuh, as K4 (cholesky.cu) runs it,
// with K6's escalation loop (chol_logdet.cu): one 64-thread block a
// member, the lower triangle in registers, column j broadcast through the
// core's double buffer (one barrier a step). Each attempt assembles the
// member in registers straight from `a` with f jit_b added on the
// diagonal, so a retry keeps nothing, and stores its factor from
// registers; a retry overwrites it. The core runs in its kFactorRoots
// mode: the pivots' roots go to shared memory, and their logs are taken
// once after the factorization, one a thread, and summed by every thread in
// the twin's order (sum_j log L_jj, L_jj the root), where the factor mode
// takes 64 logs a thread; every thread holds the same sum, so the
// escalation loop is block-uniform and a member's bits depend only on its
// own inputs. Padding is the identity without jitter and never factored.
// Column j is the core's correctly rounded quotient by the pivot's root,
// as the twin divides; the arithmetic departs from the twin only by FMA
// contraction in the downdates. The first kernel for these widths (one warp
// a member, the matrix in shared memory, a rank-1 downdate between
// __syncwarp()s, up to 64 rows on 32 lanes) lost to `cholesky_ex` on the
// device at 256 x 49 (PERF.md).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3,
// tools/kernel_scaling.py --jittered; PERF.md): on a batch where no member
// escalates 0.0167 ms of device time at 256 x 49 (the warp kernel 0.0682,
// `cholesky_ex` and the jitter add 0.0545) and 0.374 ms at 16384 x 64, 32%
// of the bound (the warp kernel 1.45, the library 2.48); 0.061 ms at 256 x
// 49 with members that take all three attempts (the warp kernel 0.206).
//
// Built without fast-math: the escalation relies on IEEE sqrtf/logf giving
// NaN and -inf.

#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "subwarp.cuh"

namespace {

using chol_tile::kThreads;
using subwarp::kFull;
using subwarp::kWarp;

template <int G>
__global__ void __launch_bounds__(subwarp::kThreads)
    chol_jittered_group(const float* __restrict__ a,
                        const float* __restrict__ jit, float* __restrict__ l,
                        float* __restrict__ ld, float* __restrict__ fsel,
                        int batch, int p, float f0, float f1, float f2) {
  __shared__ float tiles[subwarp::kWarps][kWarp * (G + 1)];
  const int lane = threadIdx.x % kWarp;
  const subwarp::WarpSlice ws = subwarp::warp_slice<G>(batch);
  const int g = lane / G, i = lane % G;
  const int member = ws.first + g;
  const bool valid = g < ws.count;
  float* tile = tiles[threadIdx.x / kWarp];
  const size_t off = (size_t)ws.first * p * p;

  const float js = valid ? jit[member] : 0.f;
  subwarp::tile_load<G>(tile, a + off, ws.count, p, lane);
  float orig[G];
#pragma unroll
  for (int k = 0; k < G; ++k)
    orig[k] = (valid && i < p && k < p) ? tile[lane * (G + 1) + k] : 0.f;

  float row[G];
  float fac = f0, acc = 0.f;
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int k = 0; k < G; ++k)
      row[k] = (k == i) ? orig[k] + js * fac : orig[k];
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= p) break;  // p is uniform: the whole warp leaves together
      const float piv = sqrtf(__shfl_sync(kFull, row[j], j, G));
      acc += logf(piv);
      const float c = row[j] / piv;  // L[i][j] on lanes i >= j
      if (i >= j) row[j] = c;
#pragma unroll
      for (int k = j + 1; k < G; ++k) {
        if (k >= p) break;
        const float ck = __shfl_sync(kFull, c, k, G);
        if (i >= k) row[k] -= c * ck;
      }
    }
    // acc is uniform over the group: every lane summed the same pivots
    const bool bad = valid && !isfinite(acc);
    if (t == 2 || !__any_sync(kFull, bad)) break;
    if (bad) fac = t == 0 ? f1 : f2;
  }

  __syncwarp();  // the tile's rows were read; now it takes the factor
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (i < p && k < p) tile[lane * (G + 1) + k] = (k <= i) ? row[k] : 0.f;
  subwarp::tile_store<G>(tile, l + off, ws.count, p, lane);
  if (valid && i == 0) {
    ld[member] = acc;
    fsel[member] = fac;
  }
}

// One attempt at the member in `src` with `add` on its diagonal: assembled
// in registers, factored, the factor stored to `dst` (zeros above the
// diagonal), the log-pivot sum returned, the same on every thread. The
// roots sqrt(d_j) go to logs[j] during the factorization; their logs are
// taken once, one a thread, and every thread sums them in the twin's order.
// Not inlined: inlined into the escalation loop, the compiler kept values of
// one attempt live through the factorization for the next (122 registers a
// thread against the 80 of K4's same factorization, so 8 blocks an SM
// instead of 12; tools/tile_variants.py --k2-inline builds that variant).
template <int NB>
__device__ __noinline__ float attempt(const float* __restrict__ src,
                                     float* __restrict__ dst, float add,
                                     int p, float* col, float* logs) {
  const chol_tile::Place t = chol_tile::place();
  float s[NB][NB], unused[NB][NB];
  chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
    const float v = src[i * p + k];
    return i == k ? v + add : v;
  });
  chol_tile::factor<NB, chol_tile::Mode::kFactorRoots>(s, unused, col, logs,
                                                       p, t);
  __syncthreads();
  if (threadIdx.x < p) logs[threadIdx.x] = logf(logs[threadIdx.x]);
  __syncthreads();
  float acc = 0.f;
  for (int j = 0; j < p; ++j) acc += logs[j];
  chol_tile::store<NB>(s, dst, p, t);
  return acc;
}

// One 64-thread block a member; the escalation loop is block-uniform. A
// retry overwrites the factor its failed attempt stored, so a member that
// fails every attempt keeps the last one's. No minimum of blocks an SM.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    chol_jittered_tile(const float* __restrict__ a,
                       const float* __restrict__ jit, float* __restrict__ l,
                       float* __restrict__ ld, float* __restrict__ fsel,
                       int p, float f0, float f1, float f2) {
  constexpr int kBuf = chol_tile::kGrid * NB;
  __shared__ __align__(16) float col[2 * kBuf];
  __shared__ float logs[kBuf];
  const size_t off = (size_t)blockIdx.x * p * p;
  const float js = jit[blockIdx.x];
  float acc = 0.f, fac = f0;
  for (int att = 0; att < 3; ++att) {
    fac = att == 0 ? f0 : (att == 1 ? f1 : f2);
    acc = attempt<NB>(a + off, l + off, js * fac, p, col, logs);
    if (isfinite(acc)) break;
  }
  if (threadIdx.x == 0) {
    ld[blockIdx.x] = acc;
    fsel[blockIdx.x] = fac;
  }
}

template <int G>
void launch_group(const float* a, const float* jit, float* l, float* ld,
                  float* f, int batch, int p, float f0, float f1, float f2,
                  cudaStream_t stream) {
  const int per_block = subwarp::kWarps * (kWarp / G);
  chol_jittered_group<G>
      <<<(batch + per_block - 1) / per_block, subwarp::kThreads, 0, stream>>>(
          a, jit, l, ld, f, batch, p, f0, f1, f2);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the route the host
// chose for p: 0 the sub-warp groups (p <= 8), or the core's width tier
// (16, 32, 48 or 64, at least p). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a route that cannot take p.
extern "C" int pymra_cholesky_jittered(const void* a, const void* jit,
                                       void* l, void* ld, void* f,
                                       int batch, int p, int tier, float f0,
                                       float f1, float f2, int device,
                                       void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (p < 1 || (tier == 0 ? p > subwarp::kMaxP : (nb == 0 || p > tier)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* av = (const float*)a;
  const float* jv = (const float*)jit;
  float* lv = (float*)l;
  float* ldv = (float*)ld;
  float* fv = (float*)f;
  cudaStream_t s = (cudaStream_t)stream;
  if (tier == 0) {
    if (subwarp::group_size(p) == 4)
      launch_group<4>(av, jv, lv, ldv, fv, batch, p, f0, f1, f2, s);
    else
      launch_group<8>(av, jv, lv, ldv, fv, batch, p, f0, f1, f2, s);
    return (int)cudaGetLastError();
  }
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, s>>>(av, jv, lv, ldv, fv, p, f0, f1, f2);
  };
  switch (nb) {
    case 2: launch(chol_jittered_tile<2>); break;
    case 4: launch(chol_jittered_tile<4>); break;
    case 6: launch(chol_jittered_tile<6>); break;
    default: launch(chol_jittered_tile<8>); break;
  }
  return (int)cudaGetLastError();
}
