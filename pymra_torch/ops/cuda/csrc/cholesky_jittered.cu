// Batched jittered Cholesky with per-member escalation, for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_jittered_kernel
// (K2). For every member b of a [B, P, P] float32 batch it factors
// A_b + f * jit_b * I with f = factors[0]; a member whose log-pivot sum is
// non-finite (NaN for a negative pivot, -inf for an exact zero) is factored
// again at the next factor. Members that succeed keep their first result; a
// member that fails all attempts keeps the NaN factor of its last one. The
// factor is right-looking: column j is a[j:, j] / sqrt(a[j][j]), the
// diagonal included, then the trailing block is downdated; the upper
// triangle of the output is written as zeros.
//
// What bounds it on the card: the main path calls it on many tiny matrices
// (r x r interior blocks, r = 4 or 8, B up to 4096): a few hundred flops and
// under 500 bytes a member, so the bound is microseconds and what a call
// costs is its launch and the serial column loop of each member.
//
// Design, P <= 8 (the interior blocks, r = 4 or 8): a sub-warp group of G
// = 4 or 8 lanes per member (subwarp.cuh), G the next power of two >= P, so
// at P = 8 a warp factors four members with every lane busy instead of one
// member on 8 of 32 lanes. Lane i holds row i in registers; in column step
// j the pivot and column j come from lane j by __shfl_sync, with no shared
// memory and no barrier. The warp's members come in and go out through a
// shared-memory tile with coalesced accesses. Each lane keeps its original
// row, so a retry reads nothing from device memory. The groups of a warp
// escalate independently, but a shuffle needs every lane of the warp: the
// warp loops while any of its members still fails, and a member that has
// succeeded recomputes its attempt at its selected factor, which reproduces
// its first result bit for bit.
//
// Design, 9 <= P <= 64 (dense-R blocks at P = 49): one warp per member,
// lane i owning rows i and i + 32 of the matrix in shared memory with a
// padded row stride (P + 1); each column step is a shared-memory rank-1
// downdate between __syncwarp()s.
//
// Built without fast-math: the escalation relies on IEEE sqrtf/logf giving
// NaN and -inf.

#include <cuda_runtime.h>

#include "subwarp.cuh"

namespace {

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

__global__ void chol_jittered_warp(const float* __restrict__ a,
                                   const float* __restrict__ jit,
                                   float* __restrict__ l,
                                   float* __restrict__ ld,
                                   float* __restrict__ fsel, int batch, int p,
                                   float f0, float f1, float f2) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int member = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (member >= batch) return;
  const int st = p + 1;
  float* s = smem + (size_t)warp * p * st;
  const float* src = a + (size_t)member * p * p;
  const float js = jit[member];
  const float factors[3] = {f0, f1, f2};

  float acc = 0.f;
  float fac = f0;
  for (int t = 0; t < 3; ++t) {
    fac = factors[t];
    const float add = js * fac;
    for (int e = lane; e < p * p; e += kWarp) {
      const int i = e / p, k = e - i * p;
      float v = src[e];
      if (i == k) v += add;
      s[i * st + k] = v;
    }
    __syncwarp();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float piv = sqrtf(s[j * st + j]);
      acc += logf(piv);
      __syncwarp();  // every lane has read the pivot before it is scaled
      for (int i = j + lane; i < p; i += kWarp) s[i * st + j] /= piv;
      __syncwarp();
      for (int i = j + 1 + lane; i < p; i += kWarp) {
        const float ci = s[i * st + j];
        for (int k = j + 1; k <= i; ++k) s[i * st + k] -= ci * s[k * st + j];
      }
      __syncwarp();
    }
    // acc is warp-uniform: every lane summed the same pivots
    if (isfinite(acc)) break;
  }

  float* dst = l + (size_t)member * p * p;
  for (int e = lane; e < p * p; e += kWarp) {
    const int i = e / p, k = e - i * p;
    dst[e] = (k <= i) ? s[i * st + k] : 0.f;
  }
  if (lane == 0) {
    ld[member] = acc;
    fsel[member] = fac;
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

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
// P <= 8 takes the sub-warp kernel, 9 <= P <= 64 the warp-per-member one.
extern "C" int pymra_cholesky_jittered(const void* a, const void* jit,
                                       void* l, void* ld, void* f,
                                       int batch, int p, float f0, float f1,
                                       float f2, int device, void* stream) {
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* av = (const float*)a;
  const float* jv = (const float*)jit;
  float* lv = (float*)l;
  float* ldv = (float*)ld;
  float* fv = (float*)f;
  cudaStream_t s = (cudaStream_t)stream;
  if (p <= subwarp::kMaxP) {
    if (subwarp::group_size(p) == 4)
      launch_group<4>(av, jv, lv, ldv, fv, batch, p, f0, f1, f2, s);
    else
      launch_group<8>(av, jv, lv, ldv, fv, batch, p, f0, f1, f2, s);
    return (int)cudaGetLastError();
  }
  const size_t per_warp = (size_t)p * (p + 1) * sizeof(float);
  int warps = (int)((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int blocks = (batch + warps - 1) / warps;
  chol_jittered_warp<<<blocks, warps * kWarp, warps * per_warp, s>>>(
      av, jv, lv, ldv, fv, batch, p, f0, f1, f2);
  return (int)cudaGetLastError();
}
