// Batched triangular solve with a lower factor, and the Cholesky pullback
// built on the same substitutions, for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_tri_solve_kernel
// (K5, the public `solve_triangular_batched`). For every member of a
// batch, with L [P, P] lower (P <= 64) and b [P, Q], it solves
//
//   L x = b   by forward substitution:
//     x[i] = (b[i] - sum_{k<i} L[i][k] x[k]) / L[i][i], k ascending;
//   L^T x = b by back substitution, reading L[k][i] for L^T[i][k]:
//     x[i] = (b[i] - sum_{k>i} L[k][i] x[k]) / L[i][i], k descending;
//
// the order in which the plain twin `solve_triangular_batched_ref`
// subtracts. Only L's lower triangle is read.
//
// The MRA sweep's gradient needs these solves in the Cholesky pullback of
// every jittered interior factorization (K2's backward): two back
// substitutions with Q = P on r x r blocks, r = 4 or 8, around a product
// and a symmetrization. The JAX package's `_cholesky_bwd` composes them
// from one matmul and two K5 launches; `chol_pullback_*` below fuse that
// whole pullback into one launch per call,
//
//   W = phi(L^T Lbar'),  Lbar' = Lbar + diag(ldbar / diag L),
//   X = L^-T W,  raw = X L^-1,  Abar = (raw + raw^T) / 2,
//   jbar = f * trace(Abar),
//
// in float32 with the composition's operations in its order (phi keeps the
// lower triangle and halves the diagonal; raw's rows are back substitutions
// of X's rows against L^T). Terms with L's zero upper triangle are skipped.
//
// What bounds it on the card: the main-path shapes are tiny ([4096, 8, 8]
// is 0.8 MB in and out, a few hundred flops a member), so a call costs its
// launch, not its bytes or flops; hence one launch for the product, both
// substitutions and the symmetrization, where a composition takes about a
// dozen.
//
// Design of the solve: one thread per right-hand-side column runs the whole
// substitution for it, with the member's L and its x in shared memory; the
// threads of one member read the same L entry at the same time (a
// broadcast) and their own consecutive x entries. A block packs as many
// members as 256 threads and 48 KB of shared memory allow (32 members at
// P = Q = 8).
//
// Design of the pullback, P <= 8 (the interior blocks): a sub-warp group of
// G = 4 or 8 lanes per member (subwarp.cuh), registers and __shfl_sync.
// Lane i holds column i of L and row i of Lbar, W, X and raw in turn; the
// transpose in Abar goes through the warp's shared-memory tile, which also
// carries the coalesced loads and stores. 9 <= P <= 64 (dense-R blocks at
// P = 49): one member per block, one thread per column, L and W/X/raw in
// shared memory (33 KB at P = 64).
//
// Built without fast-math.

#include <cuda_runtime.h>

#include "subwarp.cuh"

namespace {

using subwarp::kFull;
using subwarp::kWarp;

__global__ void tri_solve_kernel(const float* __restrict__ l,
                                const float* __restrict__ b,
                                float* __restrict__ x, int batch, int p,
                                int q, int transpose) {
  extern __shared__ float smem[];
  const int st = p | 1;
  const int per = p * st + p * q;  // floats per member: L, then x
  const int mats = blockDim.x / q;
  const int local = threadIdx.x / q;
  const int c = threadIdx.x % q;
  const int first = blockIdx.x * mats;
  const int nmat = min(mats, batch - first);

  for (int e = threadIdx.x; e < nmat * p * p; e += blockDim.x) {
    const int m = e / (p * p), r = e - m * p * p;
    const int i = r / p, k = r - i * p;
    if (k <= i) smem[m * per + i * st + k] = l[(size_t)first * p * p + e];
  }
  for (int e = threadIdx.x; e < nmat * p * q; e += blockDim.x) {
    const int m = e / (p * q), r = e - m * p * q;
    smem[m * per + p * st + r] = b[(size_t)first * p * q + e];
  }
  __syncthreads();
  if (local >= nmat) return;
  const float* lm = smem + local * per;
  float* xm = smem + local * per + p * st;
  float* out = x + (size_t)(first + local) * p * q;
  if (!transpose) {
    for (int i = 0; i < p; ++i) {
      float acc = xm[i * q + c];
      for (int k = 0; k < i; ++k) acc -= lm[i * st + k] * xm[k * q + c];
      const float v = acc / lm[i * st + i];
      xm[i * q + c] = v;
      out[i * q + c] = v;
    }
  } else {
    for (int i = p - 1; i >= 0; --i) {
      float acc = xm[i * q + c];
      for (int k = p - 1; k > i; --k) acc -= lm[k * st + i] * xm[k * q + c];
      const float v = acc / lm[i * st + i];
      xm[i * q + c] = v;
      out[i * q + c] = v;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(subwarp::kThreads)
    chol_pullback_group(const float* __restrict__ l,
                        const float* __restrict__ lbar,
                        const float* __restrict__ ldbar,
                        const float* __restrict__ f, float* __restrict__ abar,
                        float* __restrict__ jbar, int batch, int p) {
  __shared__ float tiles[subwarp::kWarps][kWarp * (G + 1)];
  const int lane = threadIdx.x % kWarp;
  const subwarp::WarpSlice ws = subwarp::warp_slice<G>(batch);
  const int g = lane / G, i = lane % G;
  const int member = ws.first + g;
  const bool valid = g < ws.count && i < p;
  float* tile = tiles[threadIdx.x / kWarp];
  const size_t off = (size_t)ws.first * p * p;

  // column i of L (its lower part) and row i of Lbar, both read at once
  float lc[G], w[G];
  subwarp::tile_fetch<G>(lc, l + off, ws.count, p, lane);
  subwarp::tile_fetch<G>(w, lbar + off, ws.count, p, lane);
  subwarp::tile_put<G>(tile, lc, ws.count, p, lane);
#pragma unroll
  for (int t = 0; t < G; ++t)
    lc[t] = (valid && t < p && t >= i) ? tile[(g * G + t) * (G + 1) + i]
                                       : 0.f;
  __syncwarp();  // L read by every lane before Lbar overwrites the tile
  subwarp::tile_put<G>(tile, w, ws.count, p, lane);
#pragma unroll
  for (int k = 0; k < G; ++k)
    w[k] = (valid && k < p) ? tile[lane * (G + 1) + k] : 0.f;
  if (ldbar != nullptr && valid) {
    const float add = ldbar[member] / subwarp::pick<G>(lc, i);
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k == i) w[k] += add;
  }

  // W = phi(L^T Lbar'): lane i forms row i of the product, t >= i
  float m[G];
#pragma unroll
  for (int k = 0; k < G; ++k) m[k] = 0.f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (t >= p) break;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= p) break;
      const float v = __shfl_sync(kFull, w[k], t, G);
      if (t >= i) m[k] = fmaf(lc[t], v, m[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k)
    w[k] = k < i ? m[k] : (k == i ? m[k] - 0.5f * m[k] : 0.f);

  // X = L^-T W: back substitution over the rows, lane i holding row i
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int j = G - 1 - s;
    if (j >= p) continue;
    if (i == j) {
#pragma unroll
      for (int k = 0; k < G; ++k) w[k] /= lc[j];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= p) break;
      const float xj = __shfl_sync(kFull, w[k], j, G);
      if (i < j) w[k] -= lc[j] * xj;
    }
  }

  // raw = X L^-1: lane i back-substitutes its row of X against L^T,
  // L[t][j] coming from lane j's column
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int t = G - 1 - s;
    if (t >= p) continue;
    w[t] /= __shfl_sync(kFull, lc[t], t, G);
#pragma unroll
    for (int j = 0; j < t; ++j) {
      const float ltj = __shfl_sync(kFull, lc[t], j, G);
      w[j] -= ltj * w[t];
    }
  }

  // Abar = (raw + raw^T) / 2, the transpose through the tile
  __syncwarp();
#pragma unroll
  for (int k = 0; k < G; ++k) tile[lane * (G + 1) + k] = w[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < G; ++k)
    w[k] = 0.5f * (w[k] + tile[(g * G + k) * (G + 1) + i]);
  const float diag = subwarp::pick<G>(w, i);
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= p) break;
    tr += __shfl_sync(kFull, diag, k, G);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < G; ++k) tile[lane * (G + 1) + k] = w[k];
  subwarp::tile_store<G>(tile, abar + off, ws.count, p, lane);
  if (valid && i == 0 && jbar != nullptr) jbar[member] = f[member] * tr;
}

__global__ void chol_pullback_block(const float* __restrict__ l,
                                    const float* __restrict__ lbar,
                                    const float* __restrict__ ldbar,
                                    const float* __restrict__ f,
                                    float* __restrict__ abar,
                                    float* __restrict__ jbar, int p) {
  extern __shared__ float smem[];
  const int st = p | 1;
  float* ls = smem;           // L, lower triangle
  float* ws = smem + p * st;  // Lbar', then W, X and raw in place
  const int member = blockIdx.x, c = threadIdx.x;
  const float* lm = l + (size_t)member * p * p;
  const float* lb = lbar + (size_t)member * p * p;
  for (int e = c; e < p * p; e += blockDim.x) {
    const int i = e / p, k = e - i * p;
    if (k <= i) ls[i * st + k] = lm[e];
    ws[i * st + k] = lb[e];
  }
  __syncthreads();
  if (ldbar != nullptr && c < p)
    ws[c * st + c] += ldbar[member] / ls[c * st + c];
  __syncthreads();

  if (c < p) {
    // column c of W = phi(L^T Lbar'), rows up (row i reads rows >= i only)
    for (int i = 0; i < p; ++i) {
      float wv = 0.f;
      if (i >= c) {
        float mv = 0.f;
        for (int t = i; t < p; ++t)
          mv = fmaf(ls[t * st + i], ws[t * st + c], mv);
        wv = i == c ? mv - 0.5f * mv : mv;
      }
      ws[i * st + c] = wv;
    }
    // column c of X = L^-T W
    for (int j = p - 1; j >= 0; --j) {
      const float xj = ws[j * st + c] / ls[j * st + j];
      ws[j * st + c] = xj;
      for (int i = 0; i < j; ++i) ws[i * st + c] -= ls[j * st + i] * xj;
    }
  }
  __syncthreads();
  if (c < p) {
    // row c of raw = X L^-1, in place: this thread alone touches row c
    float* y = ws + c * st;
    for (int t = p - 1; t >= 0; --t) {
      const float yt = y[t] / ls[t * st + t];
      y[t] = yt;
      for (int j = 0; j < t; ++j) y[j] -= ls[t * st + j] * yt;
    }
  }
  __syncthreads();
  if (c < p) {
    float* out = abar + (size_t)member * p * p;
    for (int i = 0; i < p; ++i)
      out[i * p + c] = 0.5f * (ws[i * st + c] + ws[c * st + i]);
  }
  if (jbar != nullptr && c == 0) {
    float tr = 0.f;
    for (int i = 0; i < p; ++i)
      tr += 0.5f * (ws[i * st + i] + ws[i * st + i]);
    jbar[member] = f[member] * tr;
  }
}

template <int G>
void launch_pullback(const float* l, const float* lbar, const float* ldbar,
                     const float* f, float* abar, float* jbar, int batch,
                     int p, cudaStream_t s) {
  const int per_block = subwarp::kWarps * (kWarp / G);
  chol_pullback_group<G>
      <<<(batch + per_block - 1) / per_block, subwarp::kThreads, 0, s>>>(
          l, lbar, ldbar, f, abar, jbar, batch, p);
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
// The wrapper guarantees q <= 1024 and one member's L and x within 48 KB.
extern "C" int pymra_tri_solve(const void* l, const void* b, void* x,
                               int batch, int p, int q, int transpose,
                               int device, void* stream) {
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const size_t per = ((size_t)p * (p | 1) + (size_t)p * q) * sizeof(float);
  int mats = (int)((48 * 1024) / per);
  const int by_threads = q >= 256 ? 1 : 256 / q;
  mats = mats < 1 ? 1 : (mats > by_threads ? by_threads : mats);
  const int blocks = (batch + mats - 1) / mats;
  tri_solve_kernel<<<blocks, mats * q, mats * per, (cudaStream_t)stream>>>(
      (const float*)l, (const float*)b, (float*)x, batch, p, q, transpose);
  return (int)cudaGetLastError();
}

// The fused Cholesky pullback for P <= 64: the sub-warp kernel up to
// subwarp::kMaxP, the block kernel above. `ldbar` may be null (no
// log-determinant cotangent); with `f` null no jbar is written.
extern "C" int pymra_chol_pullback(const void* l, const void* lbar,
                                   const void* ldbar, const void* f,
                                   void* abar, void* jbar, int batch, int p,
                                   int device, void* stream) {
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* lv = (const float*)l;
  const float* lb = (const float*)lbar;
  const float* ld = (const float*)ldbar;
  const float* fv = (const float*)f;
  float* av = (float*)abar;
  float* jv = f != nullptr ? (float*)jbar : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (p <= subwarp::kMaxP) {
    if (subwarp::group_size(p) == 4)
      launch_pullback<4>(lv, lb, ld, fv, av, jv, batch, p, s);
    else
      launch_pullback<8>(lv, lb, ld, fv, av, jv, batch, p, s);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)p * (p | 1) * sizeof(float);
  chol_pullback_block<<<batch, 64, smem, s>>>(lv, lb, ld, fv, av, jv, p);
  return (int)cudaGetLastError();
}
