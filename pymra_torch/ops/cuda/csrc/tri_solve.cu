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
// The MRA sweep calls K5 once per evaluation on the dense-R path: the
// whitening of the data, yw = L_R^-1 y0, [256, 49, 49] x [256, 49, 1] at
// the N=10^4 leaves, forward only (L_R and y0 do not depend on the
// parameters; the basis whitening, Q = 65, goes to the library solve, as
// the JAX package sends it to XLA). What bounds it on the card: 1.35 MB of
// lower triangles, b and x (0.0004 ms at 3.35 TB/s) for 0.6 MFLOP, so
// bytes; but a launch lasts one member's chain of P dependent steps. The
// first kernel ran one thread per right-hand side with L in shared memory:
// at Q = 1 a block of 5 threads for 5 members, each thread loading ~2,400
// entries with two integer divisions each and then running its member's
// 1,176 multiply-subtracts from shared memory one after another.
//
// Design of the solve: the register-tiled core's solve mode
// (chol_tile.cuh: solve), one 64-thread block per member and slab of at
// most C <= 8 columns of b, C chosen by the host from Q (1, 2, 4 or 8; a
// wider b takes several slabs, each its own block): L in the core's tile
// map, X on a (64 / C) x C grid of threads in registers, so that at Q = 1
// every thread holds one row; each step its owners broadcast column j of
// L (transposed: row j) and row j of X scaled by the correctly rounded
// quotient by L[j][j] through the core's double buffer, one barrier a
// step, and the rows past j take their multiply-subtracts on registers. A
// member with a non-finite entry or a diagonal entry outside the
// quotient's exact range takes the twin's whole-row substitution with
// division (chol_tile::substitute_solve).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_scaling.py
// --solve, device time): at 256 x 49 x 1 0.0090 ms, against 0.460 for
// the thread-per-column kernel and 0.0258 for `solve_triangular` (four
// launches); at 4096 x 8 x 8 transposed 0.0050, against 0.0067 and 0.0091.
// One member's chain of 49 dependent steps is the launch (0.18 us a step,
// the launch's own cost included).
//
// The MRA sweep's gradient needs the same substitutions in the Cholesky
// pullback of every jittered interior factorization (K2's backward): two
// back substitutions with Q = P on r x r blocks, r = 4 or 8, around a
// product and a symmetrization. The JAX package's `_cholesky_bwd` composes
// them from one matmul and two K5 launches; `chol_pullback_*` below fuse
// that whole pullback into one launch per call,
//
//   W = phi(L^T Lbar'),  Lbar' = Lbar + diag(ldbar / diag L),
//   X = L^-T W,  raw = X L^-1,  Abar = (raw + raw^T) / 2,
//   jbar = f * trace(Abar),
//
// in float32 with the composition's operations in its order (phi keeps the
// lower triangle and halves the diagonal; raw's rows are back substitutions
// of X's rows against L^T). Terms with L's zero upper triangle are skipped
// (the pullback mode keeps their NaN where Lbar' is not finite).
// The main paths hand it (4^m, 8) for m = 0..6 at N=10^6 and (4^m, 4) for
// m = 0..3 at N=10^4, each level twice a value-and-gradient evaluation:
// [4096, 8, 8] is 0.8 MB in and out, a few hundred flops a member, so a
// call costs its launch and the latency of its 2P dependent steps, not
// its bytes or flops.
//
// Design of the pullback, P <= 8 (the interior blocks): one entry of the
// member a lane, G x G entries over min(G^2, 32) lanes (G = 4 or 8, the
// next power of two >= P, at least 4): at P = 8 a warp a member, two
// entries a lane (rows i and i + 4 of column k), at P <= 4 half a warp.
// Each lane holds the columns of L its entries need in registers; every
// step of the product and of both substitutions is one __shfl_sync and one
// FMA a lane, and the owners of row (column) j scale by the quotient with
// 1 / L[j][j] taken once. The transpose of Abar is one more shuffle.
// Measured as above: 0.0084 ms at 4096 x 8 (one row a lane of 8-lane
// groups before: 0.0186), 0.0041-0.0045 at 4^m x 8 up to 1024 members
// (0.0136-0.0180), 0.0025 at 4^m x 4 (0.0053-0.0070).
// Design, 9 <= P <= 64 (K2's backward at the leaves of the triangular
// route, 256 x 49 at N=10^4 and 16384 x 64 at N=10^6; the dense-R blocks
// at P = 49): the register-tiled core's pullback mode (chol_tile.cuh:
// pullback), one 64-thread block a member at the width tier the host
// passes; the whole square in registers on the core's tile map, L in
// shared memory, three sweeps of p steps (the product, X's rows, raw's
// columns) of one barrier each. It replaces a kernel of one thread a
// column with L, W, X and raw in shared memory (33 KB at P = 64): every
// step of its three chains of P^2 / 2 took two shared loads, a store and
// an IEEE division, 15 of 64 threads idle at P = 49. Measured as above
// (tools/kernel_scaling.py --pullback, both kernels in one call): 0.0372
// ms at 256 x 49 and 1.046 at 16384 x 64, against 0.0914 and 3.458 for
// the replaced kernel.
//
// Built without fast-math.

#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "subwarp.cuh"

namespace {

using chol_tile::kThreads;
using subwarp::kFull;
using subwarp::kWarp;

// the member's block as the solve mode's team: each thread runs its own
// part, the barriers are the block's
template <class Part>
struct BlockTeam {
  Part part;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(part, (int)threadIdx.x);
  }
  template <class F>
  __device__ __forceinline__ bool any(F f) {
    return __syncthreads_or(f(part, (int)threadIdx.x));
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

// block (member, slab) = (blockIdx.x / slabs, blockIdx.x % slabs)
template <int NB, int C, bool T>
__global__ void __launch_bounds__(kThreads)
    tri_solve_kernel(const float* __restrict__ l,
                     const float* __restrict__ b, float* __restrict__ x,
                     int p, int q, int slabs) {
  __shared__ __align__(16) chol_tile::SolveBuffers<NB, C> buf;
  const int member = blockIdx.x / slabs;
  BlockTeam<chol_tile::SolvePart<NB, C>> team;
  chol_tile::solve<NB, C, T>(team, buf, l + (size_t)member * p * p,
                             b + (size_t)member * p * q,
                             x + (size_t)member * p * q, p, q,
                             blockIdx.x - member * slabs);
}

// lanes a member of the pullback, entries a lane, rows between a lane's
// entries
template <int G>
struct Lanes {
  static constexpr int kLanes = G * G < kWarp ? G * G : kWarp;
  static constexpr int kE = G * G / kLanes;
  static constexpr int kStride = kLanes / G;
};

// Lane g of a member's group holds entries (i0 + 4 e, k), i0 = g / G, k =
// g % G, e < kE, of Lbar', W, X, raw and Abar in turn; entry (t, k) lives
// in lane (t % 4) G + k, slot t / 4.
template <int G>
__global__ void __launch_bounds__(subwarp::kThreads)
    chol_pullback_lanes(const float* __restrict__ l,
                        const float* __restrict__ lbar,
                        const float* __restrict__ ldbar,
                        const float* __restrict__ f, float* __restrict__ abar,
                        float* __restrict__ jbar, int batch, int p) {
  using Ln = Lanes<G>;
  constexpr int kL = Ln::kLanes, kE = Ln::kE, kS = Ln::kStride;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int member = gid / kL, g = gid % kL;
  const int i0 = g / G, k = g % G;
  const bool live = member < batch;
  const size_t off = (size_t)member * p * p;

  // L[t][c] for this lane's columns c = k and c = i0 + 4 e: the lower
  // triangle, the identity past p (and for members past the batch)
  auto lower = [&](int t, int c) {
    if (!live || t >= p || c >= p) return t == c ? 1.f : 0.f;
    return t >= c ? l[off + t * p + c] : 0.f;
  };
  float lk[G], li[kE][G], w[kE];
#pragma unroll
  for (int t = 0; t < G; ++t) lk[t] = lower(t, k);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = i0 + kS * e;
#pragma unroll
    for (int t = 0; t < G; ++t) li[e][t] = lower(t, i);
    w[e] = (live && i < p && k < p) ? lbar[off + i * p + k] : 0.f;
    if (ldbar != nullptr && live && i == k && i < p)
      w[e] += ldbar[member] / subwarp::pick<G>(li[e], i);
  }

  // W = phi(L^T Lbar'): M[i][k] = sum_{t >= i} L[t][i] Lbar'[t][k], t
  // ascending; k <= i only
  float m[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) m[e] = 0.f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (t >= p) break;
    const float v = __shfl_sync(kFull, w[t / kS], (t % kS) * G + k, kL);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = i0 + kS * e;
      if (t >= i && k <= i) m[e] = fmaf(li[e][t], v, m[e]);
    }
  }
  float d[kE], r[kE];  // L[i][i] and its reciprocal, row i of each entry
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = i0 + kS * e;
    w[e] = k < i ? m[e] : (k == i ? m[e] - 0.5f * m[e] : 0.f);
    d[e] = subwarp::pick<G>(li[e], i);
    r[e] = 1.f / d[e];
  }

  // X = L^-T W: back substitution over the rows, j descending
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int j = G - 1 - s;
    if (j >= p) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (i0 + kS * e == j) w[e] = chol_tile::quotient(w[e], d[e], r[e]);
    const float xj = __shfl_sync(kFull, w[j / kS], (j % kS) * G + k, kL);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (i0 + kS * e < j) w[e] = fmaf(-li[e][j], xj, w[e]);
  }

  // raw = X L^-1: each row of X back-substituted against L^T, column t
  // descending; L[t][k] from this lane's column k
  const float dk = subwarp::pick<G>(lk, k), rk = 1.f / dk;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int t = G - 1 - s;
    if (t >= p) continue;
    if (k == t) {
#pragma unroll
      for (int e = 0; e < kE; ++e) w[e] = chol_tile::quotient(w[e], dk, rk);
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float rt = __shfl_sync(kFull, w[e], i0 * G + t, kL);
      if (k < t) w[e] = fmaf(-lk[t], rt, w[e]);
    }
  }

  // Abar = (raw + raw^T) / 2: raw[k][i] from lane (k % 4) G + i, slot k / 4
  float a[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int src = (k % kS) * G + i0 + kS * e;
    float rt = 0.f;
#pragma unroll
    for (int u = 0; u < kE; ++u) {
      const float v = __shfl_sync(kFull, w[u], src, kL);
      if (k / kS == u) rt = v;
    }
    a[e] = 0.5f * (w[e] + rt);
  }
  float tr = 0.f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (t >= p) break;
    tr += __shfl_sync(kFull, a[t / kS], (t % kS) * G + t, kL);
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = i0 + kS * e;
    if (i < p && k < p) abar[off + i * p + k] = a[e];
  }
  if (g == 0 && jbar != nullptr) jbar[member] = f[member] * tr;
}

// one block a member at 9 <= P <= 64: chol_tile.cuh's pullback mode
template <int NB>
__global__ void __launch_bounds__(kThreads)
    chol_pullback_tile(const float* __restrict__ l,
                       const float* __restrict__ lbar,
                       const float* __restrict__ ldbar,
                       const float* __restrict__ f, float* __restrict__ abar,
                       float* __restrict__ jbar, int p) {
  __shared__ __align__(16) chol_tile::PullbackBuffers<NB> buf;
  const int member = blockIdx.x;
  const size_t off = (size_t)member * p * p;
  BlockTeam<chol_tile::PullbackPart<NB>> team;
  chol_tile::pullback<NB>(team, buf, l + off, lbar + off,
                          ldbar != nullptr ? ldbar + member : nullptr,
                          abar + off,
                          jbar != nullptr ? jbar + member : nullptr,
                          f != nullptr ? f[member] : 0.f, p);
}

template <int G>
void launch_pullback(const float* l, const float* lbar, const float* ldbar,
                     const float* f, float* abar, float* jbar, int batch,
                     int p, cudaStream_t s) {
  const int per_block = subwarp::kThreads / Lanes<G>::kLanes;
  chol_pullback_lanes<G>
      <<<(batch + per_block - 1) / per_block, subwarp::kThreads, 0, s>>>(
          l, lbar, ldbar, f, abar, jbar, batch, p);
}

}  // namespace

// Launches on `stream`; allocates nothing. `tier` is the width tier the
// host chose for p (16, 32, 48 or 64, at least p), `cols` the slab width
// it chose for q (1, 2, 4 or 8); one block a member and slab of `cols`
// columns. Returns cudaGetLastError(), or cudaErrorInvalidValue for a tier
// or slab width it does not have.
extern "C" int pymra_tri_solve(const void* l, const void* b, void* x,
                               int batch, int p, int q, int transpose,
                               int tier, int cols, int device,
                               void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier || q < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int slabs = (q + cols - 1) / cols;
  const bool found = chol_tile::solve_dispatch(
      nb, cols, transpose, [&](auto nbv, auto cv, auto tv) {
        tri_solve_kernel<decltype(nbv)::value, decltype(cv)::value,
                         decltype(tv)::value != 0>
            <<<batch * slabs, kThreads, 0, (cudaStream_t)stream>>>(
                (const float*)l, (const float*)b, (float*)x, p, q, slabs);
      });
  if (!found) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The fused Cholesky pullback for P <= 64. `tier` is the route the host
// chose for p: 0 the lane kernel (p <= subwarp::kMaxP), or the core's width
// tier (16, 32, 48 or 64, at least p) for the pullback mode, one block a
// member. `ldbar` may be null (no log-determinant cotangent); with `f` null
// no jbar is written. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a route that cannot take p.
extern "C" int pymra_chol_pullback(const void* l, const void* lbar,
                                   const void* ldbar, const void* f,
                                   void* abar, void* jbar, int batch, int p,
                                   int tier, int device, void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (p < 1 || (tier == 0 ? p > subwarp::kMaxP : (nb == 0 || p > tier)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = subwarp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* lv = (const float*)l;
  const float* lb = (const float*)lbar;
  const float* ld = (const float*)ldbar;
  const float* fv = (const float*)f;
  float* av = (float*)abar;
  float* jv = f != nullptr ? (float*)jbar : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (tier == 0) {
    if (subwarp::group_size(p) == 4)
      launch_pullback<4>(lv, lb, ld, fv, av, jv, batch, p, s);
    else
      launch_pullback<8>(lv, lb, ld, fv, av, jv, batch, p, s);
    return (int)cudaGetLastError();
  }
  auto launch = [&](auto kernel) {
    kernel<<<batch, kThreads, 0, s>>>(lv, lb, ld, fv, av, jv, p);
  };
  switch (nb) {
    case 2: launch(chol_pullback_tile<2>); break;
    case 4: launch(chol_pullback_tile<4>); break;
    case 6: launch(chol_pullback_tile<6>); break;
    default: launch(chol_pullback_tile<8>); break;
  }
  return (int)cudaGetLastError();
}
