// K1's backward, the pullback of the fused leaf stage, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's custom VJP of leaf_factor,
// pymra_tpu/ops/pallas/linalg.py::_leaf_factor_bwd, is matmuls and
// elementwise arithmetic that XLA fuses. Its plain twin here is
// `leaf_pullback_ref` (ops/linalg.py: _leaf_posterior_pullback and
// _leaf_prior_pullback), which on the card ran as ~40 launches of float64
// and float32 GEMMs, elementwise kernels, K4 and K3 a call. For every leaf
// of a batch of P x P blocks (P <= 64), with X = Li the forward's inverse
// factor (lower), Xbar its cotangent, q and p the cotangents of the
// posterior and prior log-determinants, k the knot mask and
//
//   K_leaf = C ⊙ k k^T + diag(1 - k),   s = mean_j |K_leaf[j, j]| + 1,
//   Y = chol(K_leaf + fp * jitter * s * I)^-1,
//
// it writes
//
//   Kbar_q = sym(X^T [1/2 q I + phi(-Xbar X^T)] X)   (float64, rounded once)
//   Abar   = Kbar_q ⊙ k k^T
//   Cbar   = (Kbar_q + 1/2 p Y^T Y) ⊙ k k^T
//
// with sym(M) = (M + M^T) / 2 and phi the lower triangle with its diagonal
// halved. That is the twin's 1/2 q X^T X + 1/2 (raw + raw^T), raw = X^T
// phi(-Xbar X^T) X, with the two terms merged into three products; as in
// the twin every product and the sum are taken in float64 and rounded to
// float32 once (X carries 1/sqrt(lambda_min) of the posterior block; see
// _leaf_posterior_pullback), and Y^T Y in float32, as the twin's matmul
// takes it.
//
// What bounds it on the card: at grid1m's 65,536 leaves of 64 (four
// parameter sets) it must read C, k, X and Xbar and write Cbar and Abar,
// ~5.4 GB (1.6 ms at 3.35 TB/s), for ~175 KFLOP of float64 a member in the
// triangular products (11.5 GFLOP a call). No member's data leaves the SM
// between the first read and the last write: the products' operands sit in
// shared memory and their sums in registers.
//
// Design: one 64-thread block a member on the register-tiled core's 8 x 8
// grid (chol_tile.cuh: thread (r, c) holds entries (r + 8a, c + 8b), b <=
// a, of a lower triangle), at the width tier the host passes. The products
// exploit the triangles: only Xbar's lower triangle enters, and every
// factor but the last is lower triangular, so each is a sum of outer
// products over one index whose range is a triangle:
//
//   G[i][k] = sum_{j <= k} Xbar[i][j] X[k][j]         (k <= i)
//   U = -G, its diagonal halved, plus 1/2 q I          (lower)
//   V[i][k] = sum_{k <= j <= i} U[i][j] X[j][k]        (k <= i)
//   S[a][k] = 1/2 sum_{i >= a} X[i][a] V[i][k] + V[i][a] X[i][k]  (k <= a)
//
// about P^3 / 6 multiply-adds each (2 P^3 / 6 for S), an eighth of the
// twin's four full products. A step reads a thread's NB row and NB column
// operands from shared memory for up to NB (NB + 1) / 2 multiply-adds; the
// step index's block is a template constant (as chol_tile.cuh's pullback
// mode does), so the tiles a block of steps cannot reach are left out at
// compile time, and the products need no barrier inside. The operands sit
// in shared memory as packed lower triangles: X in float32 from the first
// product to the last; Xbar, U and V in float64, then Y and the staged
// outputs (float32 squares), taking turns in the same bytes: 26 KB a block
// at the 64-wide tier, so that 8 blocks share an SM (on an NVIDIA H100
// 80GB HBM3 at 700 W, 8.15 ms at 65,536 x 64 on clean leaves, against
// 9.19 with X in float64, 34 KB and 6 blocks, and 12.2 with float64
// squares, 51 KB and 4: the products and the prior's factor are
// latency-bound). The prior block is
// assembled in registers from C and k as K1's forward assembles it (its
// jitter scale summed in the forward's order) and factored and inverted by
// the core's inverse mode, which replaces K4 and K3: nothing is saved for
// the backward beyond what K1's forward already saves. The outputs are
// symmetric: each thread writes its lower entries and their mirror images
// into shared memory, and the block stores whole rows, one output after
// the other.
//
// A member with a non-finite entry in X, Xbar or q takes the twin's
// products over whole squares instead (dense_kbar below, X's zeros above
// the diagonal included, read from device memory; phi X goes through the
// member's own outputs as scratch), so that its inf and NaN land where the
// twin's do: an all-fail member (its X NaN from the failing column on)
// comes out NaN whole. Built without fast-math.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::kGrid;
using chol_tile::kThreads;
using chol_tile::lower;
using chol_tile::Mode;
using chol_tile::Place;

// one member's shared memory
template <int NB>
struct Smem {
  static constexpr int kW = kGrid * NB;  // the tier's width
  static constexpr int kLd = kW + 1;     // row stride of the squares
  static constexpr int kTri = kW * (kW + 1) / 2;
  union {
    double d[kTri];     // Xbar, U, then V: lower triangles (tri)
    float f[kW * kLd];  // Y; one output at a time
  } work;
  float x[kTri];        // X's lower triangle, the padding zero
  float col[2 * kW], xrow[2 * kW];  // the core's step buffers
  float km[kW], dg[kW];  // the knot mask, |K_leaf[j][j]|
};

// entry (i, k), k <= i, of a packed lower triangle
__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

// G[i][k] = sum_{j <= k} Xbar[i][j] X[k][j] for the tile map's lower
// entries: steps j of block JB reach the columns k >= j, tiles b >= JB.
template <int NB, int JB>
__device__ __forceinline__ void gram(double (&acc)[NB][NB], const double* xb,
                                     const float* x, int p, Place t) {
#pragma unroll 1
  for (int jc = 0; jc < kGrid; ++jc) {
    const int j = kGrid * JB + jc;
    if (j >= p) return;
    double u[NB], v[NB];  // Xbar[r + 8a][j], X[c + 8b][j]
#pragma unroll
    for (int a = JB; a < NB; ++a) {
      u[a] = xb[tri(t.r + kGrid * a, j)];
      v[a] = x[tri(t.c + kGrid * a, j)];
    }
    const bool cin = t.c >= jc, low = t.c <= t.r;
#pragma unroll
    for (int a = JB; a < NB; ++a) {
#pragma unroll
      for (int b = JB; b <= a; ++b)
        if ((b > JB || cin) && (b < a || low))
          acc[a][b] = fma(u[a], v[b], acc[a][b]);
    }
  }
  if constexpr (JB + 1 < NB) gram<NB, JB + 1>(acc, xb, x, p, t);
}

// V[i][k] = sum_{k <= j <= i} U[i][j] X[j][k]: steps j of block JB reach
// rows i >= j and columns k <= j, tiles b <= JB <= a.
template <int NB, int JB>
__device__ __forceinline__ void times_x(double (&acc)[NB][NB],
                                        const double* u, const float* x,
                                        int p, Place t) {
#pragma unroll 1
  for (int jc = 0; jc < kGrid; ++jc) {
    const int j = kGrid * JB + jc;
    if (j >= p) return;
    double uc[NB], xr[NB];  // U[r + 8a][j], X[j][c + 8b]
#pragma unroll
    for (int a = JB; a < NB; ++a) uc[a] = u[tri(t.r + kGrid * a, j)];
#pragma unroll
    for (int b = 0; b <= JB; ++b) xr[b] = x[tri(j, t.c + kGrid * b)];
    const bool rin = t.r >= jc, cin = t.c <= jc, low = t.c <= t.r;
#pragma unroll
    for (int a = JB; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b <= JB; ++b)
        if ((a > JB || rin) && (b < JB || cin) && (b < a || low))
          acc[a][b] = fma(uc[a], xr[b], acc[a][b]);
    }
  }
  if constexpr (JB + 1 < NB) times_x<NB, JB + 1>(acc, u, x, p, t);
}

// 2 S[a][k] = sum_{i >= a} X[i][a] V[i][k] + V[i][a] X[i][k] (k <= a):
// steps i of block IB reach the rows a <= i, tiles b <= a <= IB. (A
// thread loads X[i][col] and V[i][col] for col > i too, past row i of the
// packed triangles, and leaves them unused, as the other products do.)
template <int NB, int IB>
__device__ __forceinline__ void sym_product(double (&acc)[NB][NB],
                                            const double* v,
                                            const float* x, int p, Place t) {
#pragma unroll 1
  for (int ic = 0; ic < kGrid; ++ic) {
    const int i = kGrid * IB + ic;
    if (i >= p) return;
    // X[i][r + 8a], V[i][r + 8a], X[i][c + 8b], V[i][c + 8b]
    double xa[NB], va[NB], xk[NB], vk[NB];
#pragma unroll
    for (int a = 0; a <= IB; ++a) {
      xa[a] = x[tri(i, t.r + kGrid * a)];
      va[a] = v[tri(i, t.r + kGrid * a)];
      xk[a] = x[tri(i, t.c + kGrid * a)];
      vk[a] = v[tri(i, t.c + kGrid * a)];
    }
    const bool rin = t.r <= ic, low = t.c <= t.r;
#pragma unroll
    for (int a = 0; a <= IB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b)
        if ((a < IB || rin) && (b < a || low))
          acc[a][b] = fma(xa[a], vk[b], fma(va[a], xk[b], acc[a][b]));
    }
  }
  if constexpr (IB + 1 < NB) sym_product<NB, IB + 1>(acc, v, x, p, t);
}

// (Y^T Y)[i][k] = sum_{m >= i} Y[m][i] Y[m][k] (k <= i), float32 as the
// twin's matmul: steps m of block MB reach the rows i <= m, tiles b <= a
// <= MB.
template <int NB, int MB>
__device__ __forceinline__ void gram_t(float (&acc)[NB][NB], const float* y,
                                       int p, Place t) {
  constexpr int kLd = Smem<NB>::kLd;
#pragma unroll 1
  for (int mc = 0; mc < kGrid; ++mc) {
    const int m = kGrid * MB + mc;
    if (m >= p) return;
    float ya[NB], yk[NB];  // Y[m][r + 8a], Y[m][c + 8b]
#pragma unroll
    for (int a = 0; a <= MB; ++a) {
      ya[a] = y[m * kLd + t.r + kGrid * a];
      yk[a] = y[m * kLd + t.c + kGrid * a];
    }
    const bool rin = t.r <= mc, low = t.c <= t.r;
#pragma unroll
    for (int a = 0; a <= MB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b)
        if ((a < MB || rin) && (b < a || low))
          acc[a][b] = fmaf(ya[a], yk[b], acc[a][b]);
    }
  }
  if constexpr (MB + 1 < NB) gram_t<NB, MB + 1>(acc, y, p, t);
}

// The tile map's lower tiles into a square of shared memory, rows kLd
// apart, the upper half of the diagonal tiles zero.
template <int NB, class T, class S>
__device__ __forceinline__ void put_lower(T* dst, const S (&v)[NB][NB],
                                          Place t) {
  constexpr int kLd = Smem<NB>::kLd;
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b)
      dst[(t.r + kGrid * a) * kLd + t.c + kGrid * b] =
          lower(a, b, t) ? (T)v[a][b] : (T)0;
  }
}

// The tile map's lower entries into a packed lower triangle.
template <int NB>
__device__ __forceinline__ void put_tri(double* dst,
                                        const double (&v)[NB][NB],
                                        Place t) {
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b)
      if (lower(a, b, t)) dst[tri(t.r + kGrid * a, t.c + kGrid * b)] = v[a][b];
  }
}

template <int NB, class T>
__device__ __forceinline__ void zero_lower(T (&v)[NB][NB]) {
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) v[a][b] = 0;
  }
}

// Kbar_q on the tile map's lower entries from the triangular products.
template <int NB>
__device__ __forceinline__ void triangular_kbar(Smem<NB>& sm, bool hl,
                                                float q, int p, Place t,
                                                float (&kq)[NB][NB]) {
  double acc[NB][NB];
  zero_lower(acc);
  if (hl) gram<NB, 0>(acc, sm.work.d, sm.x, p, t);
  __syncthreads();  // every thread is done with Xbar
  const double hq = 0.5 * (double)q;
#pragma unroll
  for (int a = 0; a < NB; ++a) {
    acc[a][a] = -acc[a][a];
    if (t.r == t.c) acc[a][a] = 0.5 * acc[a][a] + hq;
#pragma unroll
    for (int b = 0; b < a; ++b) acc[a][b] = -acc[a][b];
  }
  put_tri<NB>(sm.work.d, acc, t);
  __syncthreads();
  zero_lower(acc);
  times_x<NB, 0>(acc, sm.work.d, sm.x, p, t);
  __syncthreads();  // every thread is done with U
  put_tri<NB>(sm.work.d, acc, t);
  __syncthreads();
  zero_lower(acc);
  sym_product<NB, 0>(acc, sm.work.d, sm.x, p, t);
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) kq[a][b] = (float)(0.5 * acc[a][b]);
  }
}

// p^2 float64 entries in the member's two outputs (2 p^2 floats), two
// 32-bit words an entry, so that the outputs' alignment does not matter
struct Scratch {
  unsigned* a;
  unsigned* c;
  int n;  // p^2: words in each output
  __device__ __forceinline__ unsigned& word(int w) const {
    return w < n ? a[w] : c[w - n];
  }
  __device__ __forceinline__ void put(int e, double v) const {
    const unsigned long long bits = (unsigned long long)__double_as_longlong(v);
    word(2 * e) = (unsigned)bits;
    word(2 * e + 1) = (unsigned)(bits >> 32);
  }
  __device__ __forceinline__ double get(int e) const {
    return __longlong_as_double((long long)(
        (unsigned long long)word(2 * e) |
        ((unsigned long long)word(2 * e + 1) << 32)));
  }
};

// Kbar_q of a member with a non-finite X, Xbar or q: the twin's products
// over whole squares in its association, phi(-(Xbar X^T)), Z = phi X, raw =
// X^T Z, 1/2 q (X^T X) + 1/2 (raw + raw^T), each sum in float64 over every
// index (X's zeros above the diagonal and phi's times an inf or NaN
// included; X and Xbar as given, whole squares in device memory); Z goes
// through the member's outputs, which the block writes only after every
// thread has read it. Slow (about 4 P^3 / 64 dependent multiply-adds a
// thread) and rare.
template <int NB>
__device__ __forceinline__ void dense_kbar(Smem<NB>& sm, const float* x,
                                           const float* xbar, bool hl,
                                           bool hq, float q, Scratch z, int p,
                                           Place t, float (&kq)[NB][NB]) {
  double* w = sm.work.d;
  if (hl) {
    __syncthreads();  // every thread is done with the copy of Xbar
    for (int e = threadIdx.x; e < p * p; e += kThreads) {
      const int i = e / p, k = e % p;
      if (k > i) continue;
      double g = 0.0;
      for (int j = 0; j < p; ++j)
        g = fma((double)xbar[i * p + j], (double)x[k * p + j], g);
      const double s = -g;
      w[tri(i, k)] = i == k ? s - 0.5 * s : s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < p * p; e += kThreads) {
      const int i = e / p, m = e % p;
      double s = 0.0;
      for (int j = 0; j < p; ++j)
        s = fma(j <= i ? w[tri(i, j)] : 0.0, (double)x[j * p + m], s);
      z.put(e, s);
    }
    __syncthreads();
  }
  const double hqd = 0.5 * (double)q;
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = t.r + kGrid * a, k = t.c + kGrid * b;
      double kb = 0.0;
      if (lower(a, b, t) && i < p && k < p) {
        if (hq) {
          double g = 0.0;
          for (int j = 0; j < p; ++j)
            g = fma((double)x[j * p + i], (double)x[j * p + k], g);
          kb = hqd * g;
        }
        if (hl) {
          double rik = 0.0, rki = 0.0;
          for (int j = 0; j < p; ++j) {
            rik = fma((double)x[j * p + i], z.get(j * p + k), rik);
            rki = fma((double)x[j * p + k], z.get(j * p + i), rki);
          }
          kb = kb + 0.5 * (rik + rki);
        }
      }
      kq[a][b] = (float)kb;
    }
  }
}

// One member: c, li, libar, cbar and abar [p, p], kmask [p]; ldpbar,
// ldqbar and fp the member's scalars (ldpbar, ldqbar: null where that
// cotangent is absent, libar too; fp is read only with ldpbar).
template <int NB>
__device__ __forceinline__ void member(Smem<NB>& sm, const float* c,
                                       const float* kmask, const float* li,
                                       const float* libar,
                                       const float* ldpbar,
                                       const float* ldqbar, const float* fp,
                                       float jitter, float* cbar, float* abar,
                                       int p) {
  constexpr int kW = Smem<NB>::kW, kLd = Smem<NB>::kLd;
  const int tid = threadIdx.x;
  const Place t = chol_tile::place();
  const bool hl = libar != nullptr, hq = ldqbar != nullptr;
  const float q = hq ? *ldqbar : 0.f;

  // the lower triangles of X and Xbar into shared memory, the padding
  // zero; every entry of both (above the diagonal too) checked; the knot
  // mask
  bool odd = !isfinite(q);
  for (int e = tid; e < kW * kW; e += kThreads) {
    const int i = e / kW, k = e % kW;
    float v = 0.f, w = 0.f;
    if (i < p && k < p) {
      v = li[i * p + k];
      if (hl) w = libar[i * p + k];
      odd |= !isfinite(v) || !isfinite(w);
    }
    if (k <= i) {
      sm.x[tri(i, k)] = v;
      sm.work.d[tri(i, k)] = w;
    }
  }
  if (tid < p) sm.km[tid] = kmask[tid];
  odd = __syncthreads_or(odd);

  float kq[NB][NB];  // Kbar_q, float32
  if (!hl && !hq)
    zero_lower(kq);
  else if (!odd)
    triangular_kbar<NB>(sm, hl, q, p, t, kq);
  else
    dense_kbar<NB>(sm, li, libar, hl, hq, q,
                   {reinterpret_cast<unsigned*>(abar),
                    reinterpret_cast<unsigned*>(cbar), p * p},
                   p, t, kq);

  // the prior's 1/2 p Y^T Y at the selected factor, Y from the core's
  // inverse mode on K_leaf + fp jit I assembled as K1's forward does
  float pr[NB][NB];
  const bool hp = ldpbar != nullptr;
  if (hp) {
    if (tid < p) sm.dg[tid] = fabsf(c[tid * p + tid] * sm.km[tid] +
                                    (1.f - sm.km[tid]));
    __syncthreads();
    float sum = 0.f;
    for (int j = 0; j < p; ++j) sum += sm.dg[j];
    const float add = jitter * (sum / (float)p + 1.f) * *fp;
    float s[NB][NB], y[NB][NB];
    chol_tile::assemble<NB>(s, p, t, [&](int i, int k) {
      float v = c[i * p + k] * (sm.km[i] * sm.km[k]);
      if (i == k) v = (v + (1.f - sm.km[i])) + add;
      return v;
    });
    chol_tile::factor<NB, Mode::kInverse>(s, y, sm.col, sm.xrow, p, t);
    put_lower<NB>(sm.work.f, y, t);  // past the factor's first barrier
    __syncthreads();
    zero_lower(pr);
    gram_t<NB, 0>(pr, sm.work.f, p, t);
    const float hpv = 0.5f * *ldpbar;
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) pr[a][b] = hpv * pr[a][b];
    }
  }

  // the outputs, masked to the knot pairs, both triangles, through shared
  // memory, then whole rows: Abar, then Cbar
  float* o = sm.work.f;
  for (int out = 0; out < 2; ++out) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int i = t.r + kGrid * a, k = t.c + kGrid * b;
        if (!lower(a, b, t) || i >= p || k >= p) continue;
        const float v = out == 0 || !hp ? kq[a][b] : kq[a][b] + pr[a][b];
        o[i * kLd + k] = o[k * kLd + i] = v * (sm.km[i] * sm.km[k]);
      }
    }
    __syncthreads();
    float* dst = out == 0 ? abar : cbar;
    for (int e = tid; e < p * p; e += kThreads) dst[e] = o[e / p * kLd + e % p];
  }
}

#if defined(__CUDACC__)
// The step loops are latency-bound and want the warps: 8 blocks an SM (26
// KB of shared memory a block at the 64-wide tier), up to 128 registers a
// thread (126 at that tier, no spills).
template <int NB>
__global__ void __launch_bounds__(kThreads, 8)
    leaf_pullback_kernel(const float* __restrict__ c,
                         const float* __restrict__ kmask,
                         const float* __restrict__ li, const float* libar,
                         const float* ldpbar, const float* ldqbar,
                         const float* fp, float jitter,
                         float* __restrict__ cbar, float* __restrict__ abar,
                         int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(smem_raw);
  const size_t m = blockIdx.x, off = m * p * p;
  member<NB>(sm, c + off, kmask + m * p, li + off,
             libar ? libar + off : nullptr, ldpbar ? ldpbar + m : nullptr,
             ldqbar ? ldqbar + m : nullptr, fp ? fp + m : nullptr, jitter,
             cbar + off, abar + off, p);
}
#endif

}  // namespace

#if defined(__CUDACC__)
// Launches on `stream`, one block a member; allocates nothing. libar,
// ldpbar and ldqbar may be null (that cotangent is absent), fp too where
// ldpbar is. `tier` is the width tier the host chose for p (16, 32, 48 or
// 64, at least p). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a tier it does not have.
extern "C" int pymra_leaf_pullback(const void* c, const void* kmask,
                                   const void* li, const void* libar,
                                   const void* ldpbar, const void* ldqbar,
                                   const void* fp, float jitter, void* cbar,
                                   void* abar, int batch, int p, int tier,
                                   int device, void* stream) {
  const int nb = chol_tile::tier_nb(tier);
  if (nb == 0 || p < 1 || p > tier || (ldpbar != nullptr && fp == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto kernel, int shmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<batch, kThreads, shmem, (cudaStream_t)stream>>>(
        (const float*)c, (const float*)kmask, (const float*)li,
        (const float*)libar, (const float*)ldpbar, (const float*)ldqbar,
        (const float*)fp, jitter, (float*)cbar, (float*)abar, p);
    return (int)cudaGetLastError();
  };
  switch (nb) {
    case 2: return launch(leaf_pullback_kernel<2>, (int)sizeof(Smem<2>));
    case 4: return launch(leaf_pullback_kernel<4>, (int)sizeof(Smem<4>));
    case 6: return launch(leaf_pullback_kernel<6>, (int)sizeof(Smem<6>));
    default: return launch(leaf_pullback_kernel<8>, (int)sizeof(Smem<8>));
  }
}
#endif
