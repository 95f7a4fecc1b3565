// Register-tiled factorization core of width <= 64 for Hopper (sm_90a),
// shared by K1 leaf_factor.cu, K4 cholesky.cu, K2 cholesky_jittered.cu
// (9 <= P <= 64), K6 chol_logdet.cu, K7 chol_inv_logdet.cu, K3 tri_inv.cu
// and tri_inv_wide.cu, K5 tri_solve.cu and, in tri_solve.cu too, KP the
// Cholesky pullback at 9 <= P <= 64 (the pullback mode at the end).
//
// Replaces the column loops of the TPU kernels _chol_kernel (K4),
// _chol_jittered_kernel (K2), _kleaf_logdet_kernel /
// _kleaf_inv_logdet_kernel (K1), _chol_logdet_kernel (K6),
// _chol_inv_logdet_kernel (K7), _tri_inv_kernel (K3) and _tri_solve_kernel
// (K5, the solve mode at the end of this header) in
// pymra_tpu/ops/pallas/linalg.py: a right-looking Cholesky of one member,
// in three modes: the half log-pivot sum alone (K1's prior, K6), the
// factor (K4; K2 takes it with the pivots' roots handed out for one log
// sum after the factorization), and the factor's inverse formed alongside
// it (K1's posterior, K7); and a fourth that inverts a given lower factor
// (K3): L stays as it is in the tile map, column j of L and row j of X are
// broadcast a step, row j of X is scaled by its owners with the quotient
// by L[j][j] and the rows below take their multiply-subtracts on
// registers — the twins' forward substitution (_forward_subst), the
// subtractions in ascending j, then the division.
//
// What bounds it on this card: not HBM (a 64 x 64 member reads ~8 KB and
// does ~87 KFLOP), but the serial column loop. The first kernels (one
// 256-thread block a member, the matrix in shared memory, warp w sweeping
// rows j+1+w, j+1+w+8, ... a step) took 6.2 ms for K1 and 1.5 ms for K4 at
// 16384 x 64 against bounds of 0.16 and 0.12 ms: every multiply-subtract
// loaded two shared operands and stored one, short rows left most lanes
// idle, and each of K1's 192 steps ended at a block barrier that waited
// for the warp with the longest rows (PERF.md).
//
// The tiling: a member is owned by kThreads = 64 threads in an 8 x 8 grid,
// thread (r, c) holding entry (r + 8a, c + 8b) of the working matrix S
// (and of the inverse X) in registers, for a, b < NB = tier / 8 and only
// b <= a: the tile map is the lower triangle. The distribution is cyclic,
// so the shrinking trailing triangle stays spread over all 64 threads to
// the last steps. Column j of S (and row j of X) is broadcast once per step
// through a small shared buffer that its owners write after their own
// update: each thread reads its NB row and NB column values of that step
// and does up to NB (NB + 1) / 2 multiply-subtracts of S on registers (and
// in K1's posterior as many of X for NB more loads): one shared load now
// serves up to (NB + 1) / 4 of them, where it served one third. The
// buffer is double-buffered by the parity of j, so a step is one barrier,
// at its start. The reciprocal of the pivot (or of its root) is taken once
// per step by every thread, and each row's quotient is formed from it with
// two FMAs (see quotient below): no division per row. In the buffers
// entry g + 8m of a column sits at g * NB + m, so a thread's rows and its
// columns are each NB contiguous floats, read by every thread of its grid
// row or column at once (broadcasts).
//
// The step loop is unrolled over the column block b = j / 8 (NB copies) and
// runs the column jc = j % 8 within it: every register index is static,
// and the active part of the tile map for block b (rows a >= b, columns
// b..a of S; rows a >= b, columns <= b of X) is static too; only the
// entries of block b's own row and column take a predicate on jc.
//
// Widths: NB is a compile-time tier (2, 4, 6 or 8: P <= 16, 32, 48, 64),
// chosen by the host wrapper from P. Rows and columns P..8 NB - 1 are
// padding: they are set to the identity (no jitter) and no step j >= P
// runs, so no pivot of theirs ever reaches a log-determinant, and a real
// entry never reads a padded row or column (an update of entry (i, k)
// reads rows i and k of column j only). Their values are never stored.
//
// Exactness: every thread reads the same pivots from the buffer and sums
// their logs in the same order, so the log-pivot sum — the escalation test
// of K1 — is uniform over the block without a reduction, and a member's
// result depends on its own inputs only. The arithmetic is the twins'
// but for FMA contraction in the downdates: no fast-math, IEEE sqrtf and
// logf, and column j scaled by the correctly rounded quotient S[i][j] /
// pivot (S[i][j] / d in the pivot-only mode), bit for bit what the twins'
// division gives but at the edges of the float range (see quotient
// below); an exactly zero pivot gives -inf, a negative one NaN, and a
// zero or NaN pivot spreads inf and NaN (x / 0) through its column and
// the trailing block as the twins' division does (K3's mode leaves a
// member with such a diagonal, or a non-finite entry, to substitute(),
// which runs the twins' whole rows). The product x * (1 /
// pivot) in its place, one rounding off the twins, moved the N=10^4
// objective from 1.31e-4 to 2.91e-4 off its golden, K4 against its twin
// from 1.4e-5 to 3.8e-5 and K6's backward from 2.4e-4 to 7.3e-4; IEEE
// division costs 1.8-3.0 times the quotient's time
// (tools/tile_variants.py --scales builds both variants).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_timing.py,
// 16384 x 64): K4 0.363 ms a call, 0.349 ms on the device, 35% of its
// bound; K1 1.196 / 1.185 ms, 14% (PERF.md; with the product 0.267 and
// 0.97 ms). Both scale as ~P^1.2-1.5 and stay latency-bound on the step
// chain (tools/kernel_scaling.py); K1 runs at at most 85 registers a
// thread for the occupancy (tools/tile_variants.py).
#pragma once

#include <cuda_runtime.h>

namespace chol_tile {

// x / den, correctly rounded, from r = 1 / den (itself correctly rounded):
// q = x r is within an ulp of x / den, the residual x - q den is exact in
// an FMA, and q + (x - q den) r rounds to x / den (Markstein's theorem,
// round to nearest). The theorem holds where nothing overflows or
// underflows on the way: for 2^-126 <= |den| <= 2^126, |x| >= 2^-100 and
// 2^-126 <= |x / den| <= 2^126 this is x / den bit for bit, as it is for
// an infinite or NaN x and a zero, infinite or NaN den (the residual is
// then NaN, and q already is x / den's inf, 0 or NaN); a zero x over such
// a den gives zero, +0 for -0 too. Outside that range it may be an ulp
// off (a tiny x or quotient, a huge den or quotient), and for a |den|
// below 2^-128, whose reciprocal overflows, it gives inf or NaN (0 inf)
// where x / den is finite (held to division by
// tests/test_torch_leaf_tiles.py, from this header built on the host).
// Only the pivot-only mode divides by the pivot itself, and a positive
// pivot that small leaves the twins' next pivots hugely negative unless
// its column is zero. Checking the range at every entry, with division
// where it fails, made K1 and K4 1.25-1.84 times slower on the H100
// (PERF.md), so the core does without. K3's mode divides by a diagonal
// the caller gave: its kernels check every diagonal entry once, with
// regular() below, and send a member with one outside [2^-126, 2^126] to
// substitute(), which divides; so K3 departs from the twins' division
// only by an ulp, where |x| < 2^-100 or the quotient lies outside
// [2^-126, 2^126].
__device__ __forceinline__ float quotient(float x, float den, float r) {
  const float q = x * r;
  const float q1 = fmaf(fmaf(-q, den, x), r, q);
  return isfinite(q1) ? q1 : q;
}

constexpr int kGrid = 8;                  // thread grid kGrid x kGrid
constexpr int kThreads = kGrid * kGrid;   // threads per member

enum class Mode {
  kLogdet,   // sum_j log d_j of the downdated pivots (the caller halves it)
  kFactor,   // S becomes L (column j: S'[j:, j] / sqrt(S'[j, j]))
  kInverse,  // X becomes L^-1 (set up by the core); returns sum_j log L_jj
  kTriInv,   // S holds a lower factor L, left as it is; X becomes L^-1
             // (set up by the core); returns 0
  kFactorRoots,  // kFactor without the log-pivot sum: the roots
                 // sqrt(S'[j, j]) go to xrow[j] (p floats of shared
                 // memory), for the caller to sum their logs once after
                 // the factorization; returns 0
};

// a thread's place in the member's grid, from its index among the
// member's kThreads
struct Place {
  int r, c;
};

__device__ __forceinline__ Place place(int tid = threadIdx.x) {
  return {tid / kGrid, tid % kGrid};
}

// The member's barrier: the whole block (one member a block), or named
// barrier `id` of the kThreads threads (two whole warps) that own the
// member, where a block holds several members (tri_inv_wide.cu).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
  }
};

// Whether entry v of a given lower factor lets the inverse mode run: a
// finite entry below the diagonal; on it a divisor in the quotient's exact
// range, 2^-126 <= |v| <= 2^126 (no zero, subnormal, huge, inf or NaN).
// A member with any other entry goes to substitute() instead.
__device__ __forceinline__ bool regular(float v, bool diagonal) {
  const float a = fabsf(v);
  return diagonal ? (a >= 0x1p-126f && a <= 0x1p126f) : isfinite(v);
}

// X = L^-1 over whole rows, the twins' forward substitution of the
// identity in their order: X[i][c] = (delta_ic - sum_{k<i} L[i][k]
// X[k][c]) / L[i][i], the sum in ascending k, every column c (also above
// the diagonal, where a zero, inf or NaN entry of L spreads NaN as the
// twins' whole-row updates do). Thread `c0` of `n` takes columns c0, c0 +
// n, ...; it reads back only its own columns of x, so no barrier. The
// path of the members regular() refuses: slow (p^2 / 2 dependent steps a
// column), and rare.
__device__ __forceinline__ void substitute(const float* l, float* x, int p,
                                           int ld, int c0, int n) {
  for (int c = c0; c < p; c += n)
    for (int i = 0; i < p; ++i) {
      float acc = i == c ? 1.f : 0.f;
      for (int k = 0; k < i; ++k) acc -= l[i * ld + k] * x[k * ld + c];
      x[i * ld + c] = acc / l[i * ld + i];
    }
}

// true where (r + 8a, c + 8b) lies on or below the diagonal (b <= a)
__device__ __forceinline__ bool lower(int a, int b, Place t) {
  return b < a || (b == a && t.c <= t.r);
}

// Fill the tile map: entry(i, k) for real lower entries (i, k < p), the
// identity for padding; upper entries of the diagonal tiles are zeros.
template <int NB, class Entry>
__device__ __forceinline__ void assemble(float (&s)[NB][NB], int p,
                                         Place t, Entry entry) {
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = t.r + kGrid * a, k = t.c + kGrid * b;
      float v = 0.f;
      if (lower(a, b, t)) v = (i < p && k < p) ? entry(i, k) : (i == k);
      s[a][b] = v;
    }
  }
}

// Store the whole [p, p] matrix, rows `ld` floats apart (0: p): the tile
// map's lower entries, zeros above the diagonal.
template <int NB>
__device__ __forceinline__ void store(const float (&s)[NB][NB],
                                      float* __restrict__ out, int p,
                                      Place t, int ld = 0) {
  if (ld == 0) ld = p;
#pragma unroll
  for (int a = 0; a < NB; ++a) {
    const int i = t.r + kGrid * a;
    if (i >= p) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int k = t.c + kGrid * b;
      if (k >= p) continue;
      float v = 0.f;
      if (lower(a, b, t)) v = s[a][b];
      out[i * ld + k] = v;
    }
  }
}

// The owners of column 8 bn + jn of S (and of row 8 bn + jn of X) put it
// into the step's buffers: rows a >= bn of S, columns b <= bn of X. In
// kTriInv the row of X goes in already scaled by its diagonal entry of L
// (`diag`): its 8 owners take the quotients once for the 64 threads.
template <int NB, Mode M>
__device__ __forceinline__ void put(const float (&s)[NB][NB],
                                    const float (&x)[NB][NB], float* col,
                                    float* xrow, const float* diag, int bn,
                                    int jn, Place t) {
  if (t.c == jn) {
#pragma unroll
    for (int a = 0; a < NB; ++a)
      if (a >= bn) col[t.r * NB + a] = s[a][bn];
  }
  if (M == Mode::kInverse && t.r == jn) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b <= bn) xrow[t.c * NB + b] = x[bn][b];
  }
  if (M == Mode::kTriInv && t.r == jn) {
    const float den = diag[kGrid * bn + jn], r = 1.f / den;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b <= bn) xrow[t.c * NB + b] = quotient(x[bn][b], den, r);
  }
}

// Factor the member held in `s` of width p <= 8 NB (kInverse: into `x`,
// which it starts from the identity itself; kTriInv: invert the factor in
// `s` into `x`, with L's diagonal in `diag`, p floats of shared memory the
// caller filled before the call); `col` and `xrow` are 2 * 8 * NB floats
// of shared memory each (xrow unused but for kInverse and kTriInv, and
// kFactorRoots, where it takes the p roots). Every thread returns the same
// log-pivot sum. Barriers by `sync`: the member's
// kThreads threads meet there (by default the caller's whole block).
template <int NB, Mode M, class Sync = BlockSync>
__device__ __forceinline__ float factor(float (&s)[NB][NB],
                                        float (&x)[NB][NB], float* col,
                                        float* xrow, int p, Place t,
                                        Sync sync = Sync(),
                                        const float* diag = nullptr) {
  constexpr int kBuf = kGrid * NB;
  constexpr bool kX = M == Mode::kInverse || M == Mode::kTriInv;
  sync();  // the buffers' last readers (an earlier call) are done
  float acc = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (kX) {
      // X's column block q is the identity until block q's steps: set it
      // one block ahead (row 8q of X is put at the end of block q - 1), so
      // that it takes no register earlier
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (q != b + 1 && !(b == 0 && q == 0)) continue;
#pragma unroll
        for (int a = 0; a < NB; ++a)
          if (a >= q) x[a][q] = (a == q && t.r == t.c) ? 1.f : 0.f;
      }
    }
    if (b == 0) put<NB, M>(s, x, col, xrow, diag, 0, 0, t);
    for (int jc = 0; jc < kGrid; ++jc) {
      const int j = kGrid * b + jc;
      if (j >= p) break;  // uniform
      sync();
      const float* cb = col + (j & 1) * kBuf;
      const float d = cb[jc * NB + b];
      // kLogdet: d; kFactor, kFactorRoots, kInverse: sqrt(d); kTriInv:
      // unused (put scaled row j of X by L[j][j] = d)
      float den = d;
      if (M == Mode::kLogdet) {
        acc += logf(d);
      } else if (M == Mode::kFactorRoots) {
        den = sqrtf(d);
        if (t.r == 0 && t.c == 0) xrow[j] = den;
      } else if (M != Mode::kTriInv) {
        den = sqrtf(d);
        acc += logf(den);
      }
      const float rs = 1.f / den;
      auto scale = [&](float v) { return quotient(v, den, rs); };
      // rows: S[i][j] / d (kLogdet) or L[i][j] (kTriInv: as given);
      // columns: S[k][j] or L[k][j] (kTriInv: none, L is not downdated)
      float rv[NB], cv[NB];
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        if (a < b) continue;
        const float u = cb[t.r * NB + a];
        rv[a] = M == Mode::kTriInv ? u : scale(u);
        if (M == Mode::kTriInv) continue;
        const float v = cb[t.c * NB + a];
        cv[a] = M == Mode::kLogdet ? v : scale(v);
      }
      if ((M == Mode::kFactor || M == Mode::kFactorRoots) && t.c == jc) {
        // column j of L, the diagonal included
#pragma unroll
        for (int a = 0; a < NB; ++a)
          if (a > b || (a == b && t.r >= jc)) s[a][b] = rv[a];
      }
      if (kX) {
        // row j of X scaled by 1 / L_jj (kTriInv: by its owners, in the
        // buffer), then X[i][q] -= L[i][j] X[j][q] for i > j, q <= j
        const float* xb = xrow + (j & 1) * kBuf;
        float xv[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          if (q > b) continue;
          const float v = xb[t.c * NB + q];
          xv[q] = M == Mode::kTriInv ? v : scale(v);
        }
        const bool qdone = t.c <= jc;
        if (t.r == jc) {
#pragma unroll
          for (int q = 0; q < NB; ++q)
            if (q < b || (q == b && qdone)) x[b][q] = xv[q];
        }
        const bool rpast = t.r > jc;
#pragma unroll
        for (int a = 0; a < NB; ++a) {
          if (a < b) continue;
#pragma unroll
          for (int q = 0; q < NB; ++q) {
            if (q > b) continue;
            if ((a > b || rpast) && (q < b || qdone)) x[a][q] -= rv[a] * xv[q];
          }
        }
      }
      // trailing triangle j < k <= i
      const bool cpast = t.c > jc, low = t.c <= t.r;
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        if (a < b || M == Mode::kTriInv) continue;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          if (k < b || k > a) continue;
          if ((k > b || cpast) && (k < a || low)) s[a][k] -= rv[a] * cv[k];
        }
      }
      // the next step's column (and row of X) into the other buffers
      if (j + 1 < p) {
        float* cn = col + ((j + 1) & 1) * kBuf;
        float* xn = kX ? xrow + ((j + 1) & 1) * kBuf : xrow;
        if (jc + 1 < kGrid)
          put<NB, M>(s, x, cn, xn, diag, b, jc + 1, t);
        else if (b + 1 < NB)
          put<NB, M>(s, x, cn, xn, diag, b + 1 < NB ? b + 1 : b, 0, t);
      }
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The solve mode (K5, tri_solve.cu): X = L^-1 B, or L^-T B, for a given
// lower factor L of width p <= 8 NB and one slab of at most C columns of B
// (C = 1, 2, 4 or 8, chosen by the host from B's width; a wider B is split
// into slabs, one block each).
//
// L sits in the tile map as in kTriInv (assemble: its lower triangle,
// padding the identity) and never changes. X sits in registers on a grid
// of kR x C threads, kR = kThreads / C: thread (xr, xc) = (tid / C, tid %
// C) holds X[xr + kR a][xc], a < kNA, so that at C = 1 the rows spread
// over all 64 threads. Forward step j (j ascending): at the end of step
// j - 1 the owners of row j of X scaled it by L[j][j] with the quotient
// and put it into the step's buffer, and the owners of column j of L put
// that column beside it; each thread reads the row's value of its column
// and L[i][j] of its rows i > j and takes X[i] -= L[i][j] X[j] on
// registers: _forward_subst's order, the subtractions in ascending j, then
// the division. Transposed step j (j descending): row j of L is put as
// the column of L^T and the rows i < j update, the twin's back
// substitution. One barrier a step, at its start; the buffers are
// double-buffered by the parity of j. The arithmetic is the twins' but for
// FMA contraction of the updates: the quotient is their division where
// regular() holds, and a member with an entry it refuses takes
// substitute_solve, the twins' whole-row substitution with division.
//
// Who runs a thread's part is the caller's `team`: on the card each thread
// of the member's block runs its own (tri_solve.cu); a host build of this
// header runs all kThreads parts one after another between barriers
// (tests/test_torch_tri_solve.py). team.each(f) calls f(part, tid) for the
// parts it runs, team.any(f) is a barrier that returns whether f is true
// for any part, team.sync() is a barrier.
// ---------------------------------------------------------------------------

template <int NB, int C>
struct SolveGrid {
  static constexpr int kR = kThreads / C;  // rows of the grid over X
  static constexpr int kNA = (NB * C + kGrid - 1) / kGrid;  // rows a thread
};

// one thread's registers
template <int NB, int C>
struct SolvePart {
  float s[NB][NB];                     // L in the tile map
  float x[SolveGrid<NB, C>::kNA];      // X[xr + kR a][xc]
  float d[SolveGrid<NB, C>::kNA];      // L[i][i] of those rows
  float r[SolveGrid<NB, C>::kNA];      // and 1 / L[i][i]
  bool odd;                            // an entry regular() refuses
};

// the member's shared memory
template <int NB, int C>
struct SolveBuffers {
  float col[2][kGrid * NB];  // column j of L (transposed: row j), entry
                             // g + 8 m at g * NB + m
  float xrow[2][C];          // row j of X, scaled
  float diag[kGrid * NB];    // L's diagonal
};

// column c < q of X over whole rows, the twins' substitution in their
// order: X[i][c] = (B[i][c] - sum_k L[i][k] X[k][c]) / L[i][i], k
// ascending below i (transposed: L[k][i], k descending above i). It reads
// back only its own column of x. The path of the members regular()
// refuses.
template <bool T>
__device__ __forceinline__ void substitute_solve(const float* l,
                                                 const float* b, float* x,
                                                 int p, int q, int c) {
  if (c >= q) return;
  for (int s = 0; s < p; ++s) {
    const int i = T ? p - 1 - s : s;
    float acc = b[i * q + c];
    if (T) {
      for (int k = p - 1; k > i; --k) acc -= l[k * p + i] * x[k * q + c];
    } else {
      for (int k = 0; k < i; ++k) acc -= l[i * p + k] * x[k * q + c];
    }
    x[i * q + c] = acc / l[i * p + i];
  }
}

// The owners of step j = 8 bn + jc put its buffers: column j of L (T: row
// j), and row j of X scaled by L[j][j] (the quotient with the reciprocal
// they hold), which they keep.
template <int NB, int C, bool T>
__device__ __forceinline__ void solve_put(SolvePart<NB, C>& pt,
                                          SolveBuffers<NB, C>& buf, int bn,
                                          int jc, int tid) {
  using Grid = SolveGrid<NB, C>;
  const int j = kGrid * bn + jc, par = j & 1;
  const Place t = place(tid);
  if (!T && t.c == jc) {
#pragma unroll
    for (int a = 0; a < NB; ++a)
      if (a >= bn) buf.col[par][t.r * NB + a] = pt.s[a][bn];
  }
  if (T && t.r == jc) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b <= bn) buf.col[par][t.c * NB + b] = pt.s[bn][b];
  }
  const int aj = kGrid * bn / Grid::kR;  // row j of X is at a = aj
  if (tid / C == j % Grid::kR) {
    pt.x[aj] = quotient(pt.x[aj], pt.d[aj], pt.r[aj]);
    buf.xrow[par][tid % C] = pt.x[aj];
  }
}

// the first step's buffers (T: step p - 1, in block (p - 1) / 8), with
// the block index a constant
template <int NB, int C, bool T, int BN = 0>
__device__ __forceinline__ void solve_put_first(SolvePart<NB, C>& pt,
                                                SolveBuffers<NB, C>& buf,
                                                int p, int tid) {
  if (!T || BN == (p - 1) / kGrid) {
    solve_put<NB, C, T>(pt, buf, BN, T ? (p - 1) % kGrid : 0, tid);
    return;
  }
  if constexpr (BN + 1 < NB) solve_put_first<NB, C, T, BN + 1>(pt, buf, p,
                                                               tid);
}

// Step j = 8 b + jc: the rows past j (T: before j) take X[i] -= L[i][j]
// X[j] (T: L[j][i] X[j]); then the next step's buffers.
template <int NB, int C, bool T>
__device__ __forceinline__ void solve_step(SolvePart<NB, C>& pt,
                                           SolveBuffers<NB, C>& buf, int b,
                                           int jc, int p, int tid) {
  using Grid = SolveGrid<NB, C>;
  const int j = kGrid * b + jc, par = j & 1;
  const int xr = tid / C;
  const float xv = buf.xrow[par][tid % C];
  const int aj = kGrid * b / Grid::kR;
#pragma unroll
  for (int a = 0; a < Grid::kNA; ++a) {
    if (T ? a > aj : a < aj) continue;
    const int i = xr + Grid::kR * a;
    if (T ? i < j : (i > j && i < p))
      pt.x[a] -= buf.col[par][(i % kGrid) * NB + i / kGrid] * xv;
  }
  if (T) {
    if (jc > 0)
      solve_put<NB, C, T>(pt, buf, b, jc - 1, tid);
    else if (b > 0)
      solve_put<NB, C, T>(pt, buf, b > 0 ? b - 1 : 0, kGrid - 1, tid);
  } else if (j + 1 < p) {
    if (jc + 1 < kGrid)
      solve_put<NB, C, T>(pt, buf, b, jc + 1, tid);
    else if (b + 1 < NB)
      solve_put<NB, C, T>(pt, buf, b + 1 < NB ? b + 1 : b, 0, tid);
  }
}

// The steps of column block B = U (T: NB - 1 - U) and the blocks after
// it, one barrier a step: the block index is a constant in each, so that
// every register index is.
template <int NB, int C, bool T, int U = 0, class Team>
__device__ __forceinline__ void solve_steps(Team& team,
                                            SolveBuffers<NB, C>& buf,
                                            int p) {
  constexpr int B = T ? NB - 1 - U : U;
  for (int v = 0; v < kGrid; ++v) {
    const int jc = T ? kGrid - 1 - v : v;
    if (kGrid * B + jc >= p) {
      if (T) continue;
      return;
    }
    team.sync();
    team.each([&](SolvePart<NB, C>& pt, int tid) {
      solve_step<NB, C, T>(pt, buf, B, jc, p, tid);
    });
  }
  if constexpr (U + 1 < NB) solve_steps<NB, C, T, U + 1>(team, buf, p);
}

// Slab `slab` of one member: l [p, p] (its lower triangle read), b and
// out [p, q], columns C slab .. C slab + C - 1.
template <int NB, int C, bool T, class Team>
__device__ __forceinline__ void solve(Team& team, SolveBuffers<NB, C>& buf,
                                      const float* __restrict__ l,
                                      const float* __restrict__ b,
                                      float* __restrict__ out, int p, int q,
                                      int slab) {
  using Grid = SolveGrid<NB, C>;
  using Part = SolvePart<NB, C>;
  const int c0 = C * slab;
  team.each([&](Part& pt, int tid) {
    if (tid < p) buf.diag[tid] = l[tid * (p + 1)];
    bool odd = false;
    assemble<NB>(pt.s, p, place(tid), [&](int i, int k) {
      const float v = l[i * p + k];
      odd |= !regular(v, i == k);
      return v;
    });
    pt.odd = odd;
    const int c = c0 + tid % C;
#pragma unroll
    for (int a = 0; a < Grid::kNA; ++a) {
      const int i = tid / C + Grid::kR * a;
      pt.x[a] = (i < p && c < q) ? b[i * q + c] : 0.f;
    }
  });
  if (team.any([](const Part& pt, int) { return pt.odd; })) {
    team.each([&](Part&, int tid) {
      if (tid < C) substitute_solve<T>(l, b, out, p, q, c0 + tid);
    });
    return;
  }
  // each thread's diagonal entries and their reciprocals, taken once;
  // then the first step's buffers and the steps
  team.each([&](Part& pt, int tid) {
#pragma unroll
    for (int a = 0; a < Grid::kNA; ++a) {
      const int i = tid / C + Grid::kR * a;
      pt.d[a] = i < p ? buf.diag[i] : 1.f;
      pt.r[a] = 1.f / pt.d[a];
    }
    solve_put_first<NB, C, T>(pt, buf, p, tid);
  });
  solve_steps<NB, C, T>(team, buf, p);
  team.each([&](Part& pt, int tid) {
    const int c = c0 + tid % C;
    if (c >= q) return;
#pragma unroll
    for (int a = 0; a < Grid::kNA; ++a) {
      const int i = tid / C + Grid::kR * a;
      if (i < p) out[i * q + c] = pt.x[a];
    }
  });
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<NB>(), Int<C>(), Int<T>()) for the tier's NB (2, 4, 6 or 8), the
// slab width C (1, 2, 4 or 8) and the direction T (0 or 1); false where
// there is no such instance
template <class F>
inline bool solve_dispatch(int nb, int c, int t, F f) {
  auto by_t = [&](auto nbv, auto cv) {
    if (t) {
      f(nbv, cv, Int<1>());
    } else {
      f(nbv, cv, Int<0>());
    }
    return true;
  };
  auto by_c = [&](auto nbv) {
    switch (c) {
      case 1: return by_t(nbv, Int<1>());
      case 2: return by_t(nbv, Int<2>());
      case 4: return by_t(nbv, Int<4>());
      case 8: return by_t(nbv, Int<8>());
      default: return false;
    }
  };
  switch (nb) {
    case 2: return by_c(Int<2>());
    case 4: return by_c(Int<4>());
    case 6: return by_c(Int<6>());
    case 8: return by_c(Int<8>());
    default: return false;
  }
}

// the tier's NB from the host's width tier (16, 32, 48 or 64), 0 if none
inline int tier_nb(int tier) {
  return (tier == 16 || tier == 32 || tier == 48 || tier == 64) ? tier / 8
                                                                : 0;
}

// ---------------------------------------------------------------------------
// The pullback mode (KP at 9 <= P <= 64, tri_solve.cu): the Cholesky
// pullback of one member of width p <= 8 NB, the JAX package's
// _cholesky_bwd and _cholesky_jittered_bwd,
//
//   W = phi(L^T Lbar'),  Lbar' = Lbar + diag(ldbar / diag L),
//   X = L^-T W,  raw = X L^-1,  Abar = (raw + raw^T) / 2,
//   jbar = f trace(Abar),
//
// with the lower triangles of L and Lbar read (phi keeps the lower
// triangle of M = L^T Lbar' and halves its diagonal, and M's lower
// triangle needs no more of Lbar').
//
// Layout: one member's kThreads threads on the 8 x 8 grid; thread (r, c)
// holds entry (r + 8a, c + 8b) of the whole square, a, b < NB, in
// registers: Lbar' (its lower triangle), then in its place M, W, X and
// raw. L sits in shared memory, row i at i kW (kW = 8 NB), entry k at (k %
// 8) NB + k / 8, zeros above the diagonal, so that the NB entries of a row
// one thread needs, (r + 8a) or (c + 8b), are contiguous, read by a whole
// grid row or column at once.
//
// Three sweeps, one barrier a step, each step's broadcast double-buffered
// by its parity:
// - M = L^T Lbar', t ascending: the owners of row t of Lbar' (grid row t
//   % 8) put it into a buffer and start row t of M in its place; every
//   thread takes M[i][k] += L[t][i] Lbar'[t][k] for its entries k <= i <=
//   t: each entry sums t >= i ascending. Then phi.
// - X = L^-T W, j descending (the twins' back substitution, the solve
//   mode's transposed step with all p columns): the owners of row j of X
//   scale it by L[j][j] (the quotient with the reciprocal taken once a
//   member) and put it; the rows i < j take X[i] -= L[j][i] X[j].
// - raw = X L^-1, t descending (each row of X back-substituted against
//   L^T, as the twins run it on X^T): the owners of column t (grid column
//   t % 8) scale it by L[t][t] and put it; the columns k < t take
//   raw[.][k] -= L[t][k] raw[.][t].
// The block index of a step is a template constant (pb_product,
// pb_rows, pb_cols), so every register index is, and the tiles a step
// cannot touch are left out at compile time; the 8 steps within a block
// stay a loop (unroll 1: unrolled, the 64-wide kernel has 14% more SASS
// instructions and ran 12% slower at 16384 x 64). Row j - 1
// (column t - 1) is updated first in its step and put by its owners while
// the other rows update; L and Lbar' are read in the tile map, all loads
// of a thread in flight at once. Then raw goes through shared memory
// (rows p | 1 apart, over L's place) for the symmetrization, stored a row
// at a time (coalesced), and the trace is summed in a fixed order: each
// diagonal thread's entries, then the eight partial sums.
//
// What bounds it on the card: a 64 x 64 member reads ~17 KB and writes 16
// KB for ~0.6 MFLOP (16384 x 64: 0.16 ms of bytes at 3.35 TB/s), but a
// member is a chain of ~3P dependent steps. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (tools/kernel_scaling.py --pullback, device time):
// 0.0372 ms at 256 x 49 (0.25 us a step), 1.046 ms at 16384 x 64, 96
// registers a thread and 10 blocks an SM at tier 64; left out one at a
// time (tools/pullback_variants.py), X's sweep is 0.33 ms of it, raw's
// 0.24 and the product 0.075.
//
// The arithmetic is the twins' but for FMA contraction and the product's
// order (the twin's is a matmul), and so are the NaN and inf patterns:
// - the scale is the quotient, their division where the diagonal entry is
//   zero, inf, NaN or in [2^-126, 2^126] (see quotient); a row or column
//   whose diagonal entry is subnormal is scaled by 2^64 first, the entry
//   too (both exact: x / d is (2^64 x) / (2^64 d), an x that overflows
//   included), and one above 2^126 may be an ulp off, as in the core;
// - the twins' product also runs over t < i, where L[t][i] is the zero
//   above the diagonal: 0 Lbar'[t][k] adds nothing unless Lbar'[t][k] is
//   inf or NaN (an ldbar / L[j][j] that overflows, a NaN cotangent), when
//   it makes M[i][k] NaN for every i > t. The loader finds each column's
//   first such row, bad[k], and M[i][k] becomes NaN for i > bad[k].
// So a member takes the same steps whatever its entries (no member falls
// to a serial path that would hold up its launch).
//
// Written against a `team`, as the solve mode above (a host build runs it
// in tests/test_torch_tri_solve.py).
// ---------------------------------------------------------------------------

// one thread's registers
template <int NB>
struct PullbackPart {
  float x[NB][NB];  // entry (r + 8a, c + 8b): Lbar', M, W, X, raw
};

// the member's shared memory
template <int NB>
struct PullbackBuffers {
  static constexpr int kW = kGrid * NB;
  float l[kW * (kW + 1)];   // L (see above); at the end raw, rows p | 1
                            // apart
  float diag[kW], rdiag[kW];  // L's diagonal (scaled) and reciprocals
  float scale[kW];            // 2^64 for a subnormal diagonal entry, or 1
  float lrow[2][kW];  // row t of Lbar', entry c + 8b at c NB + b
  float xrow[2][kW];  // row j of X, scaled; the same layout
  float rcol[2][kW];  // column t of raw, scaled; entry r + 8a at r NB + a
  int bad[kW];        // column k's first row t >= k of non-finite Lbar'
                      // (p where none)
  float trace[kGrid];   // the diagonal threads' partial traces
};

// the power of two that brings a subnormal diagonal entry into the
// quotient's exact range, or 1
__device__ __forceinline__ float subnormal_scale(float d) {
  const float a = fabsf(d);
  return (a > 0.f && a < 0x1p-126f) ? 0x1p64f : 1.f;
}

// N contiguous floats of shared memory into registers (the compiler's own
// loads: explicit 16-byte loads measured no faster), and back (16-byte
// stores where N % 4 == 0, 8-byte where N % 2 == 0: dst is aligned so)
template <int N>
__device__ __forceinline__ void load_run(const float* src, float (&dst)[N]) {
#pragma unroll
  for (int v = 0; v < N; ++v) dst[v] = src[v];
}

template <int N>
__device__ __forceinline__ void store_run(float* dst, const float (&src)[N]) {
#if defined(__CUDA_ARCH__)
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v)
      reinterpret_cast<float4*>(dst)[v] = make_float4(
          src[4 * v], src[4 * v + 1], src[4 * v + 2], src[4 * v + 3]);
    return;
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v)
      reinterpret_cast<float2*>(dst)[v] =
          make_float2(src[2 * v], src[2 * v + 1]);
    return;
  }
#endif
#pragma unroll
  for (int v = 0; v < N; ++v) dst[v] = src[v];
}

// *at = min(*at, v) in shared memory, from any thread
__device__ __forceinline__ void shared_min(int* at, int v) {
#if defined(__CUDA_ARCH__)
  atomicMin(at, v);
#else
  if (v < *at) *at = v;
#endif
}

// The owners of row t = 8 bn + tc of Lbar' put it into the product's
// buffer and start row t of M in its place (zeros).
template <int NB>
__device__ __forceinline__ void pb_put_lbar(PullbackPart<NB>& pt,
                                            PullbackBuffers<NB>& buf,
                                            int bn, int tc, Place g) {
  if (g.r != tc) return;
  store_run(buf.lrow[(kGrid * bn + tc) & 1] + g.c * NB, pt.x[bn]);
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b <= bn) pt.x[bn][b] = 0.f;  // right of column t: zeros already
}

// Product step t = 8 U + tc, t ascending, then the blocks after U. The
// owners put row t + 1 first: the step's updates reach rows i <= t only.
template <int NB, int U, class Team>
__device__ __forceinline__ void pb_product(Team& team,
                                           PullbackBuffers<NB>& buf,
                                           int p) {
  constexpr int kW = PullbackBuffers<NB>::kW;
#pragma unroll 1
  for (int tc = 0; tc < kGrid; ++tc) {
    const int t = kGrid * U + tc;
    if (t >= p) return;
    team.sync();
    team.each([&](PullbackPart<NB>& pt, int tid) {
      const Place g = place(tid);
      float bv[NB], lv[NB];  // Lbar'[t][c + 8b], L[t][r + 8a]
      load_run(buf.lrow[t & 1] + g.c * NB, bv);
      load_run(buf.l + t * kW + g.r * NB, lv);
      if (t + 1 < p) {
        if (tc + 1 < kGrid)
          pb_put_lbar<NB>(pt, buf, U, tc + 1, g);
        else if constexpr (U + 1 < NB)
          pb_put_lbar<NB>(pt, buf, U + 1, 0, g);
      }
      const bool rin = g.r <= tc, low = g.c <= g.r;
#pragma unroll
      for (int a = 0; a <= U; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b)
          if ((a < U || rin) && (b < a || low))
            pt.x[a][b] = fmaf(lv[a], bv[b], pt.x[a][b]);
      }
    });
  }
  if constexpr (U + 1 < NB) pb_product<NB, U + 1>(team, buf, p);
}

// The owners of row j = 8 bn + jc of X scale it by L[j][j] (d, its
// reciprocal r and the scale sc of j) and put it.
template <int NB>
__device__ __forceinline__ void pb_put_row(PullbackPart<NB>& pt,
                                           PullbackBuffers<NB>& buf, int bn,
                                           int jc, Place g, float d, float r,
                                           float sc) {
  if (g.r != jc) return;
#pragma unroll
  for (int b = 0; b < NB; ++b) pt.x[bn][b] = quotient(pt.x[bn][b] * sc, d, r);
  store_run(buf.xrow[(kGrid * bn + jc) & 1] + g.c * NB, pt.x[bn]);
}

// The owners of column t = 8 bn + tc of raw scale it by L[t][t] and put
// it.
template <int NB>
__device__ __forceinline__ void pb_put_col(PullbackPart<NB>& pt,
                                           PullbackBuffers<NB>& buf, int bn,
                                           int tc, Place g, float d, float r,
                                           float sc) {
  if (g.c != tc) return;
  float v[NB];
#pragma unroll
  for (int a = 0; a < NB; ++a)
    v[a] = pt.x[a][bn] = quotient(pt.x[a][bn] * sc, d, r);
  store_run(buf.rcol[(kGrid * bn + tc) & 1] + g.r * NB, v);
}

// The first row of X (column of raw: `col`), p - 1, put by its owners,
// with its block index a constant
template <int NB, bool col, int BN = 0>
__device__ __forceinline__ void pb_put_first(PullbackPart<NB>& pt,
                                             PullbackBuffers<NB>& buf, int p,
                                             Place g) {
  if (BN == (p - 1) / kGrid) {
    const int j = p - 1;
    const float d = buf.diag[j], r = buf.rdiag[j], sc = buf.scale[j];
    if (col)
      pb_put_col<NB>(pt, buf, BN, j % kGrid, g, d, r, sc);
    else
      pb_put_row<NB>(pt, buf, BN, j % kGrid, g, d, r, sc);
    return;
  }
  if constexpr (BN + 1 < NB) pb_put_first<NB, col, BN + 1>(pt, buf, p, g);
}

// X sweep step j = 8 B + jc, B = NB - 1 - U, j descending (step 0 has
// no rows above it: its row was scaled at the end of step 1), then the
// blocks before B. Row j - 1 is updated first and put while the other
// rows update (its owners' quotients overlap those updates).
template <int NB, int U, class Team>
__device__ __forceinline__ void pb_rows(Team& team,
                                        PullbackBuffers<NB>& buf, int p) {
  constexpr int kW = PullbackBuffers<NB>::kW, B = NB - 1 - U;
#pragma unroll 1
  for (int v = 0; v < kGrid; ++v) {
    const int jc = kGrid - 1 - v, j = kGrid * B + jc;
    if (j >= p) continue;
    if (j == 0) return;
    team.sync();
    team.each([&](PullbackPart<NB>& pt, int tid) {
      const Place g = place(tid);
      float xv[NB], lv[NB];  // X[j][c + 8b] scaled, L[j][r + 8a]
      load_run(buf.xrow[j & 1] + g.c * NB, xv);
      load_run(buf.l + j * kW + g.r * NB, lv);
      const float d = buf.diag[j - 1], r = buf.rdiag[j - 1],
                  sc = buf.scale[j - 1];
      auto row = [&](int a) {  // X[r + 8a] -= L[j][r + 8a] X[j]
#pragma unroll
        for (int b = 0; b < NB; ++b)
          pt.x[a][b] = fmaf(-lv[a], xv[b], pt.x[a][b]);
      };
      if (jc > 0) {
        // row j - 1 in block B; its owners' grid row jc - 1 is above j
        if (g.r < jc) row(B);
        pb_put_row<NB>(pt, buf, B, jc - 1, g, d, r, sc);
#pragma unroll
        for (int a = 0; a < B; ++a) row(a);
      } else if constexpr (B > 0) {
        row(B - 1);
        pb_put_row<NB>(pt, buf, B - 1, kGrid - 1, g, d, r, sc);
#pragma unroll
        for (int a = 0; a < B - 1; ++a) row(a);
      }
    });
  }
  if constexpr (U + 1 < NB) pb_rows<NB, U + 1>(team, buf, p);
}

// raw sweep step t = 8 B + tc, B = NB - 1 - U, t descending, then the
// blocks before B; column t - 1 first, as the rows above.
template <int NB, int U, class Team>
__device__ __forceinline__ void pb_cols(Team& team,
                                        PullbackBuffers<NB>& buf, int p) {
  constexpr int kW = PullbackBuffers<NB>::kW, B = NB - 1 - U;
#pragma unroll 1
  for (int v = 0; v < kGrid; ++v) {
    const int tc = kGrid - 1 - v, t = kGrid * B + tc;
    if (t >= p) continue;
    if (t == 0) return;
    team.sync();
    team.each([&](PullbackPart<NB>& pt, int tid) {
      const Place g = place(tid);
      float rv[NB], lv[NB];  // raw[r + 8a][t] scaled, L[t][c + 8b]
      load_run(buf.rcol[t & 1] + g.r * NB, rv);
      load_run(buf.l + t * kW + g.c * NB, lv);
      const float d = buf.diag[t - 1], r = buf.rdiag[t - 1],
                  sc = buf.scale[t - 1];
      auto col = [&](int b) {  // raw[.][c + 8b] -= L[t][c + 8b] raw[.][t]
#pragma unroll
        for (int a = 0; a < NB; ++a)
          pt.x[a][b] = fmaf(-lv[b], rv[a], pt.x[a][b]);
      };
      if (tc > 0) {
        if (g.c < tc) col(B);
        pb_put_col<NB>(pt, buf, B, tc - 1, g, d, r, sc);
#pragma unroll
        for (int b = 0; b < B; ++b) col(b);
      } else if constexpr (B > 0) {
        col(B - 1);
        pb_put_col<NB>(pt, buf, B - 1, kGrid - 1, g, d, r, sc);
#pragma unroll
        for (int b = 0; b < B - 1; ++b) col(b);
      }
    });
  }
  if constexpr (U + 1 < NB) pb_cols<NB, U + 1>(team, buf, p);
}

// One member: l, lbar and abar [p, p]; ldbar the member's log-determinant
// cotangent (null: none), jbar its jitter cotangent (null: not written),
// f its escalation factor.
template <int NB, class Team>
__device__ __forceinline__ void pullback(Team& team,
                                         PullbackBuffers<NB>& buf,
                                         const float* __restrict__ l,
                                         const float* __restrict__ lbar,
                                         const float* ldbar,
                                         float* __restrict__ abar,
                                         float* jbar, float f, int p) {
  using Part = PullbackPart<NB>;
  constexpr int kW = PullbackBuffers<NB>::kW;
  team.each([&](Part&, int tid) {
    if (tid < kW) buf.bad[tid] = p;
  });
  team.sync();
  team.each([&](Part& pt, int tid) {
    const Place g = place(tid);
    // L in the tile map (all its loads in flight at once), then into
    // shared memory a row run at a time; its diagonal entries (scaled)
    // and their reciprocals
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int i = g.r + kGrid * a, k = g.c + kGrid * b;
        pt.x[a][b] = (lower(a, b, g) && i < p && k < p) ? l[i * p + k] : 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int i = g.r + kGrid * a;
      if (i >= p) continue;
      store_run(buf.l + i * kW + g.c * NB, pt.x[a]);
      if (g.r == g.c) {
        const float v = pt.x[a][a], sc = subnormal_scale(v);
        buf.scale[i] = sc;
        buf.diag[i] = v * sc;
        buf.rdiag[i] = 1.f / (v * sc);
      }
    }
    // Lbar' in its place, its lower triangle; each column's first row of
    // a non-finite entry
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int i = g.r + kGrid * a, k = g.c + kGrid * b;
        float v = 0.f;
        if (lower(a, b, g) && i < p && k < p) {
          v = lbar[i * p + k];
          if (i == k && ldbar != nullptr) v += *ldbar / pt.x[a][a];
          if (!isfinite(v)) shared_min(&buf.bad[k], i);
        }
        pt.x[a][b] = v;
      }
    }
  });
  team.sync();
  team.each([&](Part& pt, int tid) {
    pb_put_lbar<NB>(pt, buf, 0, 0, place(tid));
  });
  pb_product<NB, 0>(team, buf, p);
  // the twins' zero terms (M[i][k] NaN below column k's first non-finite
  // Lbar'), phi (the diagonal halved), then the first row of X
  team.each([&](Part& pt, int tid) {
    const Place g = place(tid);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int k = g.c + kGrid * b;
      const int bad = k < p ? buf.bad[k] : p;
#pragma unroll
      for (int a = 0; a < NB; ++a)
        if (a >= b && g.r + kGrid * a > bad && g.r + kGrid * a < p)
          pt.x[a][b] = NAN;
    }
    if (g.r == g.c) {
#pragma unroll
      for (int a = 0; a < NB; ++a) pt.x[a][a] = pt.x[a][a] - 0.5f * pt.x[a][a];
    }
    pb_put_first<NB, false>(pt, buf, p, g);
  });
  pb_rows<NB, 0>(team, buf, p);
  team.each([&](Part& pt, int tid) {
    pb_put_first<NB, true>(pt, buf, p, place(tid));
  });
  pb_cols<NB, 0>(team, buf, p);
  // raw through shared memory (every thread is past its last read of L),
  // the diagonal threads' partial traces
  const int st = p | 1;
  team.sync();
  team.each([&](Part& pt, int tid) {
    const Place g = place(tid);
    float tr = 0.f;
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int i = g.r + kGrid * a;
      if (i >= p) continue;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int k = g.c + kGrid * b;
        if (k < p) buf.l[i * st + k] = pt.x[a][b];
      }
      if (g.r == g.c) tr += 0.5f * (pt.x[a][a] + pt.x[a][a]);
    }
    if (g.r == g.c) buf.trace[g.r] = tr;
  });
  team.sync();
  team.each([&](Part&, int tid) {
    if (tid < p) {
      for (int i = 0; i < p; ++i)
        abar[i * p + tid] = 0.5f * (buf.l[i * st + tid] + buf.l[tid * st + i]);
    }
    if (tid == 0 && jbar != nullptr) {
      float tr = 0.f;
#pragma unroll
      for (int r = 0; r < kGrid; ++r) tr += buf.trace[r];
      *jbar = f * tr;
    }
  });
}

}  // namespace chol_tile
