// Batched explicit inverse of lower-triangular matrices, 64 < P <= 256,
// for Hopper (sm_90a): K3 at the wide leaves' widths in one launch.
//
// Replaces, for these widths, pymra_tpu/ops/pallas/linalg.py::
// _tri_inv_recursive (:1072, what the JAX package's triangular_inverse_lower
// runs above 80: 2 x 2 block inversion with MXU matmuls) and the port's
// composition that followed it on the card (K3 launches on the 64-wide
// diagonal blocks, float32 GEMMs and concatenations in HBM:
// _tri_inv_blocked in pymra_torch/ops/linalg.py, which still takes P >
// 256). For every member of a [B, P, P] float32 batch of lower factors
// (only the lower triangle is read) it writes X = L^-1, zeros above the
// diagonal, by 64-wide block rows and columns:
//
//   X_jj = L_jj^-1,   X_ij = -X_ii (sum_{k=j}^{i-1} L_ik X_kj)  (i > j),
//
// the blocks below the diagonal by block diagonals d = i - j = 1, 2, ...,
// each from blocks of earlier diagonals. The MRA sweep calls it once a
// forward on the wide leaves' posterior factors (sweep.py, `Li`), so that
// their solves become matmuls, as in the JAX package.
//
// What bounds it: at 4096 x 256 a member reads its lower triangle (132 KB)
// and writes X (256 KB): 1.6 GB, 0.48 ms at 3.35 TB/s, the bound; the
// function is P^3/3 = 5.6 MFLOP a member (0.34 ms at 67 TFLOP/s of
// float32). The blocked form runs 16 products of 64^3 multiply-adds a
// member at P = 256 (8.4 MFLOP, over the diagonal blocks' zeros; 13 with
// the slices skipped below), 0.58 ms at that peak. The composition it
// replaces sent every block product and concatenation through HBM (6.2
// ms a call at this shape).
//
// Design: one 256-thread block a member (blocks stay resident two an SM).
// (1) The four 64-thread groups of the block invert up to four diagonal
// blocks at once, each with the register-tiled core of chol_tile.cuh in
// its inverse mode (64-wide tier, the last block padded with the identity)
// behind its own named barrier, and store them into the output. (2) Each
// block X_ij below the diagonal is two products, on the FP32 units, 4 x 4
// entries a thread: Y = sum_k L_ik X_kj over the K = 64 d columns, with
// 32-column slices of L (from the input) and of the X_kj (read back from
// the output this block wrote) streamed through shared memory by
// asynchronous copies (cp.async), double-buffered; then -X_ii Y with Y
// kept in shared memory and X_ii streamed the same way. A warp skips the
// slices whose terms are all products with the zeros above X_jj's or
// X_ii's diagonal. float32 sums, as the composition's float32 GEMMs (TF32
// off). No scratch: only the output is written, so the launch needs no
// allocation but the output's and no host synchronization.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3):
// 1.739 ms a call at 4096 x 256 (1.762 on the device), 28% of the bound,
// against 4.623 for the composition over tri_inv.cu (6.177 over the
// thread-per-column kernel before it) and 10.462 for `solve_triangular`;
// 0.048 ms at 64 x 169 (the composition 0.628). Without the diagonal
// blocks' step loops it takes 1.462 ms, without the products 0.723,
// without the skipped slices 1.857 (tools/wide_variants.py): the products
// take ~1.0 ms, the diagonal blocks ~0.3.
//
// Non-finite inputs: a member whose diagonal blocks hold an entry the core
// refuses (chol_tile::regular: a non-finite entry, a diagonal entry that is
// zero, subnormal, above 2^126, inf or NaN) or whose result has any
// non-finite entry (a non-finite L_ik below the diagonal blocks always
// spreads into its block row; or an overflow) is inverted again by
// chol_tile::substitute, the twin's whole-row forward substitution with
// IEEE division: its inf and NaN land where triangular_inverse_lower_ref
// puts them. The others carry the twin's values up to float32 rounding in
// another order (blocked sums, FMA). Built without fast-math.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using chol_tile::Mode;

constexpr int kThreads = 256;
constexpr int kBlock = 64;                              // block row width
constexpr int kGroups = kThreads / chol_tile::kThreads;  // diagonal blocks
constexpr int kNB = kBlock / chol_tile::kGrid;          // the core's tier
constexpr int kBuf = chol_tile::kGrid * kNB;
constexpr int kSlice = 32;       // columns of a streamed slice
constexpr int kLd = kBlock + 4;  // row stride of the tiles: 16-byte rows

struct Smem {
  float col[kGroups][2 * kBuf];   // the core's buffers, one set a group
  float xrow[kGroups][2 * kBuf];
  float diag[kGroups][kBlock];    // the diagonal blocks' diagonals
  float a[2][kSlice][kLd];        // A slices, transposed: a[q][row]
  float b[2][kSlice][kLd];        // B slices: b[q][column]
  float y[kBlock][kLd];           // sum_k L_ik X_kj
};

// 4 bytes global -> shared, asynchronously; zeros where !valid (no read)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's 4 x 4 entries of a 64 x 64 block: rows 4 ty + u, columns 4 tx
// + v; a warp holds 8 whole rows (kRows) or 8 whole columns.
struct Quad {
  int tx, ty;
};

template <bool kRows>
__device__ __forceinline__ Quad quad() {
  const int t = threadIdx.x;
  return kRows ? Quad{t & 15, t >> 4} : Quad{t >> 4, t & 15};
}

// acc += A[:, 0:kdim] B[0:kdim, :] for a 64 x 64 block, in the layout
// quad<kBShared>(): A's rows from `a` (row-major, `ld` apart; rows a_rows
// and beyond read as zeros), B's rows from `b` (the same layout) or, with
// kBShared, from the shared y. The output `b` points into was written by
// this block before its last barrier: plain (coherent) reads. A warp skips
// a slice whose terms are all products with zeros above a diagonal block's
// diagonal: with kBShared A is X_ii (row r is zero right of column r), a
// warp 8 rows; else B's first 64 rows are X_jj, a warp 8 columns. A
// non-finite entry it then leaves out still makes the result non-finite
// (its own row or column meets a nonzero), so the member is redone by
// substitute() as it would have been.
template <bool kBShared>
__device__ __forceinline__ void product(float (&acc)[4][4], const float* a,
                                        int a_rows, const float* b, int ld,
                                        int kdim, Smem& sm) {
  const int t = threadIdx.x, w = t / 32;
  const Quad d = quad<kBShared>();
  const int slices = (kdim + kSlice - 1) / kSlice;
  // this thread's copies of a slice: A's rows ra + kRowStep m at its
  // column qa, B's rows qb + kRowStep' m at its column cb
  constexpr int kCopies = kBlock * kSlice / kThreads;
  constexpr int kAStep = kThreads / kSlice, kBStep = kThreads / kBlock;
  const int qa = t % kSlice, ra = t / kSlice, qb = t / kBlock,
            cb = t % kBlock;
  auto stage = [&](int s, int buf) {
    const int k0 = s * kSlice;
    const bool kin = k0 + qa < kdim;
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int r = ra + kAStep * m;
      const bool ok = r < a_rows && kin;
      copy4(&sm.a[buf][qa][r], ok ? a + (size_t)r * ld + k0 + qa : a, ok);
    }
    if constexpr (!kBShared) {
      // B's rows are all there: kdim is 64 d here
      const float* src = b + (size_t)(k0 + qb) * ld + cb;
#pragma unroll
      for (int m = 0; m < kCopies; ++m)
        copy4(&sm.b[buf][qb + kBStep * m][cb],
              src + (size_t)kBStep * m * ld, true);
    }
    commit();
  };
  stage(0, 0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      stage(s + 1, (s + 1) & 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int buf = s & 1, k0 = s * kSlice;
    const bool zeros = kBShared ? 8 * w + 7 < k0
                                : k0 < kBlock && 8 * w >= k0 + kSlice;
    if (!zeros) {
#pragma unroll
      for (int q = 0; q < kSlice; ++q) {
        const float4 av =
            *reinterpret_cast<const float4*>(&sm.a[buf][q][4 * d.ty]);
        const float4 bv = *reinterpret_cast<const float4*>(
            kBShared ? &sm.y[k0 + q][4 * d.tx] : &sm.b[buf][q][4 * d.tx]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(ar[u], br[v], acc[u][v]);
      }
    }
    __syncthreads();  // the next slice's copies overwrite this buffer
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    tri_inv_wide_kernel(const float* __restrict__ l, float* x, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int nb = (p + kBlock - 1) / kBlock;
  const float* src = l + (size_t)blockIdx.x * p * p;
  float* dst = x + (size_t)blockIdx.x * p * p;

  // -- (1) the diagonal blocks, one 64-thread group each
  bool odd = false;
  const int g = t / chol_tile::kThreads;  // uniform in a warp
  if (g < nb) {
    const int j0 = kBlock * g, bw = min(kBlock, p - j0);
    const chol_tile::Place pl = chol_tile::place(t % chol_tile::kThreads);
    float s[kNB][kNB], xt[kNB][kNB];
    const int tg = t % chol_tile::kThreads;
    if (tg < bw) sm.diag[g][tg] = src[(size_t)(j0 + tg) * (p + 1)];
    chol_tile::assemble<kNB>(s, bw, pl, [&](int i, int k) {
      const float v = src[(size_t)(j0 + i) * p + j0 + k];
      odd |= !chol_tile::regular(v, i == k);
      return v;
    });
    chol_tile::factor<kNB, Mode::kTriInv>(s, xt, sm.col[g], sm.xrow[g], bw,
                                          pl, chol_tile::GroupSync{g + 1},
                                          sm.diag[g]);
    chol_tile::store<kNB>(xt, dst + (size_t)j0 * p + j0, bw, pl, p);
  }
  if (__syncthreads_or(odd)) {
    chol_tile::substitute(src, dst, p, p, t, kThreads);
    return;
  }
  // the zeros right of each row's diagonal block, a warp a row
  for (int i = t / 32; i < p; i += kThreads / 32)
    for (int c = kBlock * (i / kBlock + 1) + t % 32; c < p; c += 32)
      dst[(size_t)i * p + c] = 0.f;

  // -- (2) the blocks below the diagonal, by block diagonals
  const Quad d1 = quad<false>(), d2 = quad<true>();
  bool bad = false;
  for (int diag = 1; diag < nb; ++diag) {
    for (int i = diag; i < nb; ++i) {
      const int j = i - diag, i0 = kBlock * i, j0 = kBlock * j;
      const int bi = min(kBlock, p - i0);
      float acc[4][4] = {};
      product<false>(acc, src + (size_t)i0 * p + j0, bi,
                     dst + (size_t)j0 * p + j0, p, kBlock * diag, sm);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(&sm.y[4 * d1.ty + u][4 * d1.tx]) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      float z[4][4] = {};
      product<true>(z, dst + (size_t)i0 * p + i0, bi, nullptr, p, bi, sm);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * d2.ty + u;
        if (r >= bi) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float o = -z[u][v];
          bad |= !isfinite(o);
          dst[(size_t)(i0 + r) * p + j0 + 4 * d2.tx + v] = o;
        }
      }
      __syncthreads();  // later blocks read X_ij back
    }
  }
  if (__syncthreads_or(bad))
    chol_tile::substitute(src, dst, p, p, t, kThreads);
}

}  // namespace

// Launches on `stream`, one block a member; allocates nothing. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a width it does not
// take (64 < p <= 256).
extern "C" int pymra_tri_inv_wide(const void* l, void* x, int batch, int p,
                                  int device, void* stream) {
  if (p <= kBlock || p > kGroups * kBlock) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int shmem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(tri_inv_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shmem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_wide_kernel<<<batch, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)l, (float*)x, p);
  return (int)cudaGetLastError();
}
