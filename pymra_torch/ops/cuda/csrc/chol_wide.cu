// Wide batched Cholesky factorization, 64 < P <= 256, for Hopper (sm_90a):
// the blocked factor K8 and the jitter cascade KC in one kernel.
//
// Replaces the TPU compositions pymra_tpu/ops/pallas/linalg.py::
// cholesky_blocked (K8, :1097) and cholesky_cascade_lanes (KC, :976), both
// built there from _chol_kernel and _tri_inv_kernel launches and MXU
// matmuls. For every member b of a [B, P, P] float32 batch (only the lower
// triangle is read) one launch computes
//
//   L_b = chol(A_b + f jit_b I)     (lower, zeros above the diagonal)
//   ld_b = sum_j log L_jj,  f_b the selected factor
//
// with f escalating through factors[0..n_factors-1] while L_b has any
// non-finite entry (KC); with one factor and no jitter it is K8 and writes
// L only, NaN from an indefinite block's failing column on, in its own
// member only. A member that fails every factor keeps its last, NaN,
// factor, ld NaN and the last factor.
//
// The arithmetic is that of the plain twins (pymra_torch/ops/linalg.py,
// _blocked over cholesky_ref and triangular_inverse_lower_ref), staged as
// they stage it, in 64-wide block columns: each diagonal
// block rounded to float32, factored by the column loop (L[j:, j] =
// S[j:, j] / sqrt(S[j, j]), a division, the diagonal included) and
// inverted by forward substitution (X[j, :] /= L[j, j]; X[i, :] -= L[i, j]
// X[j, :]) in float32; the panel A21 L11^-T and every trailing downdate
// A22 - L21 L21^T carried in float64 and rounded once, where they leave.
// No fast-math: the escalation relies on IEEE sqrtf/logf/division giving
// NaN and -inf. The kernel contracts multiply-adds into FMA, the twins do
// not, and a float64 downdate sums in another order than cuBLAS.
//
// What bounds it: at 4096 x 256 a member reads its lower triangle (132 KB)
// and writes L (256 KB): 1.6 GB, 0.48 ms at 3.35 TB/s, the bound. The
// function needs 5.2 MFLOP of float64 a member for the panels and
// downdates (21 GFLOP, 0.32 ms at the FP64 tensor cores' 67 TFLOP/s) and
// 0.7 MFLOP of float32 for the diagonal blocks; this kernel does ~8.4
// MFLOP of float64 (the panel runs over L11^-T's zeros too, for the twin's
// NaN pattern, and the diagonal chunk is downdated whole). The composition
// it replaces sent every panel, trailing matrix and product through HBM
// in float64 (~1 GB each at this shape) and synchronized the host to
// gather the failed members.
//
// Design: a persistent grid of 256-thread blocks (the host passes as many
// as fit on the card at once), each walking members blockIdx.x, +gridDim.x,
// ... and owning a float64 slab of P x P in global memory (allocated by the
// wrapper), where it keeps the float64 panels of its current member: they
// feed the later block columns' downdates, and the slabs stay small enough
// to live mostly in L2. A block column k is left-looking over its 64-row
// chunks: each chunk's float64 tile A - sum_m L21_m L21_m^T (summed per
// earlier block column m in order, as the twin subtracts one product at a
// time) is formed in registers, 4 x 4 entries a thread, from 16-column
// slices of the slab staged in shared memory. The diagonal chunk is
// rounded to float32 and factored and inverted together in shared memory,
// two barriers a column; the chunks below multiply by L11^-T in float64.
// Escalation stays in the block: an attempt that wrote a non-finite entry
// stops at the end of that block column (but for the last attempt, which
// runs to the end for the NaN pattern), and the member is refactored from
// its input at the next factor. Good members never read another member's
// data, so their bits do not depend on who escalates.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3):
// at 4096 x 256 K8 7.29 ms a call (7.28 on the device; `cholesky_ex` 8.28,
// the composition 9.25) and KC 7.69 (7.67; `cholesky_ex` and the jitter
// add 9.98, the composition 16.18), 6.6% and 6.3% of the bound; at 64 x
// 169 0.36 and 0.62 ms, where 64 members leave half the SMs idle and
// `cholesky_ex` (0.23) wins: a member's three diagonal blocks, and KC's
// escalated members their attempts, run one after another. Nothing of it
// runs on the tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;        // block column width
constexpr int kSlice = 16;        // columns of a staged slab slice
constexpr int kPad = kBlock + 1;  // odd row stride of the shared tiles

struct Smem {
  float s[kBlock][kPad];             // diagonal block, working (float32)
  float lf[kBlock][kPad];            // its factor L11
  float x[kBlock][kPad];             // L11^-1
  double w[kBlock][kPad];            // a chunk's downdated tile (float64)
  double li[kSlice][kPad];           // slab slice of the chunk's rows
  double lj[kSlice][kPad];           // slab slice of the diagonal rows
};

// acc[u][v] (rows i0 + ty + 16u, columns j0 + tx + 16v of the member)
// -= sum over earlier block columns m < k, in order, of (L21_m L21_m^T),
// each product summed over its 64 columns before it is subtracted. The
// slab is written by this block in this launch: plain (coherent) loads,
// never the read-only path a const __restrict__ pointer would allow.
__device__ __forceinline__ void downdate(double (&acc)[4][4],
                                         const double* slab, Smem& sm,
                                         int p, int i0, int j0, int k) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int m = 0; m < k; ++m) {
    double dot[4][4] = {};
    for (int qs = 0; qs < kBlock; qs += kSlice) {
      __syncthreads();  // the slices' last readers are done
      for (int e = t; e < kBlock * kSlice; e += kThreads) {
        const int r = e / kSlice, q = e % kSlice;
        const int col = kBlock * m + qs + q;
        sm.li[q][r] = i0 + r < p ? slab[(size_t)(i0 + r) * p + col] : 0.0;
        sm.lj[q][r] = j0 + r < p ? slab[(size_t)(j0 + r) * p + col] : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kSlice; ++q) {
        double a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = sm.li[q][ty + 16 * u];
#pragma unroll
        for (int v = 0; v < 4; ++v) b[v] = sm.lj[q][tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) dot[u][v] = fma(a[u], b[v], dot[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] -= dot[u][v];
  }
}

// one attempt's lower-triangle entry (i, j), i >= j, of A + add I
__device__ __forceinline__ double entry(const float* __restrict__ src, int p,
                                        int i, int j, float add,
                                        bool jittered) {
  float v = src[(size_t)i * p + j];
  if (jittered && i == j) v += add;
  return (double)v;
}

__global__ void __launch_bounds__(kThreads, 2)
    chol_wide_kernel(const float* __restrict__ a,
                     const float* __restrict__ jit, float* __restrict__ l,
                     float* __restrict__ ld, float* __restrict__ fsel,
                     double* slabs, int batch, int p,
                     int n_factors, float f0, float f1, float f2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const float factors[3] = {f0, f1, f2};
  const int nb = (p + kBlock - 1) / kBlock;
  double* slab = slabs + (size_t)blockIdx.x * p * p;

  for (int mem = blockIdx.x; mem < batch; mem += gridDim.x) {
    const float* src = a + (size_t)mem * p * p;
    float* out = l + (size_t)mem * p * p;
    const bool jittered = jit != nullptr;
    int at = 0;
    bool bad = false;
    float ld_sum = 0.f;  // thread 0's log-diagonal sum
    for (; at < n_factors; ++at) {
      const bool last = at + 1 == n_factors;
      const float add = jittered ? jit[mem] * factors[at] : 0.f;
      bad = false;
      ld_sum = 0.f;
      for (int k = 0; k < nb; ++k) {
        const int j0 = kBlock * k, b = min(kBlock, p - j0);
        // -- the diagonal chunk: float64 downdate, rounded to float32
        double acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int r = ty + 16 * u, c = tx + 16 * v;
            acc[u][v] = (r < b && c <= r)
                            ? entry(src, p, j0 + r, j0 + c, add, jittered)
                            : 0.0;
          }
        downdate(acc, slab, sm, p, j0, j0, k);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int r = ty + 16 * u, c = tx + 16 * v;
            sm.s[r][c] = (float)acc[u][v];
            sm.x[r][c] = r == c ? 1.f : 0.f;
          }
        __syncthreads();
        // -- factor and invert together: step j forms L[j:, j] = S[j:, j]
        // / sqrt(S[j, j]) and scales row j of X by L[j, j] (every thread
        // forms that pivot alike), then downdates S[i, c] -= L[i, j] L[c,
        // j] (j < c <= i) and X[i, q] -= L[i, j] X[j, q] (i > j, q <= j):
        // the twins' column loop and forward substitution, whose row j is
        // final once column j is. X's entries right of the diagonal stay
        // exact zeros while every pivot is finite and nonzero.
        for (int j = 0; j < b; ++j) {
          const float d = sm.s[j][j], piv = sqrtf(d);
          if (t >= j && t < b) sm.lf[t][j] = sm.s[t][j] / piv;
          const int q = t - kBlock;
          if (q >= 0 && q <= j) sm.x[j][q] = sm.x[j][q] / (d / piv);
          __syncthreads();
          const int i = t >> 2;
          if (i > j && i < b) {
            const float li = sm.lf[i][j];
            for (int c = j + 1 + (t & 3); c <= i; c += 4)
              sm.s[i][c] -= li * sm.lf[c][j];
            for (int c = t & 3; c <= j; c += 4)
              sm.x[i][c] -= li * sm.x[j][c];
          }
          __syncthreads();
        }
        // a factor with a non-finite entry or a zero pivot: X again over
        // whole rows, as the twin's substitution runs, for its NaN pattern
        bool odd = false;
        for (int e = t; e < b * b; e += kThreads) {
          const int r = e / b, c = e % b;
          if (c <= r) {
            const float v = sm.lf[r][c];
            odd |= !isfinite(v) || (r == c && v == 0.f);
          }
        }
        if (__syncthreads_or(odd)) {
          for (int e = t; e < kBlock * kBlock; e += kThreads) {
            const int r = e / kBlock, c = e % kBlock;
            sm.x[r][c] = r == c ? 1.f : 0.f;
          }
          __syncthreads();
          for (int j = 0; j < b; ++j) {
            if (t < b) sm.x[j][t] = sm.x[j][t] / sm.lf[j][j];
            __syncthreads();
            for (int e = t; e < (b - j - 1) * b; e += kThreads) {
              const int i = j + 1 + e / b, q = e % b;
              sm.x[i][q] -= sm.lf[i][j] * sm.x[j][q];
            }
            __syncthreads();
          }
        }
        // L11 and the zeros above it in these columns
        for (int e = t; e < (j0 + b) * b; e += kThreads) {
          const int r = e / b, c = e % b;
          float v = 0.f;
          if (r >= j0 && r - j0 >= c) {
            v = sm.lf[r - j0][c];
            bad |= !isfinite(v);
          }
          out[(size_t)r * p + j0 + c] = v;
        }
        if (t == 0)
          for (int j = 0; j < b; ++j) ld_sum += logf(sm.lf[j][j]);
        // -- the chunks below: panel = (A - downdates) L11^-T in float64
        for (int i0 = j0 + kBlock; i0 < p; i0 += kBlock) {
          const int rb = min(kBlock, p - i0);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int r = ty + 16 * u, c = tx + 16 * v;
              acc[u][v] = (r < rb && c < b)
                              ? entry(src, p, i0 + r, j0 + c, add, jittered)
                              : 0.0;
            }
          downdate(acc, slab, sm, p, i0, j0, k);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              sm.w[ty + 16 * u][tx + 16 * v] = acc[u][v];
          __syncthreads();
          double pan[4][4] = {};
          for (int q = 0; q < b; ++q) {
            double wv[4], xv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) wv[u] = sm.w[ty + 16 * u][q];
#pragma unroll
            for (int v = 0; v < 4; ++v) xv[v] = (double)sm.x[tx + 16 * v][q];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                pan[u][v] = fma(wv[u], xv[v], pan[u][v]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int r = ty + 16 * u, c = tx + 16 * v;
              if (r < rb && c < b) {
                const float o = (float)pan[u][v];
                bad |= !isfinite(o);
                out[(size_t)(i0 + r) * p + j0 + c] = o;
                slab[(size_t)(i0 + r) * p + j0 + c] = pan[u][v];
              }
            }
          __syncthreads();  // w is rewritten by the next chunk
        }
        // a failed attempt that is not the last stops here
        if (__syncthreads_or(bad) && !last) break;
      }
      bad = __syncthreads_or(bad);
      if (!bad) break;
    }
    if (t == 0 && ld != nullptr) {
      ld[mem] = bad ? __int_as_float(0x7fc00000) : ld_sum;
      fsel[mem] = factors[at < n_factors ? at : n_factors - 1];
    }
    __syncthreads();  // shared tiles and the slab serve the next member
  }
}

}  // namespace

// Launches `grid` persistent blocks on `stream` (the wrapper passes at most
// as many as fit on the card at once, and a float64 scratch `slabs` of grid
// x p x p); allocates nothing. `jit`, `ld` and `f` may be null together
// (K8: one factor, no jitter). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width or factor count it does not take.
extern "C" int pymra_chol_wide(const void* a, const void* jit, void* l,
                               void* ld, void* f, void* slabs, int batch,
                               int p, int n_factors, float f0, float f1,
                               float f2, int grid, int device, void* stream) {
  if (p <= kBlock || p > 4 * kBlock || n_factors < 1 || n_factors > 3 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int shmem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(chol_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shmem);
  if (err != cudaSuccess) return (int)err;
  chol_wide_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)jit, (float*)l, (float*)ld, (float*)f,
      (double*)slabs, batch, p, n_factors, f0, f1, f2);
  return (int)cudaGetLastError();
}

// The grid `pymra_chol_wide` should be given on `device`: blocks that fit
// on the card at once (SMs x resident blocks an SM), or a negative CUDA
// error code.
extern "C" int pymra_chol_wide_grid(int device) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(chol_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chol_wide_kernel, kThreads, sizeof(Smem));
  if (err != cudaSuccess) return -(int)err;
  return sms * (per_sm > 0 ? per_sm : 1);
}
