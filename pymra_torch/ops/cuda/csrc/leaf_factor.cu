// Fused MRA leaf factorization for Hopper (sm_90a).
//
// Replaces the two TPU kernels behind pymra_tpu/ops/pallas/linalg.py::
// leaf_factor (K1): _kleaf_logdet_kernel (K1a, the prior) and
// _kleaf_inv_logdet_kernel (K1b, the posterior). For every leaf b of a batch
// of P x P blocks (P <= 64) it computes, in one launch:
//
//   K_leaf = C ⊙ k k^T + diag(1 - k)            (C = C_own, k = knot mask)
//   s      = mean_j |K_leaf[j, j]| + 1          (the scale-relative jitter)
//   ld_prior = 1/2 sum_j log d_j of K_leaf + f_p * jitter * s * I,
//              d_j the downdated pivots (the factor itself is never formed)
//   X = chol((C + A_oo) ⊙ k k^T + diag(1 - k) + f_q * jitter * s * I)^-1
//   ld_post  = sum_j log L_jj of that factor
//
// with f_p, f_q each escalated through factors[0..2] while the member's
// log-pivot sum is non-finite (NaN for a negative pivot, -inf for an exact
// zero). A member that fails all three keeps its NaN outputs.
//
// What bounds it on the card: the N=10^6 leaf level is 16,384 blocks of
// 64 x 64; each block is ~P^3/3 flops for the prior and ~2 P^3/3 for the
// posterior with its inverse, against 3 P^2 floats read and P^2 written —
// about 25 flops per byte, so the column loop (P dependent steps, each a
// shared-memory update and a block barrier) bounds it, not HBM.
//
// Design: one 256-thread block (8 warps) per leaf; the working matrix and
// X live in shared memory with an odd row stride (2 x 16.6 KB at P = 64,
// so six leaves share an SM). Each column step spreads its update over
// rows and lanes: warp w takes rows j+1+w, j+1+w+8, ... and its lanes
// sweep the row's entries — at step j of the posterior, X[i][0..j] and
// S[i][j+1..i], i + 1 contiguous entries; in the prior, S[i][j+1..i]. A
// thread per row (the first version) left short rows idle while the
// longest ran P dependent steps; this mapping keeps every warp on a row
// and needs no index arithmetic. Row entries are contiguous (no bank
// conflicts), column-j reads are broadcasts or stride-odd. The jitter
// scale is a diagonal sum that every thread computes itself (no barrier;
// the TPU version computed it outside the kernel only because Mosaic could
// not relayout the reduction). The working matrix is assembled straight
// from C_own, k and A_oo on every attempt: K_leaf and K_leaf + A_oo never
// exist in global memory. The escalation loops are block-uniform because
// every thread sums the same pivots. Built without fast-math: the
// escalation relies on IEEE sqrtf/logf giving NaN and -inf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;

__global__ void leaf_factor_kernel(const float* __restrict__ c,
                                   const float* __restrict__ kmask,
                                   const float* __restrict__ a_oo,
                                   float jitter,
                                   float* __restrict__ li,
                                   float* __restrict__ ldp,
                                   float* __restrict__ ldq,
                                   float* __restrict__ fp,
                                   float* __restrict__ fq,
                                   int p, float f0, float f1, float f2) {
  extern __shared__ float smem[];
  const int st = p | 1;      // odd stride: a column access hits P banks
  float* s = smem;           // working matrix, lower triangle
  float* x = s + p * st;     // inverse factor
  float* k = x + p * st;     // knot mask
  const int t = threadIdx.x;
  const int warp = t / kWarp, lane = t % kWarp;
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* cb = c + off;
  const float* ab = a_oo + off;
  const float factors[3] = {f0, f1, f2};

  for (int i = t; i < p; i += kThreads) k[i] = kmask[(size_t)blockIdx.x * p + i];
  __syncthreads();
  float sum = 0.f;
  for (int j = 0; j < p; ++j) sum += fabsf(cb[j * p + j] * k[j] + (1.f - k[j]));
  const float jit_eff = jitter * (sum / (float)p + 1.f);

  // ---- prior: pivot-only log-determinant of K_leaf + f_p jit I ----
  float acc = 0.f;
  float fac = f0;
  for (int a = 0; a < 3; ++a) {
    fac = factors[a];
    const float add = jit_eff * fac;
    for (int e = t; e < p * p; e += kThreads) {
      const int i = e / p, col = e - i * p;
      if (col > i) continue;
      float v = cb[e] * (k[i] * k[col]);
      if (col == i) v = (v + (1.f - k[i])) + add;
      s[i * st + col] = v;
    }
    __syncthreads();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float d = s[j * st + j];
      acc += logf(d);
      // trailing triangle j < col <= i
      for (int i = j + 1 + warp; i < p; i += kWarps) {
        const float aij = s[i * st + j] / d;  // one division per row
        for (int col = j + 1 + lane; col <= i; col += kWarp)
          s[i * st + col] -= aij * s[col * st + j];
      }
      __syncthreads();
    }
    acc *= 0.5f;
    if (isfinite(acc)) break;
  }
  if (t == 0) {
    ldp[blockIdx.x] = acc;
    fp[blockIdx.x] = fac;
  }

  // ---- posterior: factor and inverse of K_leaf + A_oo + f_q jit I ----
  for (int a = 0; a < 3; ++a) {
    fac = factors[a];
    const float add = jit_eff * fac;
    for (int e = t; e < p * p; e += kThreads) {
      const int i = e / p, col = e - i * p;
      x[i * st + col] = (col == i) ? 1.f : 0.f;
      if (col > i) continue;
      float v = (cb[e] + ab[e]) * (k[i] * k[col]);
      if (col == i) v = (v + (1.f - k[i])) + add;
      s[i * st + col] = v;
    }
    __syncthreads();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float piv = sqrtf(s[j * st + j]);
      acc += logf(piv);
      // column j of L below the diagonal, row j of X scaled by 1/L_jj
      for (int e = t; e < p; e += kThreads) {
        if (e <= j) x[j * st + e] /= piv;
        else s[e * st + j] /= piv;
      }
      __syncthreads();
      // rows i > j: X[i][q] for q <= j and S[i][q] for j < q <= i
      for (int i = j + 1 + warp; i < p; i += kWarps) {
        const float ci = s[i * st + j];
        for (int q = lane; q <= i; q += kWarp) {
          if (q <= j) x[i * st + q] -= ci * x[j * st + q];
          else s[i * st + q] -= ci * s[q * st + j];
        }
      }
      __syncthreads();
    }
    if (isfinite(acc)) break;
  }
  if (t == 0) {
    ldq[blockIdx.x] = acc;
    fq[blockIdx.x] = fac;
  }
  for (int e = t; e < p * p; e += kThreads) {
    const int i = e / p;
    li[off + e] = x[i * st + e - i * p];
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_leaf_factor(const void* c, const void* kmask,
                                 const void* a_oo, float jitter, void* li,
                                 void* ldp, void* ldq, void* fp, void* fq,
                                 int batch, int p, float f0, float f1,
                                 float f2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = ((size_t)2 * p * (p | 1) + p) * sizeof(float);
  leaf_factor_kernel<<<batch, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)c, (const float*)kmask, (const float*)a_oo, jitter,
      (float*)li, (float*)ldp, (float*)ldq, (float*)fp, (float*)fq, p, f0,
      f1, f2);
  return (int)cudaGetLastError();
}
