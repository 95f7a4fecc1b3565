// Batched jittered inverse Cholesky factor and log-determinant with
// per-member escalation, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// pymra_tpu/ops/pallas/linalg.py::_chol_inv_logdet_kernel (K7, the public
// `cholesky_inv_logdet`). For every member b of a [B, P, P] float32 batch
// (P <= 64) it writes
//
//   X_b  = chol(A_b + f jit_b I)^-1   (lower triangular, zeros above)
//   ld_b = sum_j log L_jj
//
// with the forward-substitution inverse interleaved with the right-looking
// factorization: once column j of L is formed, row j of X is final. The
// factor itself never reaches global memory. f escalates through
// factors[0..2] while ld_b is non-finite (NaN for a negative pivot, -inf
// for an exact zero); a member that fails all three keeps its NaN outputs
// and reports the last factor. The MRA sweep calls it for the posterior
// block K_leaf + A_oo of leaves with 16 <= P <= 64 and dense measurement
// error, where K1's in-kernel K_leaf assembly does not apply.
//
// What bounds it on the card: per member it reads the lower triangle and
// writes P^2 + 2 floats, against ~2 P^3/3 flops (factor and inverse) —
// about P/9 flops per byte; this version is bound by the serial column
// loop, P dependent steps with two block barriers each.
//
// Design: the shared-memory column loop K1's posterior had before
// chol_tile.cuh, on a plain input: one block per member, the working matrix
// and X in shared memory with an odd row stride (2 x 16.6 KB at P = 64). Step
// j scales column j of L and row j of X by 1/L_jj, then warp w takes rows i =
// j+1+w, j+1+w+W, ... and its lanes sweep the i + 1 contiguous entries
// X[i][0..j] and S[i][j+1..i]. The block has W = ceil(P / 8) warps (at most
// 8). The escalation loop is block-uniform (every thread sums the same
// pivots). Built without fast-math: the escalation relies on IEEE sqrtf/logf
// giving NaN and -inf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;

__global__ void chol_inv_logdet_kernel(const float* __restrict__ a,
                                       const float* __restrict__ jit,
                                       float* __restrict__ xo,
                                       float* __restrict__ ld,
                                       float* __restrict__ fsel, int p,
                                       float f0, float f1, float f2) {
  extern __shared__ float smem[];
  const int st = p | 1;
  float* s = smem;        // working matrix, lower triangle
  float* x = s + p * st;  // inverse factor
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t / kWarp, lane = t % kWarp, nw = nt / kWarp;
  const size_t off = (size_t)blockIdx.x * p * p;
  const float* src = a + off;
  const float js = jit[blockIdx.x];
  const float factors[3] = {f0, f1, f2};

  float acc = 0.f;
  float fac = f0;
  for (int at = 0; at < 3; ++at) {
    fac = factors[at];
    const float add = js * fac;
    for (int e = t; e < p * p; e += nt) {
      const int i = e / p, col = e - i * p;
      x[i * st + col] = (col == i) ? 1.f : 0.f;
      if (col > i) continue;
      float v = src[e];
      if (col == i) v += add;
      s[i * st + col] = v;
    }
    __syncthreads();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float piv = sqrtf(s[j * st + j]);
      acc += logf(piv);
      // column j of L below the diagonal, row j of X scaled by 1/L_jj
      for (int e = t; e < p; e += nt) {
        if (e <= j) x[j * st + e] /= piv;
        else s[e * st + j] /= piv;
      }
      __syncthreads();
      // rows i > j: X[i][q] for q <= j and S[i][q] for j < q <= i
      for (int i = j + 1 + warp; i < p; i += nw) {
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
    ld[blockIdx.x] = acc;
    fsel[blockIdx.x] = fac;
  }
  for (int e = t; e < p * p; e += nt) {
    const int i = e / p;
    xo[off + e] = x[i * st + e - i * p];
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_chol_inv_logdet(const void* a, const void* jit, void* x,
                                     void* ld, void* f, int batch, int p,
                                     float f0, float f1, float f2,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int warps = (p + 7) / 8;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t shmem = (size_t)2 * p * (p | 1) * sizeof(float);
  chol_inv_logdet_kernel<<<batch, warps * kWarp, shmem,
                           (cudaStream_t)stream>>>(
      (const float*)a, (const float*)jit, (float*)x, (float*)ld, (float*)f,
      p, f0, f1, f2);
  return (int)cudaGetLastError();
}
