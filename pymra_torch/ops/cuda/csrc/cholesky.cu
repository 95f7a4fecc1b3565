// Batched plain Cholesky factorization for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_kernel (K4,
// the public `cholesky`). For every member b of a [B, P, P] float32 batch
// (P <= 64) it writes the lower factor L with column j equal to
// A'[j:, j] / sqrt(A'[j, j]) (A' the downdated matrix, the diagonal
// included), zeros above the diagonal. No jitter and no escalation: a
// negative or zero pivot turns its column and the trailing block NaN, the
// same pattern as the plain twin `cholesky_ref` and the JAX kernel. The
// MRA sweep calls it in the backward pass of the leaf stage, to refactor
// the prior block K_leaf + fp * jitter * s * I at its selected factor.
//
// What bounds it on the card: at the N=10^6 leaf shape (16,384 blocks of
// 64 x 64) it reads the lower triangle, 136 MB, and writes the whole
// factor, 268 MB (0.12 ms at 3.35 TB/s), for ~1.4 GFLOP (P^3/3 per block,
// 0.02 ms at 67 TFLOP/s), so HBM is the roofline bound. The first version is bound by the serial column loop
// instead: P dependent steps per block, each a shared-memory update of the
// trailing triangle and a block barrier.
//
// Design: the row layout of leaf_factor.cu (K1): one 256-thread block per
// matrix, the matrix in shared memory with an odd row stride (P | 1), warp
// w updating rows j+1+w, j+1+w+8, ... of the trailing triangle with its
// lanes sweeping the row (contiguous, no bank conflicts; column-j reads
// are broadcasts). The scaled diagonal is kept in its own array, so the
// pivot entry every thread reads is never written during the step. Built
// without fast-math: NaN must come out of sqrtf of a negative pivot.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;

__global__ void cholesky_kernel(const float* __restrict__ a,
                                float* __restrict__ l, int p) {
  extern __shared__ float smem[];
  const int st = p | 1;
  float* s = smem;          // working matrix, lower triangle
  float* dg = s + p * st;   // L_jj = A'_jj / sqrt(A'_jj)
  const int t = threadIdx.x;
  const int warp = t / kWarp, lane = t % kWarp;
  const size_t off = (size_t)blockIdx.x * p * p;

  for (int e = t; e < p * p; e += kThreads) {
    const int i = e / p, col = e - i * p;
    if (col <= i) s[i * st + col] = a[off + e];
  }
  __syncthreads();
  for (int j = 0; j < p; ++j) {
    const float d = s[j * st + j];
    const float piv = sqrtf(d);
    // column j below the diagonal and the diagonal itself, scaled
    for (int i = j + t; i < p; i += kThreads) {
      if (i == j) dg[j] = d / piv;
      else s[i * st + j] /= piv;
    }
    __syncthreads();
    // trailing triangle j < col <= i
    for (int i = j + 1 + warp; i < p; i += kWarps) {
      const float ci = s[i * st + j];
      for (int col = j + 1 + lane; col <= i; col += kWarp)
        s[i * st + col] -= ci * s[col * st + j];
    }
    __syncthreads();
  }
  for (int e = t; e < p * p; e += kThreads) {
    const int i = e / p, col = e - i * p;
    l[off + e] = col < i ? s[i * st + col] : (col == i ? dg[i] : 0.f);
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_cholesky(const void* a, void* l, int batch, int p,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = ((size_t)p * (p | 1) + p) * sizeof(float);
  cholesky_kernel<<<batch, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)a, (float*)l, p);
  return (int)cudaGetLastError();
}
