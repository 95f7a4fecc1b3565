// Batched jittered log-determinant with per-member escalation, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_logdet_kernel
// (K6, the public `cholesky_logdet`). For every member b of a [B, P, P]
// float32 batch (P <= 64) it computes
//
//   ld_b = 1/2 sum_j log d_j,  d_j the downdated pivots of A_b + f jit_b I,
//
// which is sum_j log L_jj of the Cholesky factor without a square root and
// without the factor ever being written. f escalates through factors[0..2]
// while the member's sum is non-finite (NaN for a negative pivot, -inf for
// an exact zero); a member that fails all three keeps its NaN sum and
// reports the last factor. The MRA sweep calls it for the prior
// log-determinant of leaves that do not take the fused K1 (dense
// measurement error, P < 16).
//
// What bounds it on the card: per member it reads the lower triangle,
// P(P+1)/2 floats, and writes two, against ~P^3/3 flops — about P/6 flops
// per byte, so at P = 49 or 64 the float32 rate, not HBM, would bound a
// perfect kernel; this one is bound by the serial column loop, P dependent
// steps each ending in a block barrier.
//
// Design: the shared-memory column loop K1's prior had before chol_tile.cuh,
// on a plain input: one block per member, the lower triangle in shared memory
// with an odd row stride; at step j warp w updates rows j+1+w, j+1+w+W, ... of
// the trailing triangle with its lanes sweeping the row, dividing once per
// row. The block has W = ceil(P / 8) warps (at most 8), so narrow members do
// not hold idle warps. The escalation loop is block-uniform: every thread sums
// the same pivots. Built without fast-math: the escalation relies on IEEE logf
// giving NaN and -inf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;

__global__ void chol_logdet_kernel(const float* __restrict__ a,
                                   const float* __restrict__ jit,
                                   float* __restrict__ ld,
                                   float* __restrict__ fsel, int p,
                                   float f0, float f1, float f2) {
  extern __shared__ float smem[];
  const int st = p | 1;  // odd stride: a column access hits P banks
  float* s = smem;       // working matrix, lower triangle
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t / kWarp, lane = t % kWarp, nw = nt / kWarp;
  const float* src = a + (size_t)blockIdx.x * p * p;
  const float js = jit[blockIdx.x];
  const float factors[3] = {f0, f1, f2};

  float acc = 0.f;
  float fac = f0;
  for (int at = 0; at < 3; ++at) {
    fac = factors[at];
    const float add = js * fac;
    for (int e = t; e < p * p; e += nt) {
      const int i = e / p, col = e - i * p;
      if (col > i) continue;
      float v = src[e];
      if (col == i) v += add;
      s[i * st + col] = v;
    }
    __syncthreads();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float d = s[j * st + j];
      acc += logf(d);
      // trailing triangle j < col <= i; column j is read, never written
      for (int i = j + 1 + warp; i < p; i += nw) {
        const float aij = s[i * st + j] / d;
        for (int col = j + 1 + lane; col <= i; col += kWarp)
          s[i * st + col] -= aij * s[col * st + j];
      }
      __syncthreads();
    }
    acc *= 0.5f;
    if (isfinite(acc)) break;
  }
  if (t == 0) {
    ld[blockIdx.x] = acc;
    fsel[blockIdx.x] = fac;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_chol_logdet(const void* a, const void* jit, void* ld,
                                 void* f, int batch, int p, float f0,
                                 float f1, float f2, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int warps = (p + 7) / 8;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t shmem = (size_t)p * (p | 1) * sizeof(float);
  chol_logdet_kernel<<<batch, warps * kWarp, shmem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)jit, (float*)ld, (float*)f, p, f0, f1,
      f2);
  return (int)cudaGetLastError();
}
