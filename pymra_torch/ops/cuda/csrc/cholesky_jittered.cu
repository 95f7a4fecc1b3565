// Batched jittered Cholesky with per-member escalation, for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_chol_jittered_kernel
// (K2). For every member b of a [B, P, P] float32 batch it factors
// A_b + f * jit_b * I with f = factors[0]; a member whose log-pivot sum is
// non-finite (NaN for a negative pivot, -inf for an exact zero) is factored
// again at the next factor. Members that succeed keep their first result; a
// member that fails all attempts keeps the NaN factor of its last one.
//
// What bounds it on the card: the main path calls it on many tiny matrices
// (r x r interior blocks, r = 4 or 8, B up to 4096), where the work is a few
// hundred flops per matrix and the cost is launch overhead plus one read and
// one write of the batch. At P = 64 it is bound by the serial column loop:
// P steps, each a shared-memory rank-1 downdate.
//
// Design: one warp per matrix, lane i owning rows i and i + 32. The matrix
// lives in shared memory with a padded row stride (P + 1) so that the lanes
// of a column access fall in different banks. The column loop needs only
// __syncwarp: no block-wide barrier, and a warp that finishes its member
// early (or escalates) never stalls another. The escalation loop is per
// warp, so a bad member re-reads only its own matrix from global memory.
// The factor is formed in place in the lower triangle; the upper triangle of
// the output is written as zeros. Built without fast-math: the escalation
// relies on IEEE sqrtf/logf giving NaN and -inf.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__global__ void chol_jittered_kernel(const float* __restrict__ a,
                                     const float* __restrict__ jit,
                                     float* __restrict__ l,
                                     float* __restrict__ ld,
                                     float* __restrict__ fsel,
                                     int batch, int p,
                                     float f0, float f1, float f2) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int member = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (member >= batch) return;
  const int st = p + 1;
  float* s = smem + (size_t)warp * p * st;
  const float* src = a + (size_t)member * p * p;
  const float js = jit[member];
  const float factors[3] = {f0, f1, f2};

  float acc = 0.f;
  float fac = f0;
  for (int t = 0; t < 3; ++t) {
    fac = factors[t];
    const float add = js * fac;
    for (int e = lane; e < p * p; e += kWarp) {
      const int i = e / p, k = e - i * p;
      float v = src[e];
      if (i == k) v += add;
      s[i * st + k] = v;
    }
    __syncwarp();
    acc = 0.f;
    for (int j = 0; j < p; ++j) {
      const float piv = sqrtf(s[j * st + j]);
      acc += logf(piv);
      __syncwarp();  // every lane has read the pivot before it is scaled
      for (int i = j + lane; i < p; i += kWarp) s[i * st + j] /= piv;
      __syncwarp();
      for (int i = j + 1 + lane; i < p; i += kWarp) {
        const float ci = s[i * st + j];
        for (int k = j + 1; k <= i; ++k) s[i * st + k] -= ci * s[k * st + j];
      }
      __syncwarp();
    }
    // acc is warp-uniform: every lane summed the same pivots
    if (isfinite(acc)) break;
  }

  float* dst = l + (size_t)member * p * p;
  for (int e = lane; e < p * p; e += kWarp) {
    const int i = e / p, k = e - i * p;
    dst[e] = (k <= i) ? s[i * st + k] : 0.f;
  }
  if (lane == 0) {
    ld[member] = acc;
    fsel[member] = fac;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_cholesky_jittered(const void* a, const void* jit,
                                       void* l, void* ld, void* f,
                                       int batch, int p, float f0, float f1,
                                       float f2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp = (size_t)p * (p + 1) * sizeof(float);
  int warps = (int)((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int blocks = (batch + warps - 1) / warps;
  chol_jittered_kernel<<<blocks, warps * kWarp, warps * per_warp,
                         (cudaStream_t)stream>>>(
      (const float*)a, (const float*)jit, (float*)l, (float*)ld, (float*)f,
      batch, p, f0, f1, f2);
  return (int)cudaGetLastError();
}
