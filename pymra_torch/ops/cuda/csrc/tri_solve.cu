// Batched triangular solve with a lower factor for Hopper (sm_90a).
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
// subtracts. The MRA sweep's gradient calls it twice in the Cholesky
// pullback of every jittered interior factorization (K2's backward), on
// r x r blocks with r = 4 or 8 and Q = r.
//
// What bounds it on the card: the main-path shapes are tiny ([<=4096, 8,
// 8] x [.., 8, 8] is 2.7 MB in and out with L's lower triangle, a few
// hundred flops a member), so a launch costs more than its bytes (0.8 us
// at 3.35 TB/s) or its flops.
//
// Design: one thread per right-hand-side column runs the whole
// substitution for it, with the member's L and its x in shared memory;
// the threads of one member read the same L entry at the same time (a
// broadcast) and their own consecutive x entries. A block packs as many
// members as 256 threads and 48 KB of shared memory allow (32 members at
// P = Q = 8), so the tiny batches still fill whole warps. Built without
// fast-math.

#include <cuda_runtime.h>

namespace {

__global__ void tri_solve_kernel(const float* __restrict__ l,
                                 const float* __restrict__ b,
                                 float* __restrict__ x, int batch, int p,
                                 int q, int transpose) {
  extern __shared__ float smem[];
  const int st = p | 1;
  const int per = p * st + p * q;  // floats per member: L, then x
  const int mats = blockDim.x / q;
  const int local = threadIdx.x / q;
  const int c = threadIdx.x % q;
  const int first = blockIdx.x * mats;
  const int nmat = min(mats, batch - first);

  for (int e = threadIdx.x; e < nmat * p * p; e += blockDim.x) {
    const int m = e / (p * p), r = e - m * p * p;
    const int i = r / p, k = r - i * p;
    smem[m * per + i * st + k] = l[(size_t)first * p * p + e];
  }
  for (int e = threadIdx.x; e < nmat * p * q; e += blockDim.x) {
    const int m = e / (p * q), r = e - m * p * q;
    smem[m * per + p * st + r] = b[(size_t)first * p * q + e];
  }
  __syncthreads();
  if (local >= nmat) return;
  const float* lm = smem + local * per;
  float* xm = smem + local * per + p * st;
  float* out = x + (size_t)(first + local) * p * q;
  if (!transpose) {
    for (int i = 0; i < p; ++i) {
      float acc = xm[i * q + c];
      for (int k = 0; k < i; ++k) acc -= lm[i * st + k] * xm[k * q + c];
      const float v = acc / lm[i * st + i];
      xm[i * q + c] = v;
      out[i * q + c] = v;
    }
  } else {
    for (int i = p - 1; i >= 0; --i) {
      float acc = xm[i * q + c];
      for (int k = p - 1; k > i; --k) acc -= lm[k * st + i] * xm[k * q + c];
      const float v = acc / lm[i * st + i];
      xm[i * q + c] = v;
      out[i * q + c] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
// The wrapper guarantees q <= 1024 and one member's L and x within 48 KB.
extern "C" int pymra_tri_solve(const void* l, const void* b, void* x,
                               int batch, int p, int q, int transpose,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t per = ((size_t)p * (p | 1) + (size_t)p * q) * sizeof(float);
  int mats = (int)((48 * 1024) / per);
  const int by_threads = q >= 256 ? 1 : 256 / q;
  mats = mats < 1 ? 1 : (mats > by_threads ? by_threads : mats);
  const int blocks = (batch + mats - 1) / mats;
  tri_solve_kernel<<<blocks, mats * q, mats * per, (cudaStream_t)stream>>>(
      (const float*)l, (const float*)b, (float*)x, batch, p, q, transpose);
  return (int)cudaGetLastError();
}
