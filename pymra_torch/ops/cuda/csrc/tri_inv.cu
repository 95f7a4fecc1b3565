// Batched explicit inverse of lower-triangular matrices for Hopper (sm_90a).
//
// Replaces the TPU kernel pymra_tpu/ops/pallas/linalg.py::_tri_inv_kernel
// (K3, the public `triangular_inverse_lower`). For every member of a
// [B, P, P] float32 batch of lower factors (P <= 64) it writes X = L^-1 by
// forward substitution against the identity:
//
//   X[i][c] = (delta_ic - sum_{k<i} L[i][k] X[k][c]) / L[i][i],
//
// the k-sum in ascending order, the same operations in the same order as the
// plain twin `triangular_inverse_lower_ref` (which subtracts row k's
// multiple for k = 0, 1, ... and divides last). The MRA sweep calls it in
// the backward pass of the leaf stage, to invert the prior block's factor
// refactored at its selected jitter (the prior pullback needs K_p^-1).
//
// What bounds it on the card: at 16,384 blocks of 64 x 64 it reads the
// lower triangle, 136 MB, and writes the whole inverse, 268 MB (0.12 ms
// at 3.35 TB/s), for ~1.4 GFLOP (P^3/3 per block), so HBM is the
// roofline bound. The substitution is a serial chain
// of P rows per column.
//
// Design: the columns of X are independent, so one thread owns a column c
// and runs the whole substitution for it, with L in shared memory (odd row
// stride) and its column of X in shared memory beside it (consecutive
// threads touch consecutive addresses: no bank conflicts). Every thread of
// a matrix walks the same (i, k) sequence, reading the same L[i][k] at the
// same time — a broadcast — and no thread branches on its column: the
// entries above the diagonal of X are exact zeros, so their terms change
// nothing (0 - L*0 = 0) and the loop stays uniform. Threads of a matrix
// are a whole number of warps (32 for P <= 32, else 64), and a block
// holds several matrices so that small-P batches still fill the SMs. A
// thread writes X[i][c] to global memory as soon as it has it; for a fixed
// i the threads of a matrix write one contiguous row. Built without
// fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__global__ void tri_inv_kernel(const float* __restrict__ l,
                               float* __restrict__ x, int batch, int p,
                               int tpm) {
  extern __shared__ float smem[];
  const int st = p | 1;
  const int per = p * st;  // floats per matrix, for L and for X
  const int mats = blockDim.x / tpm;
  const int local = threadIdx.x / tpm;
  const int c = threadIdx.x % tpm;
  const int first = blockIdx.x * mats;
  float* ls = smem;              // mats x [P, st] lower factors
  float* xs = smem + mats * per; // mats x [P, st] inverse columns

  // cooperative, coalesced load of this block's factors
  const int nmat = min(mats, batch - first);
  for (int e = threadIdx.x; e < nmat * p * p; e += blockDim.x) {
    const int m = e / (p * p), r = e - m * p * p;
    const int i = r / p, k = r - i * p;
    ls[m * per + i * st + k] = l[(size_t)first * p * p + e];
  }
  __syncthreads();
  const int member = first + local;
  if (member >= batch || c >= p) return;
  const float* lm = ls + local * per;
  float* xm = xs + local * per;
  float* out = x + (size_t)member * p * p;
  for (int i = 0; i < p; ++i) {
    float acc = (i == c) ? 1.f : 0.f;
    for (int k = 0; k < i; ++k) acc -= lm[i * st + k] * xm[k * st + c];
    const float v = acc / lm[i * st + i];
    xm[i * st + c] = v;
    out[i * p + c] = v;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int pymra_tri_inv(const void* l, void* x, int batch, int p,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tpm = p <= kWarp ? kWarp : 2 * kWarp;
  const size_t per = (size_t)2 * p * (p | 1) * sizeof(float);
  int mats = (int)((48 * 1024) / per);
  mats = mats < 1 ? 1 : (mats > 256 / tpm ? 256 / tpm : mats);
  const int blocks = (batch + mats - 1) / mats;
  tri_inv_kernel<<<blocks, mats * tpm, mats * per, (cudaStream_t)stream>>>(
      (const float*)l, (float*)x, batch, p, tpm);
  return (int)cudaGetLastError();
}
