// Sub-warp groups for the batched small-matrix kernels, Hopper (sm_90a).
//
// A member [P, P] with P <= kMaxP = 8 (the interior blocks of the MRA
// sweep, r = 4 or 8) is owned by a group of lanes sized from G = 4 or 8,
// the next power of two >= P (at least 4). In K2 (cholesky_jittered.cu)
// lane i of a group of G holds row i of the member in registers, G
// entries, fully unrolled, and the column steps exchange values with
// __shfl_sync within the group; the Cholesky pullback (tri_solve.cu) gives
// each lane one or two entries instead. Wider members take K2's
// register-tiled core (chol_tile.cuh), the pullback its pullback mode.
// A warp holds 32 / G members; lanes i >= P and members past the batch
// ride along with zeros (every shuffle names the whole warp) and store
// nothing.
//
// A warp's members are contiguous in device memory, so the warp copies
// them between device memory and a per-warp shared-memory tile with
// consecutive lanes on consecutive addresses (coalesced), and each lane
// reads its row or column from the tile. In the tile member g's entry
// (i, k) sits at (g * G + i) * (G + 1) + k: the odd row stride keeps both
// a lane's row reads and its column reads free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

namespace subwarp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
// threads of one block of a group kernel
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;

// widest member of the group kernels
constexpr int kMaxP = 8;

// lanes per member: the next power of two >= p, at least 4 (p <= kMaxP)
inline int group_size(int p) { return p <= 4 ? 4 : 8; }

// make `device` current unless it already is (the common case costs one
// cudaGetDevice, no context switch)
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// where the warp's members start, how many of them are in the batch
struct WarpSlice {
  int first;  // first member of the warp
  int count;  // members of the warp inside the batch (0 .. 32 / G)
};

template <int G>
__device__ inline WarpSlice warp_slice(int batch) {
  const int per_warp = kWarp / G;
  const int first =
      (blockIdx.x * kWarps + (int)threadIdx.x / kWarp) * per_warp;
  const int left = batch - first;
  return {first, left < 0 ? 0 : (left < per_warp ? left : per_warp)};
}

// coalesced copy of `count` contiguous [p, p] members into the tile, then
// a warp barrier: at most 32 G floats, so at most G a lane, all in flight
// at once
template <int G>
__device__ inline void tile_load(float* tile, const float* __restrict__ src,
                                 int count, int p, int lane) {
  const int pp = p * p;
  float v[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int e = lane + u * kWarp;
    if (e < count * pp) v[u] = src[e];
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int e = lane + u * kWarp;
    if (e < count * pp) {
      const int g = e / pp, r = e - g * pp, i = r / p, k = r - i * p;
      tile[(g * G + i) * (G + 1) + k] = v[u];
    }
  }
  __syncwarp();
}

// coalesced copy of the tile's `count` [p, p] members to device memory
template <int G>
__device__ inline void tile_store(const float* tile, float* __restrict__ dst,
                                  int count, int p, int lane) {
  __syncwarp();
  const int pp = p * p, n = count * pp;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int e = lane + u * kWarp;
    if (e < n) {
      const int g = e / pp, r = e - g * pp, i = r / p, k = r - i * p;
      dst[e] = tile[(g * G + i) * (G + 1) + k];
    }
  }
}

// v[i] for a lane-dependent i without dynamic register indexing
template <int G>
__device__ inline float pick(const float (&v)[G], int i) {
  float out = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k == i) out = v[k];
  return out;
}

}  // namespace subwarp
