// Shared definitions for the port's CUDA kernels (sm_90a).
//
// Every C entry point launches one kernel on the stream it is given,
// does not synchronise, allocates nothing (the Python wrapper passes
// outputs and scratch from torch.empty) and returns cudaGetLastError().
// uint32 genome/index words arrive as int32 tensors holding the same
// bits and are read as uint32_t here; diagonals are int64 tensors
// holding uint32 values, with 0xFFFFFFFF meaning "no diagonal".
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GSNAP_FULL_MASK 0xFFFFFFFFu

static constexpr int64_t GSNAP_INVALID_DIAG = 0xFFFFFFFFll;
static constexpr int GSNAP_BIG_SCORE = 1000000;

static inline int gsnap_blocks(int64_t threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// Block-wide helpers of the GMAP kernels (K9, K12).  Every thread of
// the block must call them; they synchronise the block.

__device__ __forceinline__ int64_t gmap_max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// Maximum of v over the block (blockDim.x a multiple of 32, <= 1024).
__device__ __forceinline__ int64_t gmap_block_max(int64_t v) {
  __shared__ int64_t s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = gmap_max64(v, (int64_t)__shfl_xor_sync(GSNAP_FULL_MASK, v, off));
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? s_warp[lane] : INT64_MIN;
  for (int off = 16; off > 0; off >>= 1)
    v = gmap_max64(v, (int64_t)__shfl_xor_sync(GSNAP_FULL_MASK, v, off));
  return v;
}

// Exclusive prefix sum of one int per thread in thread order; *total
// receives the block's sum (int32 arithmetic wraps like JAX's cumsum).
__device__ __forceinline__ int32_t gmap_block_exclusive_sum(int32_t v,
                                                            int32_t* total) {
  __shared__ uint32_t s_warp[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = (uint32_t)v;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(GSNAP_FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = 0;
    const int nwarps = blockDim.x >> 5;
    for (int w = 0; w < nwarps; ++w) {
      const uint32_t t = s_warp[w];
      s_warp[w] = run;
      run += t;
    }
    s_warp[32] = run;
  }
  __syncthreads();
  *total = (int32_t)s_warp[32];
  return (int32_t)(s_warp[warp] + x - (uint32_t)v);
}

// Ascending bitonic sort of n (a power of two) 64-bit keys in place, in
// shared or global memory (the barriers make either visible to the block).
__device__ __forceinline__ void gmap_bitonic_sort(uint64_t* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = a[i], y = a[ixj];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Key whose maximum is the largest value, and among equal values the
// smallest index: JAX's first-maximum argmax over a block.
__device__ __forceinline__ int64_t gmap_first_max_key(int32_t v, int32_t idx) {
  return (int64_t)v * 4294967296ll + (int64_t)(0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ int32_t gmap_key_value(int64_t key) {
  const int64_t low = key & 0xFFFFFFFFll;
  return (int32_t)((key - low) / 4294967296ll);
}

__device__ __forceinline__ int32_t gmap_key_index(int64_t key) {
  return (int32_t)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFll));
}
