// Sorting, selection and reductions over one row held in registers,
// shared by K2 (top_diagonals.cu), K14 (rank_hits.cu) and K16
// (select_pairs.cu).
//
// A row is handled by NW warps.  NW == 1: one warp per row, and a CTA may
// hold several rows, one per warp; nothing here then touches another warp
// or waits on the block (row_sync is __syncwarp).  NW > 1: the CTA is
// one row of NW warps, and row_sync is __syncthreads.  Thread t of the
// row (its lane when NW == 1) holds the row's elements t * KPL .. t *
// KPL + KPL - 1 in registers ("blocked" layout), so the row is N = 32 *
// KPL * NW elements long.
//
// row_sort is a bitonic network over those N registers: a stage whose
// partner distance j is below KPL exchanges two registers of one thread,
// one below 32 * KPL a register with another lane's (__shfl_xor_sync),
// and only a stage across warps goes through shared memory (xbuf, N
// elements; two block barriers).  The loops run over constant bounds so
// that every register index is known at compile time and the keys stay
// in registers.
#pragma once

#include "common.cuh"

template <int NW>
__device__ __forceinline__ void row_sync() {
  if (NW == 1)
    __syncwarp();
  else
    __syncthreads();
}

// The thread's index within its row.
template <int NW>
__device__ __forceinline__ int row_thread() {
  return NW == 1 ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
}

template <typename T>
__device__ __forceinline__ T row_lesser(T a, T b) {
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T row_greater(T a, T b) {
  return a < b ? b : a;
}

// Ascending sort of the row's N = 32 * KPL * NW keys (KPL a power of two);
// xbuf (N keys of shared memory) is used only when NW > 1.
template <typename T, int KPL, int NW>
__device__ __forceinline__ void row_sort(T (&v)[KPL], T* xbuf) {
  constexpr int kLogKpl = KPL == 1 ? 0 : KPL == 2 ? 1 : KPL == 4 ? 2
                          : KPL == 8 ? 3 : KPL == 16 ? 4 : KPL == 32 ? 5 : 6;
  constexpr int kLogNw = NW == 1 ? 0 : NW == 2 ? 1 : NW == 4 ? 2 : NW == 8 ? 3
                         : NW == 16 ? 4 : 5;
  static_assert((1 << kLogKpl) == KPL && (1 << kLogNw) == NW,
                "KPL and NW must be powers of two (KPL <= 64, NW <= 32)");
  constexpr int kLogN = 5 + kLogKpl + kLogNw;
  const int t = row_thread<NW>();
#pragma unroll
  for (int lk = 1; lk <= kLogN; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int k = 1 << lk, j = 1 << lj;
      if (lj < kLogKpl) {
        // partner in this thread's registers
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          if ((r & j) == 0) {
            const bool up = ((t * KPL + r) & k) == 0;
            const T a = v[r], b = v[r | j];
            if ((b < a) == up) {
              v[r] = b;
              v[r | j] = a;
            }
          }
        }
      } else if (lj < kLogKpl + 5) {
        // partner in another lane of this warp, same register
        const int lm = j >> kLogKpl;
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          const int e = t * KPL + r;
          const T y = __shfl_xor_sync(GSNAP_FULL_MASK, v[r], lm);
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          v[r] = keep_min ? row_lesser(v[r], y) : row_greater(v[r], y);
        }
      } else {
        // partner in another warp: through shared memory
#pragma unroll
        for (int r = 0; r < KPL; ++r) xbuf[t * KPL + r] = v[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
          const int e = t * KPL + r;
          const T y = xbuf[e ^ j];
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          v[r] = keep_min ? row_lesser(v[r], y) : row_greater(v[r], y);
        }
        __syncthreads();
      }
    }
  }
}

// Sum of v over the row.  red: 32 ints of shared memory (NW > 1 only).
template <int NW>
__device__ __forceinline__ int row_sum(int v, int* red) {
  v = __reduce_add_sync(GSNAP_FULL_MASK, v);
  if (NW == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < NW; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Minimum (max_ false) or maximum (max_ true) of v over the row.
template <int NW>
__device__ __forceinline__ uint32_t row_extreme(uint32_t v, bool max_,
                                                int* red) {
  v = max_ ? __reduce_max_sync(GSNAP_FULL_MASK, v)
           : __reduce_min_sync(GSNAP_FULL_MASK, v);
  if (NW == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (int)v;
  __syncthreads();
  uint32_t m = v;
  for (int w = 0; w < NW; ++w)
    m = max_ ? row_greater(m, (uint32_t)red[w]) : row_lesser(m, (uint32_t)red[w]);
  __syncthreads();
  return m;
}

// Sum of v over the row's threads before this one.
template <int NW>
__device__ __forceinline__ int row_exclusive_sum(int v, int* red) {
  const int lane = threadIdx.x & 31;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(GSNAP_FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  x -= v;
  if (NW == 1) return x;
  const int w = threadIdx.x >> 5;
  if (lane == 31) red[w] = x + v;
  __syncthreads();
  for (int u = 0; u < w; ++u) x += red[u];
  __syncthreads();
  return x;
}

// Minimum of v over the row's threads after this one (none: `none`).
template <int NW>
__device__ __forceinline__ int row_later_min(int v, int none, int* red) {
  const int lane = threadIdx.x & 31;
  int x = v;  // inclusive minimum over lanes >= lane
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(GSNAP_FULL_MASK, x, off);
    if (lane + off < 32) x = row_lesser(x, y);
  }
  int after = __shfl_down_sync(GSNAP_FULL_MASK, x, 1);
  if (lane == 31) after = none;
  if (NW == 1) return after;
  const int w = threadIdx.x >> 5;
  if (lane == 0) red[w] = x;
  __syncthreads();
  for (int u = w + 1; u < NW; ++u) after = row_lesser(after, red[u]);
  __syncthreads();
  return after;
}

// Number of the row's keys at or below x, where a key is compared in
// full (shift 0) or by its high bits (key >> shift; x below 2^(32 -
// shift), so that key >> shift <= x is key <= x << shift | low ones).
template <int KPL, int NW>
__device__ __forceinline__ int row_count_at_most(const uint32_t (&key)[KPL],
                                                 uint32_t x, int shift,
                                                 int* red) {
  const uint32_t top = x << shift | ((1u << shift) - 1u);
  int c = 0;
#pragma unroll
  for (int r = 0; r < KPL; ++r) c += key[r] <= top;
  return row_sum<NW>(c, red);
}

// Smallest x in [lo, hi] with row_count_at_most(x) >= m (hi satisfies
// it): a bisection whose every step is one count over the row.
template <int KPL, int NW>
__device__ __forceinline__ uint32_t row_lowest_reaching(
    const uint32_t (&key)[KPL], uint32_t lo, uint32_t hi, int shift, int m,
    int* red) {
  while (lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (row_count_at_most<KPL, NW>(key, mid, shift, red) >= m)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Ascending bitonic sort of the s (a power of two) keys at sel, in the
// row's shared memory, by its T threads (t the row thread).
template <int NW>
__device__ __forceinline__ void row_sort_shared(uint32_t* sel, int s, int t,
                                                int T) {
  for (int kk = 2; kk <= s; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = t; i < s; i += T) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint32_t x = sel[i], y = sel[ixj];
          if ((y < x) == ((i & kk) == 0)) {
            sel[i] = y;
            sel[ixj] = x;
          }
        }
      }
      row_sync<NW>();
    }
  }
}
