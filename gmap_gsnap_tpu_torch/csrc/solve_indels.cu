// Kernel K4: middle insertions and deletions between diagonal pairs.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _solve_indels (:383)
// (solve_middle_insertion / solve_middle_deletion, stage1hr.c:4180,
// 4330).  For each (read, pair) of diagonals i, j and each split s =
// 0..L it forms
//     total(s) = pref_i[s] + (pref_j[len] - pref_j[min(s + shift, L)])
// (shift = 0 for a deletion, the insertion length otherwise).  A split
// is a candidate only at a mismatch of the left piece (s) or of the
// right piece (s + shift - 1, where 1 <= s + shift <= L), and only in
// [min_end, hi - min_end]; the winner is the first minimum of (total,
// s), the key total * radix + s.  The int32 and uint32 wraparound of the
// bounds and the diagonal differences are reproduced, so invalid pairs
// come out as in JAX too: every pair writes is_del, left, right and
// nmm1 = pref_i[min(split, L)], with the split of GSNAP_BIG_SCORE where
// there is no candidate.
//
// Bound: bytes — the mm rows that a read's pairs name, once a read
// (L bytes each), the pairs, the diagonals and the outputs (~0.005 ms at
// 4096 reads x 16 pairs, L = 100, on the H100).  The pref rows are not
// read: mm determines them.  The design this one replaces (a warp a
// pair, its lanes loading mm_i[s], mm_j[s + shift - 1], pref_i[s] and
// pref_j[s + shift] at every split, ~4 loads x 101 positions a pair,
// rows that several pairs of a read name read again by each) took
// 0.0603 ms there.
//
// Design: a CTA takes up to kMaxReads reads.
//   1. The rows the read's pairs name are marked, then numbered in row
//      order (a warp a read, by ballots).
//   2. Each such row is read once with 16-byte loads (the aligned
//      chunks covering it) and packed to bits, 16 a chunk (a multiply
//      gathers 8 bytes' low bits), into shared memory; its words are
//      then funnel-shifted out of the chunks' bits, with the mismatches
//      below each word, so that pref[s] = below[s >> 5] + popc(word &
//      bits below s).
//   3. kLanes lanes a pair, each taking every kLanes-th word of the
//      split range, build the candidate words (bit s of mm_i, OR bit s +
//      shift - 1 of mm_j, within the range) and walk only their set bits
//      with __ffs, a split's total from the word's counts and two
//      popcounts in registers; the smallest key over the group by
//      shuffles is the first minimum, as JAX's.
// 0.0176 ms at 4096 reads x 16 pairs (0.0179 at NC = 128) on the H100
// (700 W), 20% of the bound, by tools/time_kernels.py.  Much of it is
// the search: rows of unplaceable or wrong diagonals mismatch at most
// positions, so a pair has up to ~200 candidates, and every one counts,
// for nmm1 is written for every pair (one thread walking them through
// shared memory took 0.030 ms).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxReads = 8;      // reads a CTA
constexpr int kBatch = 4;         // chunk loads a thread keeps in flight
constexpr int kLanes = 2;         // lanes a pair searches with
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory

// bits 0 .. n - 1 (n clamped to [0, 32])
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << n) - 1u;
}

// 32-bit words of a row's bits
__host__ __device__ inline int row_words(int L) { return (L + 31) / 32; }
// 16-byte chunks that cover a row of L bytes at any offset
__host__ __device__ inline int row_chunks(int L) { return (L + 30) / 16; }
// 32-bit words of a staged row: its chunks' bits (row_words + 2), then
// its words with one past them (0), then the mismatches below each
__host__ __device__ inline int stage_words(int L) {
  return 3 * row_words(L) + 4;
}
// rows a read stages: at most every row its pairs name
__host__ __device__ inline int read_rows(int NC, int P) {
  return NC < 2 * P ? NC : 2 * P;
}
// 32-bit words of shared memory for R reads: each row's slot, each
// slot's row, the rows a read stages, the pairs' two rows, the stages
__host__ __device__ inline int64_t cta_words(int R, int NC, int P, int L) {
  return (int64_t)R * (NC + read_rows(NC, P) + 1 + 2 * P +
                       (int64_t)read_rows(NC, P) * stage_words(L));
}

// 32 bits of a staged row from position t >= -1 on (0 outside the row)
__device__ __forceinline__ uint32_t bits_from(const uint32_t* words, int nw,
                                              int t) {
  if (t < 0) return words[0] << 1;
  const int m = t >> 5;
  return __funnelshift_r(m <= nw ? words[m] : 0u,
                         m + 1 <= nw ? words[m + 1] : 0u, t & 31);
}

// pref[s] of a staged row: the mismatches of positions below s
__device__ __forceinline__ int pref_at(const uint32_t* words,
                                       const int32_t* below, int s) {
  return below[s >> 5] + __popc(words[s >> 5] & low_bits(s & 31));
}

__global__ void __launch_bounds__(kThreads) solve_indels_kernel(
    const int64_t* __restrict__ top_d, const uint8_t* __restrict__ mm,
    const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
    const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ budget, const int32_t* __restrict__ qp5,
    const int32_t* __restrict__ qp3, uint8_t* __restrict__ valid_o,
    uint8_t* __restrict__ is_del_o, int32_t* __restrict__ nindels_o,
    int32_t* __restrict__ split_o, int32_t* __restrict__ nmm1_o,
    int32_t* __restrict__ nmm2_o, int64_t* __restrict__ left_o,
    int64_t* __restrict__ right_o, int B, int P, int NC, int L, int max_ins,
    int max_del, int min_end, int radix, int R) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int S = read_rows(NC, P), SW = stage_words(L), nw = row_words(L);
  const int64_t b0 = (int64_t)blockIdx.x * R;
  const int nr = (int)(B - b0 < R ? B - b0 : R);
  int32_t* slot = (int32_t*)smem;        // [R][NC]: a row's slot, or -1
  int32_t* rowof = slot + R * NC;        // [R][S]: a slot's row
  int32_t* nrows = rowof + R * S;        // [R]: the rows a read stages
  int32_t* pij = nrows + R;              // [R][P][2]: a pair's rows
  uint32_t* stage = (uint32_t*)(pij + 2 * R * P);  // [R][S][SW]

  // 1. mark the rows the pairs name, then number them in row order
  for (int t = threadIdx.x; t < R * NC; t += blockDim.x) slot[t] = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < nr * P; t += blockDim.x) {
    const int r = t / P;
    const int64_t ci = ii[b0 * P + t], cj = jj[b0 * P + t];
    if ((uint64_t)ci >= (uint64_t)NC || (uint64_t)cj >= (uint64_t)NC)
      __trap();
    slot[r * NC + ci] = 0;
    slot[r * NC + cj] = 0;
    pij[2 * t] = (int)ci;
    pij[2 * t + 1] = (int)cj;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    int n = 0;
    for (int c0 = 0; c0 < NC; c0 += 32) {
      const int c = c0 + lane;
      const bool named = c < NC && slot[r * NC + c] == 0;
      const uint32_t m = __ballot_sync(GSNAP_FULL_MASK, named);
      if (named) {
        const int k = n + __popc(m & ((1u << lane) - 1u));
        slot[r * NC + c] = k;
        rowof[r * S + k] = c;
      }
      n += __popc(m);
    }
    if (lane == 0) nrows[r] = n;
  }
  __syncthreads();

  // 2a. each staged row's aligned 16-byte chunks, packed to 16 bits each;
  // a thread's chunks are loaded kBatch at a time, all before any is used
  const int nch = row_chunks(L), nitems = nr * S * nch;
  for (int t0 = threadIdx.x; t0 < nitems; t0 += kBatch * blockDim.x) {
    uint4 x[kBatch];
    uint16_t* dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      const int rk = t / nch, c = t - rk * nch, r = rk / S;
      dst[u] = nullptr;
      if (t < nitems && rk - r * S < nrows[r]) {
        const uintptr_t a =
            (uintptr_t)(mm + ((b0 + r) * NC + rowof[rk]) * (int64_t)L);
        const int o = (int)(a & 15);
        if (c < (o + L + 15) >> 4) {
          x[u] = __ldg((const uint4*)(a - o) + c);
          dst[u] = (uint16_t*)(stage + (int64_t)rk * SW) + c;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (dst[u] == nullptr) continue;
      const uint64_t lo =
          ((uint64_t)x[u].y << 32 | x[u].x) & 0x0101010101010101ull;
      const uint64_t hi =
          ((uint64_t)x[u].w << 32 | x[u].z) & 0x0101010101010101ull;
      *dst[u] = (uint16_t)((lo * 0x0102040810204080ull) >> 56 |
                           (hi * 0x0102040810204080ull) >> 56 << 8);
    }
  }
  __syncthreads();
  // 2b. the row's words (the chunks' bits from the row's offset on; bits
  // past L cleared) and the mismatches below each
  for (int rk = threadIdx.x; rk < nr * S; rk += blockDim.x) {
    const int r = rk / S;
    if (rk - r * S >= nrows[r]) continue;
    const int o = (int)((uintptr_t)(mm + ((b0 + r) * NC + rowof[rk]) *
                                             (int64_t)L) & 15);
    const uint32_t* chunk = stage + (int64_t)rk * SW;
    uint32_t* words = stage + (int64_t)rk * SW + nw + 2;
    int32_t* below = (int32_t*)(words + nw + 1);
    int run = 0;
    for (int w = 0; w < nw; ++w) {
      const uint32_t x =
          __funnelshift_r(chunk[w], chunk[w + 1], o) & low_bits(L - 32 * w);
      words[w] = x;
      below[w] = run;
      run += __popc(x);
    }
    words[nw] = 0u;
    below[nw] = run;
  }
  __syncthreads();

  // 3. kLanes lanes a pair, each taking every kLanes-th word of the split
  // range: it walks the word's candidate bits with __ffs, each split's
  // mismatches from the word's counts and popcounts in registers; the
  // group's smallest key by shuffles (every lane of a warp takes part)
  const int g = threadIdx.x % kLanes, npairs = nr * P;
  for (int t0 = 0; t0 < npairs; t0 += blockDim.x / kLanes) {
    const int t = t0 + threadIdx.x / kLanes;
    const bool on = t < npairs;
    int best = GSNAP_BIG_SCORE, r = 0, len = 0, n = 0;
    int64_t di = 0, dj = 0, ci = 0, cj = 0;
    bool is_del = false, is_ins = false;
    const uint32_t* wi = stage;
    const int32_t* bi = (const int32_t*)stage;
    if (on) {
      r = t / P;
      const int64_t b = b0 + r;
      const int ri = pij[2 * t], rj = pij[2 * t + 1];
      ci = b * NC + ri;
      cj = b * NC + rj;
      di = top_d[ci];
      dj = top_d[cj];
      wi = stage + (int64_t)(r * S + slot[r * NC + ri]) * SW + nw + 2;
      bi = (const int32_t*)(wi + nw + 1);
      const uint32_t* wj =
          stage + (int64_t)(r * S + slot[r * NC + rj]) * SW + nw + 2;
      const int32_t* bj = (const int32_t*)(wj + nw + 1);
      len = lengths[b];
      const int ndel = (int32_t)(uint32_t)(dj - di);
      const int nins = (int32_t)(uint32_t)(di - dj);
      is_del = ndel >= 1 && ndel <= max_del;
      is_ins = nins >= 1 && nins <= max_ins;
      n = is_del ? ndel : nins;
      const int shift = is_del ? 0 : min(max(nins, 0), max_ins);
      const int tot_j = pref_at(wj, bj, min(max(len, 0), L));
      // int32 wraparound as in JAX: hi = len (deletion) or len - n
      const int hi = is_del ? len : (int32_t)((uint32_t)len - (uint32_t)n);
      const int hi_end = (int32_t)((uint32_t)hi - (uint32_t)min_end);
      const int lo_s = max(min_end, 0), hi_s = min(hi_end, L);
      for (int k = (lo_s >> 5) + g; lo_s <= hi_s && k <= hi_s >> 5;
           k += kLanes) {
        const int s0 = 32 * k;
        // candidates: mm_i at s, or mm_j at s + shift - 1; the counts:
        // mm_j from s0 + shift on
        uint32_t cand = (wi[k] | bits_from(wj, nw, s0 + shift - 1)) &
                        low_bits(hi_s - s0 + 1) & ~low_bits(lo_s - s0);
        if (!cand) continue;
        const uint32_t wik = wi[k], pj = bits_from(wj, nw, s0 + shift);
        const int base = bi[k] + tot_j - pref_at(wj, bj, min(s0 + shift, L));
        do {
          const int e = __ffs(cand) - 1;
          cand &= cand - 1;
          const uint32_t under = (1u << e) - 1u;
          const int total = base + __popc(wik & under) - __popc(pj & under);
          best = min(best, total * radix + s0 + e);
        } while (cand);
      }
    }
    for (int o = kLanes / 2; o > 0; o >>= 1)
      best = min(best, __shfl_xor_sync(GSNAP_FULL_MASK, best, o));
    if (!on || g != 0) continue;
    const int64_t b = b0 + r, q = b0 * P + t;
    // floor division and remainder, as the plain version's // and %
    int split = best % radix;
    if (split < 0) split += radix;
    const int best_sum = (best - split) / radix;
    bool v = pvalid[q] && (is_del || is_ins) && best < GSNAP_BIG_SCORE &&
             best_sum <= budget[b];
    if (qp5 != nullptr) v = v && qp3[ci] < qp5[cj];
    const int nmm1 = pref_at(wi, bi, min(split, L));
    valid_o[q] = v;
    is_del_o[q] = is_del;
    nindels_o[q] = v ? n : 0;
    split_o[q] = v ? split : 0;
    nmm1_o[q] = nmm1;
    nmm2_o[q] = v ? best_sum - nmm1 : 0;
    left_o[q] = di;
    right_o[q] = dj;
  }
}

}  // namespace

extern "C" int gsnap_solve_indels(
    const void* top_d, const void* mm, const void* ii, const void* jj,
    const void* pvalid, const void* lengths, const void* budget,
    const void* qp5, const void* qp3, void* valid, void* is_del,
    void* nindels, void* split, void* nmm1, void* nmm2, void* left,
    void* right, int B, int P, int NC, int L, int max_ins, int max_del,
    int min_end, int radix, void* stream) {
  if ((qp5 == nullptr) != (qp3 == nullptr) || L < 1 || radix <= L ||
      NC < 1 || P < 0 || ((uintptr_t)mm & 15))
    return (int)cudaErrorInvalidValue;
  // as many reads a CTA as fit 48 KB (one read, opted in, where one does
  // not)
  int R = kMaxReads;
  while (R > 1 && cta_words(R, NC, P, L) * 4 > 48 * 1024) --R;
  const size_t smem = (size_t)cta_words(R, NC, P, L) * 4;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * P == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_indels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  solve_indels_kernel<<<(unsigned)((B + R - 1) / R), kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const int64_t*)top_d, (const uint8_t*)mm, (const int64_t*)ii,
      (const int64_t*)jj, (const uint8_t*)pvalid, (const int32_t*)lengths,
      (const int32_t*)budget, (const int32_t*)qp5, (const int32_t*)qp3,
      (uint8_t*)valid, (uint8_t*)is_del, (int32_t*)nindels, (int32_t*)split,
      (int32_t*)nmm1, (int32_t*)nmm2, (int64_t*)left, (int64_t*)right, B, P,
      NC, L, max_ins, max_del, min_end, radix, R);
  return (int)cudaGetLastError();
}
