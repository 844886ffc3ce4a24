// Kernel K6: diagonal triples i -> m -> j for short-exon doublesplices.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _select_triples (:668)
// — the candidate set of find_doublesplices, stage1hr.c:7698-7742:
//   * an edge a -> c is eligible when both diagonals are valid and the
//     uint32 difference d_c - d_a lies in [1, maxdist];
//   * middle m keeps its two best predecessors and its two best
//     successors by (votes desc, index asc), ineligible ones counting -1
//     — lax.top_k(., 2) with its lower-index tie rule, which matters
//     because votes tie often and every ineligible entry is -1;
//   * the 4 combinations per middle give NC * 4 vote sums (-1 unless both
//     neighbours exist and m is valid); entry e = m * 4 + a * 2 + c gets
//     the 32-bit key (0x7FFFFF - (vsum + 1)) << 9 | e, so that ascending
//     keys are argsort(-vsum, stable=True); vsum + 1 must lie in [0, 2^23
//     - 1) (votes in [0, W] make it so), and a negative vote or a sum
//     past that traps: neither is ever clamped;
//   * the first T keys give (ti, tm, tj, valid = vsum >= 0).
//
// Bound: the larger of bytes (a read's NC diagonals and votes in, 3 int64
// and a bool for each of its T triples out: 0.00071 ms at 4096 reads, NC
// = 32, T = 8; 0.00212 ms at NC = 128) and the operations this design
// needs on the run's data (n log2 n to sort a read's n valid diagonals,
// 4 log2 n binary-search steps a valid middle, 2 compares at each end of
// each eligible edge, 4 NC log2(4 NC) to select T of the 4 NC keys:
// below the bytes at both shapes on a planted batch, chip_smoke.py
// _triple_cost).  The design this one replaces (a CTA of 128 threads a
// read, 32 of them scanning at NC = 32, then a shared-memory bitonic sort
// of all 4 NC keys with a block barrier a stage) took 0.0255 ms there on
// the H100 (700 W), 0.1362 ms at NC = 128.
//
// Design: a warp per read, four reads a CTA, no block barrier.
//   1. The read's diagonals and votes go to the warp's shared row as one
//      64-bit word each (the vote of an invalid diagonal as -1), and its
//      valid diagonals, as keys d << 32 | index, are sorted in registers
//      (row_sort.cuh) into a sorted row of values and indices.
//   2. Lane t owns middles t * MPL .. t * MPL + MPL - 1 (MPL = 1, 2 or 4
//      for NC <= 32, 64, 128).  A middle's eligible predecessors lie in
//      [d_m - maxdist, d_m - 1] and its successors in [d_m + 1, d_m +
//      maxdist], mod 2^32: one or two ranges of the sorted row each,
//      found by binary searches and scanned alone, keeping the top 2 by
//      (votes desc, index asc) in registers.  Where fewer than two are
//      eligible, the ineligible entries (-1) fill the places at the
//      lowest indices, as top_k ranks them: every vote is >= 0 (K2's
//      are), and a negative vote of a valid diagonal, which would rank
//      below them, traps.  (A scan of all NC entries a middle took 0.0739
//      ms at NC = 128 against 0.0335, and as long at NC = 32: 0.0098
//      against 0.0099; H100, 700 W, by tools/time_kernels.py.)  The 4 MPL
//      keys stay in registers (row_sort.cuh's blocked layout: key r of
//      lane t is entry 4 MPL t + r).
//   3. The T smallest keys are found without sorting the rest: a
//      bisection on the keys' high bits (the vote sum) and then on the
//      whole key counts the keys at or below a threshold (row sums, as
//      K2 and K16 do); exactly T keys lie at or below the last.  Only
//      those are compacted (row exclusive sums) and sorted: in registers
//      when T <= 32, else in the warp's shared row.
//   4. Lanes t < T store triple t, coalesced.
#include <climits>

#include "row_sort.cuh"

namespace {

constexpr int kMaxNC = 128;
constexpr int kRowsPerBlock = 4;           // reads of a CTA, a warp each
constexpr uint32_t kNoScore = 0x7FFFFFu;   // the high bits of a -1 sum
constexpr int64_t kMaxSum = 0x7FFFFE;      // vsum + 1 < 2^23 - 1
constexpr uint32_t kNoKey = 0xFFFFFFFFu;

// the two best (votes desc, index asc) of the entries taken, in any order
struct Top2 {
  int v0, i0, v1, i1;
  __device__ void take(int v, int i) {
    if (v > v0 || (v == v0 && i < i0)) { v1 = v0; i1 = i0; v0 = v; i0 = i; }
    else if (v > v1 || (v == v1 && i < i1)) { v1 = v; i1 = i; }
  }
};

// shared-memory bytes of one read (N = NC rounded up to 32 MPL): the
// diagonal and vote words, the sorted diagonals and their indices, the
// two predecessor and two successor indices of each middle, the selected
// keys (S, T rounded up to a power of two), rounded up to 8 bytes
__host__ __device__ inline size_t row_bytes(int NC, int N, int S) {
  return ((size_t)NC * 8 + (size_t)N * 6 + (size_t)NC * 4 * 2 +
          (size_t)S * 4 + 7) / 8 * 8;
}

// the first of the n (a power of two) ascending values s[] that is >= x
// (n when none is)
__device__ __forceinline__ int lower_bound_pow2(const uint32_t* s, int n,
                                                uint64_t x) {
  int i = 0;
  for (int step = n >> 1; step > 0; step >>= 1)
    if (s[i + step - 1] < x) i += step;
  return s[i] < x ? n : i;
}

// the top 2 (votes desc, index asc) over the valid diagonals whose values
// lie in [a, b] (uint32, a <= b): a range of the sorted row
__device__ __forceinline__ void take_range(Top2& t, const uint32_t* s_sd,
                                           const uint16_t* s_sc,
                                           const uint64_t* s_dv, int N,
                                           int nv, uint64_t a, uint64_t b) {
  const int e1 = min(nv, lower_bound_pow2(s_sd, N, b + 1));
  for (int e = min(nv, lower_bound_pow2(s_sd, N, a)); e < e1; ++e) {
    const int c = s_sc[e];
    t.take((int)(s_dv[c] >> 32), c);
  }
}

template <int MPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock) select_triples_kernel(
    const int64_t* __restrict__ top_d, const int32_t* __restrict__ votes,
    int64_t* __restrict__ ti_o, int64_t* __restrict__ tm_o,
    int64_t* __restrict__ tj_o, uint8_t* __restrict__ valid_o, int B,
    int NC, int T, int S, uint32_t maxdist) {
  constexpr int KPL = 4 * MPL;  // keys a lane
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int slot = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + slot;
  if (b >= B) return;  // warp-uniform exit
  constexpr int N = 32 * MPL;   // sorted places, a power of two
  constexpr uint32_t kInvalid = (uint32_t)GSNAP_INVALID_DIAG;
  uint8_t* base = smem_raw + (size_t)slot * row_bytes(NC, N, S);
  uint64_t* s_dv = (uint64_t*)base;  // low: the diagonal; high: its vote
  uint32_t* s_sd = (uint32_t*)(s_dv + NC);  // the sorted diagonals
  int16_t* s_i2 = (int16_t*)(s_sd + N);     // [m][2] predecessors
  int16_t* s_j2 = s_i2 + 2 * NC;            // [m][2] successors
  uint16_t* s_sc = (uint16_t*)(s_j2 + 2 * NC);  // their indices
  uint32_t* sel = (uint32_t*)(s_sc + N);

  // 1. the read's diagonals and votes (a diagonal outside [0, 2^32)
  // traps), and the valid ones sorted with their indices (INVALID last)
  uint64_t sk[MPL];
  int nvalid = 0;
#pragma unroll
  for (int mi = 0; mi < MPL; ++mi) {
    const int c = lane * MPL + mi;
    sk[mi] = ~0ull;
    if (c < NC) {
      const int64_t d = top_d[b * NC + c];
      if ((uint64_t)d >> 32) __trap();
      const bool ok = (uint32_t)d != kInvalid;
      const int v = ok ? votes[b * NC + c] : -1;
      s_dv[c] = (uint64_t)(uint32_t)v << 32 | (uint32_t)d;
      if (ok) {
        if (v < 0) __trap();
        sk[mi] = (uint64_t)d << 32 | (uint32_t)c;
        ++nvalid;
      }
    }
  }
  const int nv = __reduce_add_sync(GSNAP_FULL_MASK, nvalid);
  row_sort<uint64_t, MPL, 1>(sk, nullptr);
#pragma unroll
  for (int mi = 0; mi < MPL; ++mi) {
    s_sd[lane * MPL + mi] = (uint32_t)(sk[mi] >> 32);
    s_sc[lane * MPL + mi] = (uint16_t)sk[mi];
  }
  __syncwarp();

  // 2. the lane's middles: top-2 scans and their keys
  uint32_t key[KPL];
  uint32_t lo = kNoScore;  // the row's smallest high bits
#pragma unroll
  for (int mi = 0; mi < MPL; ++mi) {
    const int m = lane * MPL + mi;
    Top2 pre{-1, 0, -1, 1}, suc{-1, 0, -1, 1};  // where m is invalid
    bool okm = false;
    int vm = 0;
    if (m < NC) {
      const uint64_t w = s_dv[m];
      const uint32_t dm = (uint32_t)w;
      vm = (int)(w >> 32);
      okm = dm != (uint32_t)GSNAP_INVALID_DIAG;
      if (okm) {
        // the eligible predecessors lie in [d_m - maxdist, d_m - 1] and
        // the successors in [d_m + 1, d_m + maxdist], mod 2^32: one or
        // two ranges of the sorted row each, scanned alone; their votes
        // are >= 0, so the ineligible entries (-1) only fill the places
        // the eligible leave, at the lowest indices
        pre = Top2{INT_MIN, -1, INT_MIN, -1};
        suc = pre;
        if (maxdist > 0) {
          const uint64_t D = dm, M = maxdist, top = 0xFFFFFFFFull;
          if (M < D) {
            take_range(pre, s_sd, s_sc, s_dv, N, nv, D - M, D - 1);
          } else {
            if (D > 0) take_range(pre, s_sd, s_sc, s_dv, N, nv, 0, D - 1);
            if (M > D) take_range(pre, s_sd, s_sc, s_dv, N, nv,
                                  top + 1 - (M - D), top);
          }
          if (D + M <= top) {
            take_range(suc, s_sd, s_sc, s_dv, N, nv, D + 1, D + M);
          } else {
            take_range(suc, s_sd, s_sc, s_dv, N, nv, D + 1, top);
            take_range(suc, s_sd, s_sc, s_dv, N, nv, 0, D + M - top - 1);
          }
        }
        const auto fill = [](Top2& t) {
          if (t.i0 < 0) t = Top2{-1, 0, -1, 1};
          else if (t.i1 < 0) t = Top2{t.v0, t.i0, -1, t.i0 == 0 ? 1 : 0};
        };
        fill(pre);
        fill(suc);
      }
      s_i2[2 * m] = (int16_t)pre.i0;
      s_i2[2 * m + 1] = (int16_t)pre.i1;
      s_j2[2 * m] = (int16_t)suc.i0;
      s_j2[2 * m + 1] = (int16_t)suc.i1;
    }
    const int vp[2] = {pre.v0, pre.v1}, vs[2] = {suc.v0, suc.v1};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = m * 4 + a * 2 + c;
        uint32_t high = kNoScore;
        if (okm && vp[a] >= 0 && vs[c] >= 0) {
          const int64_t vsum = (int64_t)vm + vp[a] + vs[c];
          if (vsum > kMaxSum) __trap();
          high = kNoScore - (uint32_t)(vsum + 1);
        }
        key[mi * 4 + a * 2 + c] = m < NC ? high << 9 | (uint32_t)e : kNoKey;
        lo = min(lo, high);
      }
  }

  // 3. the T-th smallest key: its high bits, then the key
  lo = row_extreme<1>(lo, false, nullptr);
  const uint32_t high =
      row_lowest_reaching<KPL, 1>(key, lo, kNoScore, 9, T, nullptr);
  const uint32_t cut = row_lowest_reaching<KPL, 1>(
      key, high << 9, high << 9 | 0x1FFu, 0, T, nullptr);
  int nsel = 0;
#pragma unroll
  for (int r = 0; r < KPL; ++r) nsel += key[r] <= cut;
  int at = row_exclusive_sum<1>(nsel, nullptr);
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    if (key[r] <= cut) sel[at++] = key[r];
  __syncwarp();
  uint32_t k = kNoKey;  // the lane's rank-t key (t = lane) when S <= 32
  if (S <= 32) {
    uint32_t v[1] = {lane < T ? sel[lane] : kNoKey};
    row_sort<uint32_t, 1, 1>(v, nullptr);
    k = v[0];
  } else {
    for (int e = T + lane; e < S; e += 32) sel[e] = kNoKey;
    __syncwarp();
    row_sort_shared<1>(sel, S, lane, 32);
  }

  // 4. the triples, in rank order
  for (int t = lane; t < T; t += 32) {
    if (S > 32) k = sel[t];
    const int e = (int)(k & 0x1FFu);
    const int m = e >> 2;
    const int64_t o = b * T + t;
    ti_o[o] = s_i2[2 * m + ((e >> 1) & 1)];
    tm_o[o] = m;
    tj_o[o] = s_j2[2 * m + (e & 1)];
    valid_o[o] = (k >> 9) != kNoScore;
  }
}

template <int MPL>
int launch_triples(const int64_t* top_d, const int32_t* votes, int64_t* ti,
                   int64_t* tm, int64_t* tj, uint8_t* valid, int B, int NC,
                   int T, int S, uint32_t maxdist, cudaStream_t stream) {
  const size_t smem =  // < 48 KB
      (size_t)kRowsPerBlock * row_bytes(NC, 32 * MPL, S);
  select_triples_kernel<MPL><<<gsnap_blocks(B, kRowsPerBlock),
                               32 * kRowsPerBlock, smem, stream>>>(
      top_d, votes, ti, tm, tj, valid, B, NC, T, S, maxdist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gsnap_select_triples(const void* top_d, const void* votes,
                                    void* ti, void* tm, void* tj,
                                    void* valid, int B, int NC, int T,
                                    int64_t maxdist, void* stream) {
  if (NC < 2 || NC > kMaxNC || T < 1 || T > 4 * NC || maxdist < 0 ||
      maxdist > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int s = 1;
  while (s < T) s <<= 1;
  const auto* td = (const int64_t*)top_d;
  const auto* vt = (const int32_t*)votes;
  auto* io = (int64_t*)ti;
  auto* mo = (int64_t*)tm;
  auto* jo = (int64_t*)tj;
  auto* vo = (uint8_t*)valid;
  const cudaStream_t st = (cudaStream_t)stream;
#define GSNAP_TRIPLES(MPL)                                               \
  launch_triples<MPL>(td, vt, io, mo, jo, vo, B, NC, T, s,               \
                      (uint32_t)maxdist, st)
  if (NC <= 32) return GSNAP_TRIPLES(1);
  if (NC <= 64) return GSNAP_TRIPLES(2);
  return GSNAP_TRIPLES(4);
#undef GSNAP_TRIPLES
}
