// Kernel K10: GMAP's sparse chain DP over diagonal segments and the
// backtrack of each row's best chain, in one kernel.
//
// Replaces gmap_gsnap_tpu/align/gmap_engine.py chain_scores_device (:184)
// and chain_backtrack_device (:233).  One warp per query row, kWarps rows
// a CTA, no block barrier; S segments ordered by (qstart, diag):
//   * score[j] starts at the segment's length (NEG = -2^28 when invalid),
//     prev[j] at -1; lv is the row's last valid segment (a warp maximum);
//   * the row's segments up to lv are staged in the warp's shared memory
//     (qstart, qend, the diagonal's low 32 bits, valid, score, prev), or
//     read in place from global memory when lv >= the staged capacity
//     (kMaxStaged);
//   * for i = 1 .. lv, in order (score[i] reads the final score[j] of
//     every j < i): lane l scores cand_j = score[j] + gain - penalty for
//     its j = l, l + 32, ... < i where JAX allows the transition (gd =
//     diag_i - diag_j as uint32, reinterpreted as int32 — the JAX astype;
//     gd <= max_intronlen, -gd <= 30 in wrapping int32, qgap >= -k),
//     keeping its first maximum; two warp reductions (the largest cand,
//     then the smallest j holding it) give JAX's first maximum, and
//     score[i], prev[i] update on strict '>': a step is one pass over the
//     lanes' candidates, two reductions and a warp barrier;
//   * backtrack: the first maximum of the valid scores (the same two
//     reductions), lane 0 following prev through shared memory (one
//     dependent shared load a member), then the lanes writing each of the
//     C slots' (qstart << 16) | qend (-1 past the chain) and diagonal
//     (that of segment 0 past the chain, as JAX's clipped gather gives),
//     deep = a predecessor is left after C steps, and the best score.
//
// Bound: the lv dependent steps of a row (latency: a step's shared loads,
// ~15 integer operations and two reductions), then its chain's dependent
// prev loads.  Each row reads its 4 x S segment values and writes 2 x S +
// 2 x C + 2 values.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows a CTA
constexpr int kMaxStaged = 1024;   // segments a warp stages
constexpr int32_t kNeg = -(1 << 28);
constexpr int kMaxInsertlen = 30;
constexpr int kMinIntronlength = 9;

// Bytes of one warp's shared memory: cap staged segments' five int32
// fields and valid byte, and C backtrack members.
__host__ __device__ __forceinline__ int warp_bytes(int cap, int C) {
  return (20 * cap + 4 * C + cap + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int staged_cap(int S) {
  return S < kMaxStaged ? S : kMaxStaged;
}

// The DP over a row's segments 1 .. lv and its backtrack, reading the
// segments through QS, QE, DG (the diagonal's low 32 bits at DG[j *
// kDgStride]), V and keeping score / prev in SC, PR: the warp's shared
// copies, or the row's global arrays in place.  Returns the chain's
// length (members[0, len) end-first) and writes deep / best.
template <int kDgStride>
__device__ __forceinline__ int chain_row(
    const int32_t* QS, const int32_t* QE, const uint32_t* DG,
    const uint8_t* V, int32_t* SC, int32_t* PR, int32_t* members, int lv,
    int C, int k, int max_intronlen, uint8_t* deep, int32_t* best_out) {
  const int lane = threadIdx.x & 31;
  for (int i = 1; i <= lv; ++i) {
    if (!V[i]) continue;  // uniform: every lane reads V[i]
    const int32_t qs_i = QS[i];
    const int32_t seglen = QE[i] - qs_i;
    const uint32_t dg_i = DG[i * kDgStride];
    const int32_t sc_i = SC[i];
    int32_t best = INT_MIN, bj = INT_MAX;
    for (int j = lane; j < i; j += 32) {
      const int32_t qgap = qs_i - QE[j];
      const int32_t gd = (int32_t)(dg_i - DG[j * kDgStride]);
      const int32_t neg_gd = (int32_t)(0u - (uint32_t)gd);
      const bool ok = V[j] && gd <= max_intronlen &&
                      neg_gd <= kMaxInsertlen && qgap >= -k;
      const int32_t gain = seglen + min(qgap, 0);
      const int32_t pen =
          max(qgap, 0) +
          (gd > 0 ? (gd >= kMinIntronlength ? 25 : 12) : (gd < 0 ? 12 : 0));
      const int32_t cand = ok ? SC[j] + gain - pen : kNeg;
      if (cand > best) {  // j ascends: the lane's first maximum
        best = cand;
        bj = j;
      }
    }
    const int32_t cj = __reduce_max_sync(GSNAP_FULL_MASK, best);
    const int32_t jj =
        __reduce_min_sync(GSNAP_FULL_MASK, best == cj ? bj : INT_MAX);
    if (lane == 0 && cj > sc_i) {
      SC[i] = cj;
      PR[i] = jj;
    }
    __syncwarp();
  }
  // backtrack from the first maximum of the valid scores (every segment
  // past lv is invalid)
  int32_t best = INT_MIN, bj = INT_MAX;
  for (int j = lane; j <= lv; j += 32) {
    const int32_t v = V[j] ? SC[j] : kNeg;
    if (v > best) {
      best = v;
      bj = j;
    }
  }
  const int32_t bmax = lv < 0 ? kNeg : __reduce_max_sync(GSNAP_FULL_MASK, best);
  const int32_t bidx =
      __reduce_min_sync(GSNAP_FULL_MASK, best == bmax ? bj : INT_MAX);
  int32_t len = 0;
  if (lane == 0) {
    int32_t cur = bmax > kNeg / 2 ? bidx : -1;
    while (len < C && cur >= 0) {
      members[len++] = cur;
      cur = PR[cur];
    }
    *deep = cur >= 0;
    *best_out = bmax;
  }
  return __shfl_sync(GSNAP_FULL_MASK, len, 0);
}

__global__ void __launch_bounds__(kWarps * 32) chain_kernel(
    const int32_t* __restrict__ qstart_all, const int32_t* __restrict__ qend_all,
    const int64_t* __restrict__ diag_all, const uint8_t* __restrict__ valid_all,
    int32_t* score_all, int32_t* prev_all, int32_t* __restrict__ qspan,
    int64_t* __restrict__ dg_out, uint8_t* __restrict__ deep,
    int32_t* __restrict__ best_out, int B, int S, int C, int k,
    int max_intronlen) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;  // a whole warp: no block barrier follows
  const int cap = staged_cap(S);
  uint8_t* ws = smem + warp * warp_bytes(cap, C);
  int32_t* s_qs = (int32_t*)ws;
  int32_t* s_qe = s_qs + cap;
  uint32_t* s_dg = (uint32_t*)(s_qe + cap);
  int32_t* s_score = (int32_t*)(s_dg + cap);
  int32_t* s_prev = s_score + cap;
  int32_t* members = s_prev + cap;
  uint8_t* s_valid = (uint8_t*)(members + C);

  const int64_t o = (int64_t)row * S;
  const int32_t* qs = qstart_all + o;
  const int32_t* qe = qend_all + o;
  const int64_t* dg = diag_all + o;
  const uint8_t* valid = valid_all + o;
  int32_t* score = score_all + o;
  int32_t* prev = prev_all + o;

  // one pass: the initial scores into the output rows, the first cap
  // segments into shared memory, and the last valid segment
  int last = -1;
#pragma unroll 4
  for (int j = lane; j < S; j += 32) {
    const bool v = valid[j];
    const int32_t a = qs[j], b = qe[j];
    const int32_t sc = v ? b - a : kNeg;
    score[j] = sc;
    prev[j] = -1;
    if (j < cap) {
      s_qs[j] = a;
      s_qe[j] = b;
      s_dg[j] = (uint32_t)dg[j];
      s_valid[j] = v;
      s_score[j] = sc;
      s_prev[j] = -1;
    }
    if (v) last = j;
  }
  const int lv = __reduce_max_sync(GSNAP_FULL_MASK, last);
  __syncwarp();
  int len;
  if (lv < cap) {
    len = chain_row<1>(s_qs, s_qe, s_dg, s_valid, s_score, s_prev, members,
                       lv, C, k, max_intronlen, deep + row, best_out + row);
    for (int j = lane; j <= lv; j += 32) {
      score[j] = s_score[j];
      prev[j] = s_prev[j];
    }
  } else {
    len = chain_row<2>(qs, qe, (const uint32_t*)dg, valid, score, prev,
                       members, lv, C, k, max_intronlen, deep + row,
                       best_out + row);
  }
  __syncwarp();
  const int64_t oc = (int64_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const int32_t cur = c < len ? members[c] : -1;
    const int32_t ic = cur < 0 ? 0 : cur;
    qspan[oc + c] = cur >= 0 ? (int32_t)(((uint32_t)qs[ic] << 16) |
                                         (uint32_t)qe[ic])
                             : -1;
    dg_out[oc + c] = dg[ic];
  }
}

}  // namespace

extern "C" int gmap_chain(const void* qstart, const void* qend,
                          const void* diag, const void* valid, void* score,
                          void* prev, void* qspan, void* dg, void* deep,
                          void* best, int B, int S, int C, int k,
                          int max_intronlen, void* stream) {
  if (S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = kWarps * warp_bytes(staged_cap(S), C);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_kernel<<<gsnap_blocks(B, kWarps), kWarps * 32, smem,
                 (cudaStream_t)stream>>>(
      (const int32_t*)qstart, (const int32_t*)qend, (const int64_t*)diag,
      (const uint8_t*)valid, (int32_t*)score, (int32_t*)prev,
      (int32_t*)qspan, (int64_t*)dg, (uint8_t*)deep, (int32_t*)best, B, S, C,
      k, max_intronlen);
  return (int)cudaGetLastError();
}
