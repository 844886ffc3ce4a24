// Kernel K10: GMAP's sparse chain DP over diagonal segments and the
// backtrack of each row's best chain, in one kernel.
//
// Replaces gmap_gsnap_tpu/align/gmap_engine.py chain_scores_device (:184)
// and chain_backtrack_device (:233).  One CTA per query row, S segments
// ordered by (qstart, diag):
//   * score[j] starts at the segment's length (NEG = -2^28 when invalid),
//     prev[j] at -1;
//   * for i = 1 .. the last valid segment, in order (score[i] reads the
//     final score[j] of every j < i): the threads stride over j < i and
//     score cand_j = score[j] + gain - penalty for the transitions JAX
//     allows (gd = diag_i - diag_j as uint32, reinterpreted as int32 — the
//     JAX astype; gd <= max_intronlen, -gd <= 30 in wrapping int32,
//     qgap >= -k); a block reduction of the key  cand * 2^32 + (2^32-1-j)
//     gives JAX's first maximum; score[i], prev[i] update on strict '>';
//   * backtrack: the first maximum of the valid scores (block reduction),
//     then one thread follows prev for C steps, writing each member's
//     (qstart << 16) | qend (-1 past the chain) and diagonal (that of
//     segment 0 past the chain, as JAX's clipped gather gives), deep =
//     a predecessor is left after C steps, and the best score.
// score/prev live in the output rows (global memory): the block's
// barriers make one thread's write visible to the others.
//
// Bound: the O(S^2) transition scoring, each step of the i loop a pass
// over j < i from L1 plus a block reduction and two barriers (latency-
// bound: S - 1 dependent steps per row), then C dependent loads of the
// backtrack.  Each row reads its 4 x S segment values and writes 2 x S +
// 2 x C + 2 values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kNeg = -(1 << 28);
constexpr int kMaxInsertlen = 30;
constexpr int kMinIntronlength = 9;

__global__ void __launch_bounds__(kThreads) chain_kernel(
    const int32_t* __restrict__ qstart_all, const int32_t* __restrict__ qend_all,
    const int64_t* __restrict__ diag_all, const uint8_t* __restrict__ valid_all,
    int32_t* score_all, int32_t* prev_all, int32_t* __restrict__ qspan,
    int64_t* __restrict__ dg_out, uint8_t* __restrict__ deep,
    int32_t* __restrict__ best_out, int S, int C, int k, int max_intronlen) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t o = (int64_t)row * S;
  const int32_t* qs = qstart_all + o;
  const int32_t* qe = qend_all + o;
  const int64_t* dg = diag_all + o;
  const uint8_t* valid = valid_all + o;
  int32_t* score = score_all + o;
  int32_t* prev = prev_all + o;

  int32_t last = -1;
  for (int j = tid; j < S; j += blockDim.x) {
    score[j] = valid[j] ? qe[j] - qs[j] : kNeg;
    prev[j] = -1;
    if (valid[j]) last = max(last, j);
  }
  const int lv = (int)gmap_block_max(last);  // synchronises the block

  for (int i = 1; i <= lv; ++i) {
    if (!valid[i]) continue;  // uniform: every thread reads valid[i]
    const int32_t qs_i = qs[i];
    const int32_t seglen = qe[i] - qs_i;
    const uint32_t dg_i = (uint32_t)dg[i];
    int64_t key = INT64_MIN;
    for (int j = tid; j < i; j += blockDim.x) {
      const int32_t qgap = qs_i - qe[j];
      const int32_t gd = (int32_t)(dg_i - (uint32_t)dg[j]);
      const int32_t neg_gd = (int32_t)(0u - (uint32_t)gd);
      const bool ok = valid[j] && gd <= max_intronlen &&
                      neg_gd <= kMaxInsertlen && qgap >= -k;
      const int32_t gain = seglen + min(qgap, 0);
      const int32_t pen =
          max(qgap, 0) +
          (gd > 0 ? (gd >= kMinIntronlength ? 25 : 12) : (gd < 0 ? 12 : 0));
      const int32_t cand = ok ? score[j] + gain - pen : kNeg;
      key = gmap_max64(key, gmap_first_max_key(cand, j));
    }
    key = gmap_block_max(key);
    if (tid == 0) {
      const int32_t cj = gmap_key_value(key);
      if (cj > score[i]) {
        score[i] = cj;
        prev[i] = gmap_key_index(key);
      }
    }
    __syncthreads();
  }

  // backtrack from the first maximum of the valid scores
  int64_t key = INT64_MIN;
  for (int j = tid; j < S; j += blockDim.x)
    key = gmap_max64(key, gmap_first_max_key(valid[j] ? score[j] : kNeg, j));
  key = gmap_block_max(key);
  if (tid == 0) {
    const int32_t best = gmap_key_value(key);
    int32_t cur = best > kNeg / 2 ? gmap_key_index(key) : -1;
    for (int c = 0; c < C; ++c) {
      const int64_t out = (int64_t)row * C + c;
      const int32_t ic = cur < 0 ? 0 : cur;
      qspan[out] = cur >= 0 ? (int32_t)(((uint32_t)qs[ic] << 16) |
                                        (uint32_t)qe[ic])
                            : -1;
      dg_out[out] = dg[ic];
      cur = cur >= 0 ? prev[cur] : -1;
    }
    deep[row] = cur >= 0;
    best_out[row] = best;
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
  chain_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qstart, (const int32_t*)qend, (const int64_t*)diag,
      (const uint8_t*)valid, (int32_t*)score, (int32_t*)prev,
      (int32_t*)qspan, (int64_t*)dg, (uint8_t*)deep, (int32_t*)best, S, C,
      k, max_intronlen);
  return (int)cudaGetLastError();
}
