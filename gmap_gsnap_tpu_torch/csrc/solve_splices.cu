// Kernel K5: local splices between diagonal pairs, novel and known.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _solve_splices (:515,
// with _fetch_span :502, _suff_local :495, ops/genome.fetch_span_codes
// :139, fetch_span_bits :157, ops/maxent.splice_idx_span :160 and
// ops/select.table_lookup :49) — solve_singlesplice, stage1hr.c:6195.
// Per (read, pair i -> j) and per sense class:
//   * scan position s is a candidate when 2 <= s <= len - 2, both
//     diagonals are >= 64, the mismatch sum pref_i[s] + (tot_j -
//     pref_j[s]) fits the budget and each side is a site of the class:
//     with `novel`, the genome carries its dinucleotides (sense: donor GT
//     on i at s, acceptor AG on j at s - 2; antisense: antiacceptor CT on
//     i, antidonor AC on j); or its known-site bit at d + s is set (the
//     four bitvectors of gsnap -s, JAX :553-572);
//   * the first SPLICE_CANDS (16) candidates in ascending s are kept —
//     what top_k(-key, 16) keeps in JAX, whose remaining slots are masked;
//   * each is scored with float32 maxent, 1.0 on a side that is a known
//     site (JAX :619-620), and the sufficiency gate; the class's best is
//     the first maximum of prob_i + prob_j (ties to the smaller s);
//   * antisense wins only when strictly better.  Outputs of invalid
//     pairs are the JAX ones: sense = !(anti > sense), left/right = the
//     diagonals, the rest 0.
//
// Bound: bytes (0.021 ms at 4096 rows x 16 pairs): a pair reads two pref
// rows (~800 B, in L2 after K3), two genome spans and, with known sites,
// 4 x 2 bitvector words a mask word, and at most 32 reads of the 786 KB
// maxent tables (L2).  The design this one replaces (the classes one
// after the other, a global load per base for every site test and maxent
// window, half the warp idle while scoring) took 0.1046 ms at 4096 rows,
// NC=32, 16 pairs on the H100 (700 W).
//
// Design: one warp per pair, both classes at once (splice_span.cuh's
// helpers, shared with K7).
//   1. One coalesced pass over the two pref rows, 32 positions a step,
//      gives the range and budget mask of s = 0..L by ballots (both
//      classes share it).  A pair without such a position stops here,
//      and one without a candidate after step 3.
//   2. With novel sites, the two segments' genome spans are read once (a
//      word a lane) into the warp's shared memory.
//   3. Lane 2 k + c (k < mask_words(L), c 0 sense / 1 antisense) builds
//      the class's candidate word k: (known | novel & site) on i AND
//      (known | novel & site) on j AND the range and budget word, site
//      words by word operations on the span, known words by a funnel
//      shift of two bitvector words.
//   4. Lane 16 q + r takes class q's r-th candidate (popc over the words,
//      then the lowest bits cleared) and scores it: one short (9-base, 2
//      factors) and one long (23-base, 6 factors) maxent window read from
//      the spans, the arithmetic of maxent.cuh in _MODELS order (without
//      novel sites both sides are known: 1.0).
//   5. A reduction in each half-warp takes its class's first maximum; the
//      two halves' winners meet by shuffles.
#include "splice_span.cuh"

namespace {

constexpr int kCands = 16;

// The position of the r-th set bit (from 0) of a mask over words
// w[0..nw), -1 if it has fewer: the r-th candidate in ascending s.
__device__ __forceinline__ int nth_bit(const uint32_t* w, int nw, int r) {
  for (int k = 0; k < nw; ++k) {
    uint32_t x = w[k];
    const int c = __popc(x);
    if (r < c) {
      for (int i = 0; i < r; ++i) x &= x - 1;
      return 32 * k + __ffs(x) - 1;
    }
    r -= c;
  }
  return -1;
}
constexpr int kMaxWarps = 8;     // warps a CTA, where they fit
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory

// 32-bit words of one warp's shared memory: two spans, the range and
// budget mask, and per class the candidate and the two known masks
__host__ __device__ inline int warp_words(int L) {
  return 2 * gsnap_span::span_words(L) + 7 * gsnap_span::mask_words(L);
}

__global__ void solve_splices_kernel(
    const uint32_t* __restrict__ ref16, const float* __restrict__ tab,
    const int64_t* __restrict__ top_d, const int32_t* __restrict__ pref,
    const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
    const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ budget, uint8_t* __restrict__ valid_o,
    int32_t* __restrict__ split_o, uint8_t* __restrict__ sense_o,
    float* __restrict__ prob_d_o, float* __restrict__ prob_a_o,
    int32_t* __restrict__ nmm1_o, int32_t* __restrict__ nmm2_o,
    int64_t* __restrict__ left_o, int64_t* __restrict__ right_o,
    const gsnap_maxent::Known known, int64_t nwords, int B, int P, int NC,
    int L, int novel) {
  using namespace gsnap_span;
  extern __shared__ __align__(16) uint32_t smem[];
  const int wib = threadIdx.x >> 5;
  const int64_t warp = (int64_t)blockIdx.x * (blockDim.x >> 5) + wib;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * P) return;  // warp-uniform exit
  const int64_t b = warp / P;
  const int64_t ci = b * NC + ii[warp];
  const int64_t cj = b * NC + jj[warp];
  const int64_t di = top_d[ci], dj = top_d[cj];
  const int32_t* pi = pref + ci * (L + 1);
  const int32_t* pj = pref + cj * (L + 1);
  const int len = lengths[b];
  const int tot_j = pj[len];

  // the lane's slot: class q = lane / 16, its position s (-1: none), the
  // probability sum (-1 when not sufficient) and its two sides
  const int q = lane / kCands;
  int s = -1;
  float prob = -1.0f, p_i = 0.0f, p_j = 0.0f;
  if (di >= 64 && dj >= 64) {  // warp-uniform: below 64 no candidates
    const int nmw = mask_words(L), nws = span_words(L);
    uint32_t* span_i = smem + (int64_t)wib * warp_words(L);
    uint32_t* span_j = span_i + nws;
    uint32_t* okm = span_j + nws;    // range and budget, nmw words
    uint32_t* cand = okm + nmw;      // [class][word]
    uint32_t* kn_i = cand + 2 * nmw;
    uint32_t* kn_j = kn_i + 2 * nmw;
    // 1. 2 <= s <= len - 2 and the mismatch sum within the budget
    const int bud = budget[b];
    uint32_t any = 0;  // warp-uniform: a ballot's or a mask's bits
    for (int k = 0; k < nmw; ++k) {
      const int x = 32 * k + lane;
      const bool ok =
          x >= 2 && x <= len - 2 && pi[x] + (tot_j - pj[x]) <= bud;
      const uint32_t m = __ballot_sync(GSNAP_FULL_MASK, ok);
      if (lane == 0) okm[k] = m;
      any |= m;
    }
    // 2. the spans (most pairs have no position in range and budget, or
    // no candidate: they stop here or after 3; without novel sites a
    // candidate is known on both sides, and no window is read)
    if (any && novel) {
      load_span(span_i, ref16, nwords, (uint64_t)di, L, lane);
      load_span(span_j, ref16, nwords, (uint64_t)dj, L, lane);
    }
    __syncwarp();
    // 3. candidate word k of class c on lane 2 k + c
    for (int e = lane; any && e < 2 * nmw; e += 32) {
      const int c = e & 1, k = e >> 1;
      const int kind_i = c ? kAntiacceptor : kDonor;
      const int kind_j = c ? kAntidonor : kAcceptor;
      const uint32_t ki = known_word(known, kind_i, (uint64_t)di, k);
      const uint32_t kj = known_word(known, kind_j, (uint64_t)dj, k);
      uint32_t si = ki, sj = kj;
      if (novel) {
        si |= site_word(span_i, (uint64_t)di, kind_i, k);
        sj |= site_word(span_j, (uint64_t)dj, kind_j, k);
      }
      cand[c * nmw + k] = si & sj & okm[k];
      kn_i[c * nmw + k] = ki;
      kn_j[c * nmw + k] = kj;
    }
    __syncwarp();
    if (any) {
      any = 0;
      for (int e = 0; e < 2 * nmw; ++e) any |= cand[e];
    }
    // 4. the r-th candidate of the lane's class, scored
    if (any) s = nth_bit(cand + q * nmw, nmw, lane % kCands);
    if (s >= 0) {
      const bool sense = q == 0;
      const int oi = span_origin((uint64_t)di);
      const int oj = span_origin((uint64_t)dj);
      // sense: donor (short) on i, acceptor (long) on j; antisense:
      // antiacceptor (long) on i, antidonor (short) on j
      float p_short = 1.0f, p_long = 1.0f;
      if (novel)
        window_probs(tab, sense,
                     sense ? span_at(span_i, oi + s - 3)
                           : span_at(span_j, oj + s - 6),
                     sense ? span_at(span_j, oj + s - 20)
                           : span_at(span_i, oi + s - 3),
                     &p_short, &p_long);
      const int kw = q * nmw + (s >> 5), kb = s & 31;
      p_i = (kn_i[kw] >> kb) & 1 ? 1.0f : (sense ? p_short : p_long);
      p_j = (kn_j[kw] >> kb) & 1 ? 1.0f : (sense ? p_long : p_short);
      if (suff_local(s, pi[s], p_i) &&
          suff_local(len - s, tot_j - pj[s], p_j))
        prob = __fadd_rn(p_i, p_j);
    }
  }
  // 5. each class's first maximum (ties to the smaller s, and a slot
  // without a candidate last), within its half-warp
  int key_s = s < 0 ? 0x7FFFFFFF : s;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float op = __shfl_xor_sync(GSNAP_FULL_MASK, prob, o);
    const int os = __shfl_xor_sync(GSNAP_FULL_MASK, key_s, o);
    const float opi = __shfl_xor_sync(GSNAP_FULL_MASK, p_i, o);
    const float opj = __shfl_xor_sync(GSNAP_FULL_MASK, p_j, o);
    if (op > prob || (op == prob && os < key_s)) {
      prob = op; key_s = os; p_i = opi; p_j = opj;
    }
  }
  const float prob_a = __shfl_sync(GSNAP_FULL_MASK, prob, 16);
  const int s_a = __shfl_sync(GSNAP_FULL_MASK, key_s, 16);
  const float pi_a = __shfl_sync(GSNAP_FULL_MASK, p_i, 16);
  const float pj_a = __shfl_sync(GSNAP_FULL_MASK, p_j, 16);
  if (lane == 0) {
    const bool anti = prob_a > prob;
    const float w_prob = anti ? prob_a : prob;
    const int w_s = anti ? s_a : key_s;
    const bool v = pvalid[warp] && w_prob > 0.0f;
    valid_o[warp] = v;
    split_o[warp] = v ? w_s : 0;
    sense_o[warp] = !anti;
    // sense: donor on i, acceptor on j; antisense: donor on j
    prob_d_o[warp] = v ? (anti ? pj_a : p_i) : 0.0f;
    prob_a_o[warp] = v ? (anti ? pi_a : p_j) : 0.0f;
    nmm1_o[warp] = v ? pi[w_s] : 0;
    nmm2_o[warp] = v ? tot_j - pj[w_s] : 0;
    left_o[warp] = di;
    right_o[warp] = dj;
  }
}

}  // namespace

extern "C" int gsnap_solve_splices(
    const void* ref16, const void* tables, const void* top_d,
    const void* pref, const void* ii, const void* jj, const void* pvalid,
    const void* lengths, const void* budget, void* valid, void* split,
    void* sense, void* prob_d, void* prob_a, void* nmm1, void* nmm2,
    void* left, void* right, const void* kd, const void* ka,
    const void* kad, const void* kaa, int64_t nwords, int64_t kwords, int B,
    int P, int NC, int L, int novel, void* stream) {
  if (nwords < 1 || L < 1 || kwords < 0) return (int)cudaErrorInvalidValue;
  if (kwords > 0 && !(kd && ka && kad && kaa))
    return (int)cudaErrorInvalidValue;
  // as many warps a CTA as fit (fewer for long reads; one at the least)
  const int64_t per_warp = (int64_t)warp_words(L) * 4;
  const int64_t fit = kSmemMax / per_warp;
  const int warps = (int)(fit < kMaxWarps ? fit : kMaxWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * per_warp;
  const gsnap_maxent::Known known{{(const uint32_t*)kd, (const uint32_t*)ka,
                     (const uint32_t*)kad, (const uint32_t*)kaa},
                    kwords};
  if ((int64_t)B * P == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_splices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = ((int64_t)B * P + warps - 1) / warps;
  solve_splices_kernel<<<(unsigned)blocks, 32 * warps, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)ref16, (const float*)tables, (const int64_t*)top_d,
      (const int32_t*)pref, (const int64_t*)ii, (const int64_t*)jj,
      (const uint8_t*)pvalid, (const int32_t*)lengths,
      (const int32_t*)budget, (uint8_t*)valid, (int32_t*)split,
      (uint8_t*)sense, (float*)prob_d, (float*)prob_a, (int32_t*)nmm1,
      (int32_t*)nmm2, (int64_t*)left, (int64_t*)right, known, nwords, B, P,
      NC, L, novel);
  return (int)cudaGetLastError();
}
