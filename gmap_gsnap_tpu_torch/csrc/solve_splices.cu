// Kernel K5: local splices between diagonal pairs, novel and known.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _solve_splices (:515,
// with _fetch_span :502, _suff_local :495, ops/genome.fetch_span_codes
// :139, ops/maxent.splice_idx_span :160 and ops/select.table_lookup :49)
// — solve_singlesplice, stage1hr.c:6195.  One warp per (read, pair):
//   * lanes walk the scan positions s = 0..L in ceil((L+1)/32) passes;
//     s is a candidate of a sense class when 2 <= s <= len - 2, both
//     diagonals are >= 64, the mismatch sum pref_i[s] + (tot_j -
//     pref_j[s]) fits the budget and each side is a site of the class:
//     with `novel`, the genome carries its dinucleotides (sense: donor
//     GT on i at s, acceptor AG on j at s - 2; antisense: antiacceptor
//     CT on i, antidonor AC on j), read straight from the packed genome
//     words; or its known-site bit at d + s is set (the four bitvectors
//     of gsnap -s, `known_bit` in maxent.cuh, JAX :553-572);
//   * a ballot and a popc prefix keep the first SPLICE_CANDS (16)
//     candidates in ascending s — what top_k(-key, 16) keeps in JAX,
//     whose remaining slots are masked;
//   * each kept lane scores its position with float32 maxent
//     (maxent.cuh), 1.0 on a side that is a known site (JAX :619-620),
//     and the sufficiency gate; a warp reduction takes the
//     first maximum of prob_i + prob_j (ties to the smaller s);
//   * antisense wins only when strictly better.  Outputs of invalid
//     pairs are the JAX ones: sense = !(anti > sense), left/right = the
//     diagonals, the rest 0.
//
// Bound: latency of the genome and table reads (dependent __ldg loads
// per candidate, 8 factors for an acceptor); a pair reads two pref rows
// (~800 B, in L2 after K3), at most ~600 genome words and, with known
// sites, at most 2 x 4 bitvector words per lane pass.
#include "maxent.cuh"

namespace {

constexpr int kCands = 16;

struct Best {
  float prob;  // -1 when the class has no sufficient candidate
  int s;
  float p_i, p_j;
};

__device__ __forceinline__ void warp_best(Best& b) {
  for (int o = 16; o > 0; o >>= 1) {
    const float p = __shfl_xor_sync(GSNAP_FULL_MASK, b.prob, o);
    const int s = __shfl_xor_sync(GSNAP_FULL_MASK, b.s, o);
    const float pi = __shfl_xor_sync(GSNAP_FULL_MASK, b.p_i, o);
    const float pj = __shfl_xor_sync(GSNAP_FULL_MASK, b.p_j, o);
    if (p > b.prob || (p == b.prob && s < b.s)) {
      b.prob = p; b.s = s; b.p_i = pi; b.p_j = pj;
    }
  }
}

__global__ void solve_splices_kernel(
    const uint32_t* __restrict__ ref16, const float* __restrict__ tables,
    const int64_t* __restrict__ top_d, const int32_t* __restrict__ pref,
    const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
    const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ budget, uint8_t* __restrict__ valid_o,
    int32_t* __restrict__ split_o, uint8_t* __restrict__ sense_o,
    float* __restrict__ prob_d_o, float* __restrict__ prob_a_o,
    int32_t* __restrict__ nmm1_o, int32_t* __restrict__ nmm2_o,
    int64_t* __restrict__ left_o, int64_t* __restrict__ right_o,
    const gsnap_maxent::Known known, int64_t nwords, int B, int P, int NC, int L,
    int novel) {
  using namespace gsnap_maxent;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
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
  const int bud = budget[b];
  const bool margins = di >= 64 && dj >= 64;
  const uint32_t lt_mask = (1u << lane) - 1u;

  Best best[2];
  for (int cls = 0; cls < 2; ++cls) {
    const int kind_i = cls == 0 ? kDonor : kAntiacceptor;
    const int kind_j = cls == 0 ? kAcceptor : kAntidonor;
    Best bb{-1.0f, 0x7FFFFFFF, 0.0f, 0.0f};
    int count = 0;  // candidates seen so far (warp-uniform)
    for (int base = 0; base <= L && count < kCands; base += 32) {
      const int s = base + lane;
      bool cand = false;
      bool kn_i = false, kn_j = false;
      int mi = 0, mj = 0;
      if (margins && s >= 2 && s <= len - 2) {   // s <= len - 2 <= L
        mi = pi[s];
        mj = tot_j - pj[s];
        kn_i = known_bit(known, kind_i, (uint64_t)di + s);
        kn_j = known_bit(known, kind_j, (uint64_t)dj + s);
        cand = mi + mj <= bud &&
               (kn_i || (novel &&
                         site_at(ref16, nwords, kind_i, (uint64_t)di + s))) &&
               (kn_j || (novel &&
                         site_at(ref16, nwords, kind_j, (uint64_t)dj + s)));
      }
      const uint32_t m = __ballot_sync(GSNAP_FULL_MASK, cand);
      const int rank = count + __popc(m & lt_mask);
      if (cand && rank < kCands) {
        const float p_i =
            kn_i ? 1.0f
                 : prob(ref16, nwords, tables, kind_i, (uint64_t)di + s);
        const float p_j =
            kn_j ? 1.0f
                 : prob(ref16, nwords, tables, kind_j, (uint64_t)dj + s);
        if (suff_local(s, mi, p_i) && suff_local(len - s, mj, p_j)) {
          const float p = __fadd_rn(p_i, p_j);
          if (p > bb.prob) {  // ascending s within a lane: first max
            bb.prob = p; bb.s = s; bb.p_i = p_i; bb.p_j = p_j;
          }
        }
      }
      count += __popc(m);
    }
    warp_best(bb);
    best[cls] = bb;
  }

  if (lane == 0) {
    const bool anti = best[1].prob > best[0].prob;
    const Best& w = best[anti ? 1 : 0];
    const bool v = pvalid[warp] && w.prob > 0.0f;
    valid_o[warp] = v;
    split_o[warp] = v ? w.s : 0;
    sense_o[warp] = !anti;
    // sense: donor on i, acceptor on j; antisense: donor on j
    prob_d_o[warp] = v ? (anti ? w.p_j : w.p_i) : 0.0f;
    prob_a_o[warp] = v ? (anti ? w.p_i : w.p_j) : 0.0f;
    nmm1_o[warp] = v ? pi[w.s] : 0;
    nmm2_o[warp] = v ? tot_j - pj[w.s] : 0;
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
  const gsnap_maxent::Known known{{(const uint32_t*)kd, (const uint32_t*)ka,
                     (const uint32_t*)kad, (const uint32_t*)kaa},
                    kwords};
  if ((int64_t)B * P == 0) return 0;
  constexpr int kThreads = 256;
  solve_splices_kernel<<<gsnap_blocks((int64_t)B * P * 32, kThreads),
                         kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ref16, (const float*)tables, (const int64_t*)top_d,
      (const int32_t*)pref, (const int64_t*)ii, (const int64_t*)jj,
      (const uint8_t*)pvalid, (const int32_t*)lengths,
      (const int32_t*)budget, (uint8_t*)valid, (int32_t*)split,
      (uint8_t*)sense, (float*)prob_d, (float*)prob_a, (int32_t*)nmm1,
      (int32_t*)nmm2, (int64_t*)left, (int64_t*)right, known, nwords, B, P,
      NC, L, novel);
  return (int)cudaGetLastError();
}
