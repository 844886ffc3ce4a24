// Kernel K14: hit ranking, with the single-end gates as an epilogue.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py rank_hits (:1165) and,
// behind flags, the SE candidate-budget overflow gate (:1259-1305) and
// _lane_noop_device (:253).  Per read, over its n candidates:
//   - dup[i]: some j < i has equal (kind, split, split2, mid, right,
//     plusp, left) — the entries the chain of stable argsorts marks; a
//     duplicate's score (when below BIG) becomes BIG;
//   - the optimal filter (apply_optimal): scores above the row's best +
//     subopt become BIG;
//   - rank[i] = the number of j whose (score, left, !plusp, j) is
//     smaller (the stable sorts' order; left is an int64 holding a
//     uint32); ranks below nout = min(maxout, n) give the permutation.
// It writes the permutation, the final score (BIG where not below BIG)
// and npaths; the wrapper gathers the other fields.  The SE epilogue
// reads the ranked top and the unranked candidates' lane features: the
// overflow gate clears a row's flag when its done level sits below every
// lane gate or the dropped diagonals provably cannot reach it; the lane
// gate flags the candidates the host end-indel and terminal lanes must
// examine and whether the row is a no-op for them.
//
// Design: one CTA per read, the key fields in shared memory, O(n^2)
// compares split over the block's threads (n <= 512; 336 in the wide
// lane).  Bound: bytes — eight key fields of n candidates read once, the
// permutation and score of nout written (and with the epilogue 14
// features of the 2 NC candidates read, 2 flags each written).
#include "common.cuh"

namespace {

constexpr int kMaxCand = 512;
constexpr int kThreads = 256;
constexpr int kBig = 1000000;  // BIG_NMM
constexpr int kKindSub = 0;

struct LaneArgs {
  const int32_t *cand_nmm, *npos, *t5, *t3, *lowc, *lbc, *cle, *clt, *pfirst,
      *plast;
  const uint8_t* present;
  const int32_t *nmm_tt, *nmm_0t3, *nmm_t50;
};

__device__ __forceinline__ bool accept(int64_t La, int minlength, int t5v,
                                       int t3v, int nmm_trim, int cn, int d) {
  const int64_t span = La - t5v - t3v;
  bool ok = span > minlength;
  ok = ok && (span - nmm_trim) - 3 * (int64_t)nmm_trim >= 0;
  ok = ok && nmm_trim <= d;
  ok = ok && !(t5v == 0 && t3v == 0 && cn <= d);
  return ok;
}

__global__ void __launch_bounds__(kThreads) rank_hits_kernel(
    const int32_t* __restrict__ kind, const int32_t* __restrict__ split,
    const int32_t* __restrict__ split2, const int64_t* __restrict__ mid,
    const int64_t* __restrict__ right, const uint8_t* __restrict__ plusp,
    const int64_t* __restrict__ left, const int32_t* __restrict__ score,
    int64_t* __restrict__ perm_o, int32_t* __restrict__ score_o,
    int32_t* __restrict__ npaths_o, const int32_t* __restrict__ lengths,
    const uint8_t* __restrict__ ovf_in, const uint8_t* __restrict__ ovf_trunc,
    const int32_t* __restrict__ ovf_bound, const int32_t* __restrict__ hbound,
    uint8_t* __restrict__ ovf_o, LaneArgs la, uint8_t* __restrict__ noop_o,
    uint8_t* __restrict__ ind_o, uint8_t* __restrict__ term_o, int n,
    int nout, int subopt, int apply_optimal, int gate, int lane_gate,
    int max_mismatches, int noop, int nc2, int k, int interval,
    int indel_penalty_end, int terminal_threshold) {
  __shared__ int32_t s_kind[kMaxCand], s_split[kMaxCand], s_split2[kMaxCand];
  __shared__ int32_t s_sc[kMaxCand], s_perm[kMaxCand];
  __shared__ int64_t s_mid[kMaxCand], s_right[kMaxCand], s_left[kMaxCand];
  __shared__ uint8_t s_plus[kMaxCand];
  __shared__ int32_t s_best, s_np, s_any;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t row = b * n;
  for (int i = tid; i < n; i += blockDim.x) {
    s_kind[i] = kind[row + i];
    s_split[i] = split[row + i];
    s_split2[i] = split2[row + i];
    s_mid[i] = mid[row + i];
    s_right[i] = right[row + i];
    s_left[i] = left[row + i];
    s_plus[i] = plusp[row + i] != 0;
  }
  if (tid == 0) {
    s_best = INT32_MAX;
    s_np = 0;
    s_any = 0;
  }
  __syncthreads();

  // dedup on the seven fields, then the row's best score
  for (int i = tid; i < n; i += blockDim.x) {
    bool dup = false;
    for (int j = 0; j < i && !dup; ++j)
      dup = s_kind[j] == s_kind[i] && s_split[j] == s_split[i] &&
            s_split2[j] == s_split2[i] && s_mid[j] == s_mid[i] &&
            s_right[j] == s_right[i] && s_plus[j] == s_plus[i] &&
            s_left[j] == s_left[i];
    int sc = score[row + i];
    if (dup && sc < kBig) sc = kBig;
    s_sc[i] = sc;
    atomicMin(&s_best, sc);
  }
  __syncthreads();
  if (apply_optimal) {
    const int64_t cut = (int64_t)s_best + subopt;
    for (int i = tid; i < n; i += blockDim.x)
      if (s_sc[i] > cut) s_sc[i] = kBig;
    __syncthreads();
  }

  // rank by (score, left, !plusp, index)
  for (int i = tid; i < n; i += blockDim.x) {
    const int si = s_sc[i];
    const int64_t li = s_left[i];
    const int pi = s_plus[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const int sj = s_sc[j];
      const int64_t lj = s_left[j];
      const int pj = s_plus[j];
      r += sj < si ||
           (sj == si && (lj < li || (lj == li && (pj > pi ||
                                                  (pj == pi && j < i)))));
    }
    if (r < nout) s_perm[r] = i;
  }
  __syncthreads();
  for (int r = tid; r < nout; r += blockDim.x) {
    const int i = s_perm[r];
    const int sc = s_sc[i];
    perm_o[b * nout + r] = i;
    score_o[b * nout + r] = sc < kBig ? sc : kBig;
    if (sc < kBig) atomicAdd(&s_np, 1);
  }
  __syncthreads();
  const int np = s_np;
  if (tid == 0) npaths_o[b] = np;
  if (!gate && !noop) return;

  // SE epilogue: the ranked top and the read's length
  const int top = s_sc[s_perm[0]] < kBig ? s_sc[s_perm[0]] : kBig;
  const int La = lengths[b];
  const int spansize = ((k + interval - 1) / interval) * interval;
  const int auto_budget = max((La + interval - 1) / spansize - 2, 0);
  if (gate && tid == 0) {
    const int budget = max_mismatches >= 0 ? max_mismatches : auto_budget;
    const int done = min(budget, np > 0 ? top : kBig);
    const bool safe = ((done + subopt < lane_gate) ||
                       (np > 0 && hbound[b] > done + subopt)) &&
                      ovf_bound[b] > done + subopt && !ovf_trunc[b];
    ovf_o[b] = ovf_in[b] && !safe;
  }
  if (!noop) return;
  const int done = min(auto_budget, np > 0 ? top : kBig);
  const int lastpos = La - k;
  const int minlength = min(La / 3, 40);
  for (int c = tid; c < nc2; c += blockDim.x) {
    const int64_t x = b * nc2 + c;
    const int cn = la.cand_nmm[x];
    const bool valid = cn < kBig;
    const int d = done;
    const int mmi = d - indel_penalty_end;
    const int npos = la.npos[x], lowc = la.lowc[x], lbc = la.lbc[x];
    const bool ind_entry =
        npos > 0 && ((lowc >= 1 && npos - lowc <= mmi) ||
                     (npos - lbc >= 1 && lbc <= mmi));
    const bool ind = done >= indel_penalty_end && valid && ind_entry;
    const int t5 = la.t5[x], t3 = la.t3[x];
    const int pfirst = la.pfirst[x], plast = la.plast[x];
    const bool longb = la.present[x] && plast - pfirst > k;
    const bool st = pfirst >= interval;
    const bool et = plast < lastpos - interval;
    const int lt5 = st ? t5 : 0, lt3 = et ? t3 : 0;
    const int nmm_long = st && et ? la.nmm_tt[x]
                         : st     ? la.nmm_t50[x]
                         : et     ? la.nmm_0t3[x]
                                  : npos;
    const bool v_long = longb && accept(La, minlength, lt5, lt3, nmm_long,
                                        cn, d);
    const bool c1 = npos <= d || la.cle[x] <= d;
    const bool c2 = npos <= d || la.clt[x] >= npos - d;
    const bool v1 = !longb && c1 &&
                    accept(La, minlength, 0, t3, la.nmm_0t3[x], cn, d);
    const bool v2 = !longb && c2 &&
                    accept(La, minlength, t5, 0, la.nmm_t50[x], cn, d);
    const bool term =
        done >= terminal_threshold && valid && (v_long || v1 || v2);
    ind_o[x] = ind;
    term_o[x] = term;
    if (ind || term) s_any = 1;
  }
  __syncthreads();
  if (tid == 0) {
    const bool gated = np == 1 && s_kind[s_perm[0]] == kKindSub;
    noop_o[b] = gated && !s_any;
  }
}

}  // namespace

extern "C" int gsnap_rank_hits(
    const void* kind, const void* split, const void* split2, const void* mid,
    const void* right, const void* plusp, const void* left, const void* score,
    void* perm, void* score_o, void* npaths, const void* lengths,
    const void* ovf_in, const void* ovf_trunc, const void* ovf_bound,
    const void* hbound, void* ovf_o, const void* cand_nmm, const void* npos,
    const void* t5, const void* t3, const void* lowc, const void* lbc,
    const void* cle, const void* clt, const void* pfirst, const void* plast,
    const void* present, const void* nmm_tt, const void* nmm_0t3,
    const void* nmm_t50, void* noop_o, void* ind_o, void* term_o, int B,
    int n, int nout, int subopt, int apply_optimal, int gate, int lane_gate,
    int max_mismatches, int noop, int nc2, int k, int interval,
    int indel_penalty_end, int terminal_threshold, void* stream) {
  if (n < 1 || n > kMaxCand || nout < 1 || nout > n)
    return (int)cudaErrorInvalidValue;
  if ((gate || noop) && (lengths == nullptr || k < 1 || interval < 1))
    return (int)cudaErrorInvalidValue;
  if (gate && (ovf_in == nullptr || ovf_o == nullptr))
    return (int)cudaErrorInvalidValue;
  if (noop && (noop_o == nullptr || present == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  LaneArgs la{(const int32_t*)cand_nmm, (const int32_t*)npos,
              (const int32_t*)t5,       (const int32_t*)t3,
              (const int32_t*)lowc,     (const int32_t*)lbc,
              (const int32_t*)cle,      (const int32_t*)clt,
              (const int32_t*)pfirst,   (const int32_t*)plast,
              (const uint8_t*)present,  (const int32_t*)nmm_tt,
              (const int32_t*)nmm_0t3,  (const int32_t*)nmm_t50};
  rank_hits_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)kind, (const int32_t*)split, (const int32_t*)split2,
      (const int64_t*)mid, (const int64_t*)right, (const uint8_t*)plusp,
      (const int64_t*)left, (const int32_t*)score, (int64_t*)perm,
      (int32_t*)score_o, (int32_t*)npaths, (const int32_t*)lengths,
      (const uint8_t*)ovf_in, (const uint8_t*)ovf_trunc,
      (const int32_t*)ovf_bound, (const int32_t*)hbound, (uint8_t*)ovf_o, la,
      (uint8_t*)noop_o, (uint8_t*)ind_o, (uint8_t*)term_o, n, nout, subopt,
      apply_optimal, gate, lane_gate, max_mismatches, noop, nc2, k, interval,
      indel_penalty_end, terminal_threshold);
  return (int)cudaGetLastError();
}
