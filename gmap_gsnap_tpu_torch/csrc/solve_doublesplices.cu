// Kernel K7: short middle exons between two local introns.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _solve_doublesplices
// (:706, with _fetch_span :502 and the maxent lookups of ops/maxent
// :160 / ops/select :49) — solve_doublesplice, stage1hr.c:6612.  One warp
// per (read, triple i -> m -> j), for each sense class in turn:
//   * lanes walk s = 0..L; junction 1 is a candidate at s when 2 <= s <=
//     len - 2, all three diagonals are >= 64 and each side is a site of
//     the class's first junction: with `novel`, by its dinucleotides
//     (sense: donor GT on i at s, acceptor AG on m at s - 2; antisense:
//     antiacceptor CT on i, antidonor AC on m), or by its known-site bit
//     at d + s (gsnap -s, `known_bit` in maxent.cuh, JAX :753-764);
//     junction 2 likewise on (m, j).  A ballot and a popc prefix keep
//     the first K = 8 of each in ascending s (JAX: top_k of the negated
//     key) in shared memory;
//   * lanes 0-7 score junction-1 slot k (maxent on i and m, 1.0 on a
//     known site, as JAX :808-811; mismatches
//     before s on i and on m), lanes 8-15 junction-2 slot k (maxent on m
//     and j, mismatches before s on m and from s on j);
//   * the 8 x 8 grid is 64 cells, two per lane, read from those lanes by
//     shuffles: a cell needs s2 > s1, the mismatch total within the
//     budget and all four probabilities sufficient; its key is
//     -total * 8 + (((p1i + p1m) + p2m) + p2j) in float32 (-1e9 when not
//     valid), and a warp reduction takes the first maximum in s1-major
//     cell order;
//   * antisense wins only when its key is strictly greater.  Outputs of
//     invalid triples are the JAX ones: sense = !(anti > sense), left /
//     mid / right = the diagonals, the rest 0.
//
// Bound: latency of the dependent genome and table reads of at most 32
// maxent evaluations per triple and class; device memory traffic is three
// pref rows (~1.2 KB, in L2 after K3) per triple, plus with known sites
// at most 4 bitvector words per lane pass.
#include "maxent.cuh"

namespace {

constexpr int kK = 8;
constexpr int kWarpsPerBlock = 8;

struct Cell {
  float key;
  int cell;
};

__device__ __forceinline__ void better(Cell& a, float key, int cell) {
  if (key > a.key || (key == a.key && cell < a.cell)) {
    a.key = key;
    a.cell = cell;
  }
}

struct Result {
  float score, p1i, p1m, p2m, p2j;
  int sp1, sp2, nmm1, nmm2, nmm3;
};

// first kK candidates of `cand` for this warp, ascending s, into sel;
// returns how many there are (warp-uniform)
template <typename Pred>
__device__ __forceinline__ int first_cands(int L, int lane, int* sel,
                                           Pred cand_at) {
  const uint32_t lt_mask = (1u << lane) - 1u;
  int count = 0;
  for (int base = 0; base <= L && count < kK; base += 32) {
    const int s = base + lane;
    const bool c = s <= L && cand_at(s);
    const uint32_t m = __ballot_sync(GSNAP_FULL_MASK, c);
    const int rank = count + __popc(m & lt_mask);
    if (c && rank < kK) sel[rank] = s;
    count += __popc(m);
  }
  __syncwarp();
  return count < kK ? count : kK;
}

__device__ Result solve_class(const uint32_t* __restrict__ ref16,
                              int64_t nwords, const float* __restrict__ tab,
                              const gsnap_maxent::Known& known, int novel,
                              int cls, int64_t di, int64_t dm, int64_t dj,
                              const int32_t* pi, const int32_t* pm,
                              const int32_t* pj, int len, int tot_j, int bud,
                              int L, int lane, int* sel1, int* sel2) {
  using namespace gsnap_maxent;
  const int k1i = cls == 0 ? kDonor : kAntiacceptor;   // junction 1 on i
  const int k1m = cls == 0 ? kAcceptor : kAntidonor;   // junction 1 on m
  const int k2m = k1i;                                 // junction 2 on m
  const int k2j = k1m;                                 // junction 2 on j
  const bool margins = di >= 64 && dm >= 64 && dj >= 64;
  auto inb = [&](int s) { return margins && s >= 2 && s <= len - 2; };
  // a site of class `kind` on the segment at diagonal d, scan position s
  auto site = [&](int kind, int64_t d, int s) {
    return known_bit(known, kind, (uint64_t)d + s) ||
           (novel && site_at(ref16, nwords, kind, (uint64_t)d + s));
  };
  // maxent probability there, 1.0 at a known site
  auto p_at = [&](int kind, int64_t d, int s) {
    return known_bit(known, kind, (uint64_t)d + s)
               ? 1.0f
               : prob(ref16, nwords, tab, kind, (uint64_t)d + s);
  };
  const int n1 = first_cands(L, lane, sel1, [&](int s) {
    return inb(s) && site(k1i, di, s) && site(k1m, dm, s);
  });
  const int n2 = first_cands(L, lane, sel2, [&](int s) {
    return inb(s) && site(k2m, dm, s) && site(k2j, dj, s);
  });

  // per-slot values: lanes 0-7 junction 1, lanes 8-15 junction 2
  float pa = 0.0f, pb = 0.0f;  // (p1i, p1m) or (p2m, p2j)
  int s = 0, ma = 0, mb = 0;   // (nmm_i, cum_m) or (cum_m, suffix on j)
  if (lane < kK && lane < n1) {
    s = sel1[lane];
    pa = p_at(k1i, di, s);
    pb = p_at(k1m, dm, s);
    ma = pi[s];
    mb = pm[s];
  } else if (lane >= kK && lane < 2 * kK && lane - kK < n2) {
    s = sel2[lane - kK];
    pa = p_at(k2m, dm, s);
    pb = p_at(k2j, dj, s);
    ma = pm[s];
    mb = tot_j - pj[s];
  }

  Cell best{-1e9f, 0x7FFFFFFF};
  for (int h = 0; h < 2; ++h) {
    const int cell = lane + 32 * h;
    const int a = cell / kK, c = cell % kK;  // slot of junction 1 / 2
    const int s1 = __shfl_sync(GSNAP_FULL_MASK, s, a);
    const float p1i = __shfl_sync(GSNAP_FULL_MASK, pa, a);
    const float p1m = __shfl_sync(GSNAP_FULL_MASK, pb, a);
    const int mi1 = __shfl_sync(GSNAP_FULL_MASK, ma, a);
    const int cm1 = __shfl_sync(GSNAP_FULL_MASK, mb, a);
    const int s2 = __shfl_sync(GSNAP_FULL_MASK, s, kK + c);
    const float p2m = __shfl_sync(GSNAP_FULL_MASK, pa, kK + c);
    const float p2j = __shfl_sync(GSNAP_FULL_MASK, pb, kK + c);
    const int cm2 = __shfl_sync(GSNAP_FULL_MASK, ma, kK + c);
    const int mj2 = __shfl_sync(GSNAP_FULL_MASK, mb, kK + c);
    float key = -1e9f;
    if (a < n1 && c < n2 && s2 > s1) {
      const int nmm2 = cm2 - cm1;
      const int total = mi1 + nmm2 + mj2;
      if (total <= bud && nmm2 >= 0 && suff_local(s1, mi1, p1i) &&
          suff_local(s2 - s1, nmm2, p1m) && suff_local(s2 - s1, nmm2, p2m) &&
          suff_local(len - s2, mj2, p2j)) {
        const float p = __fadd_rn(__fadd_rn(__fadd_rn(p1i, p1m), p2m), p2j);
        key = __fadd_rn(__fmul_rn(-(float)total, 8.0f), p);
      }
    }
    better(best, key, cell);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float k = __shfl_xor_sync(GSNAP_FULL_MASK, best.key, o);
    const int c = __shfl_xor_sync(GSNAP_FULL_MASK, best.cell, o);
    better(best, k, c);
  }

  // the winning cell's slots (cell 0 when none is valid: masked later)
  const int a = best.cell / kK, c = best.cell % kK;
  Result r;
  r.score = best.key;
  r.sp1 = __shfl_sync(GSNAP_FULL_MASK, s, a);
  r.p1i = __shfl_sync(GSNAP_FULL_MASK, pa, a);
  r.p1m = __shfl_sync(GSNAP_FULL_MASK, pb, a);
  const int mi1 = __shfl_sync(GSNAP_FULL_MASK, ma, a);
  const int cm1 = __shfl_sync(GSNAP_FULL_MASK, mb, a);
  r.sp2 = __shfl_sync(GSNAP_FULL_MASK, s, kK + c);
  r.p2m = __shfl_sync(GSNAP_FULL_MASK, pa, kK + c);
  r.p2j = __shfl_sync(GSNAP_FULL_MASK, pb, kK + c);
  const int cm2 = __shfl_sync(GSNAP_FULL_MASK, ma, kK + c);
  r.nmm3 = __shfl_sync(GSNAP_FULL_MASK, mb, kK + c);
  r.nmm1 = mi1;
  r.nmm2 = cm2 - cm1;
  __syncwarp();  // sel1/sel2 are reused by the next class
  return r;
}

__global__ void solve_doublesplices_kernel(
    const uint32_t* __restrict__ ref16, const float* __restrict__ tables,
    const int64_t* __restrict__ top_d, const int32_t* __restrict__ pref,
    const int64_t* __restrict__ ti, const int64_t* __restrict__ tm,
    const int64_t* __restrict__ tj, const uint8_t* __restrict__ tvalid,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ budget,
    uint8_t* __restrict__ valid_o, int32_t* __restrict__ split_o,
    int32_t* __restrict__ split2_o, uint8_t* __restrict__ sense_o,
    float* __restrict__ prob_d_o, float* __restrict__ prob_a_o,
    float* __restrict__ prob_d2_o, float* __restrict__ prob_a2_o,
    int32_t* __restrict__ nmm1_o, int32_t* __restrict__ nmm2_o,
    int32_t* __restrict__ nmm3_o, int64_t* __restrict__ left_o,
    int64_t* __restrict__ mid_o, int64_t* __restrict__ right_o,
    const gsnap_maxent::Known known, int64_t nwords, int B, int T, int NC, int L,
    int novel) {
  __shared__ int s_sel[kWarpsPerBlock][2 * kK];
  const int wib = threadIdx.x >> 5;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + wib;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * T) return;  // warp-uniform exit
  const int64_t b = warp / T;
  const int64_t ci = b * NC + ti[warp];
  const int64_t cm = b * NC + tm[warp];
  const int64_t cj = b * NC + tj[warp];
  const int64_t di = top_d[ci], dm = top_d[cm], dj = top_d[cj];
  const int32_t* pi = pref + ci * (L + 1);
  const int32_t* pm = pref + cm * (L + 1);
  const int32_t* pj = pref + cj * (L + 1);
  const int len = lengths[b];
  const int tot_j = pj[len];
  const int bud = budget[b];
  int* sel1 = s_sel[wib];
  int* sel2 = s_sel[wib] + kK;

  const Result sense = solve_class(ref16, nwords, tables, known, novel, 0,
                                   di, dm, dj, pi, pm, pj, len, tot_j, bud,
                                   L, lane, sel1, sel2);
  const Result anti = solve_class(ref16, nwords, tables, known, novel, 1,
                                  di, dm, dj, pi, pm, pj, len, tot_j, bud, L,
                                  lane, sel1, sel2);
  if (lane == 0) {
    const bool use_anti = anti.score > sense.score;
    const Result& w = use_anti ? anti : sense;
    const bool v = tvalid[warp] && w.score > -1e8f;
    valid_o[warp] = v;
    split_o[warp] = v ? w.sp1 : 0;
    split2_o[warp] = v ? w.sp2 : 0;
    sense_o[warp] = !use_anti;
    // junction probabilities in donor/acceptor display order
    prob_d_o[warp] = v ? (use_anti ? anti.p2j : sense.p1i) : 0.0f;
    prob_a_o[warp] = v ? (use_anti ? anti.p2m : sense.p1m) : 0.0f;
    prob_d2_o[warp] = v ? (use_anti ? anti.p1m : sense.p2m) : 0.0f;
    prob_a2_o[warp] = v ? (use_anti ? anti.p1i : sense.p2j) : 0.0f;
    nmm1_o[warp] = v ? w.nmm1 : 0;
    nmm2_o[warp] = v ? w.nmm2 : 0;
    nmm3_o[warp] = v ? w.nmm3 : 0;
    left_o[warp] = di;
    mid_o[warp] = dm;
    right_o[warp] = dj;
  }
}

}  // namespace

extern "C" int gsnap_solve_doublesplices(
    const void* ref16, const void* tables, const void* top_d,
    const void* pref, const void* ti, const void* tm, const void* tj,
    const void* tvalid, const void* lengths, const void* budget,
    void* valid, void* split, void* split2, void* sense, void* prob_d,
    void* prob_a, void* prob_d2, void* prob_a2, void* nmm1, void* nmm2,
    void* nmm3, void* left, void* mid, void* right, const void* kd,
    const void* ka, const void* kad, const void* kaa, int64_t nwords,
    int64_t kwords, int B, int T, int NC, int L, int novel, void* stream) {
  if (nwords < 1 || L < 1 || kwords < 0) return (int)cudaErrorInvalidValue;
  if (kwords > 0 && !(kd && ka && kad && kaa))
    return (int)cudaErrorInvalidValue;
  const gsnap_maxent::Known known{{(const uint32_t*)kd, (const uint32_t*)ka,
                     (const uint32_t*)kad, (const uint32_t*)kaa},
                    kwords};
  if ((int64_t)B * T == 0) return 0;
  const int64_t blocks = ((int64_t)B * T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  solve_doublesplices_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)ref16, (const float*)tables, (const int64_t*)top_d,
      (const int32_t*)pref, (const int64_t*)ti, (const int64_t*)tm,
      (const int64_t*)tj, (const uint8_t*)tvalid, (const int32_t*)lengths,
      (const int32_t*)budget, (uint8_t*)valid, (int32_t*)split,
      (int32_t*)split2, (uint8_t*)sense, (float*)prob_d, (float*)prob_a,
      (float*)prob_d2, (float*)prob_a2, (int32_t*)nmm1, (int32_t*)nmm2,
      (int32_t*)nmm3, (int64_t*)left, (int64_t*)mid, (int64_t*)right, known,
      nwords, B, T, NC, L, novel);
  return (int)cudaGetLastError();
}
