// Kernel K8: the paired-end pairing grid and pair ranking.
//
// Replaces gmap_gsnap_tpu/align/gsnap_pe.py align_batch_pe :119-239
// (Stage3_pair_up_concordant + Stage3_determine_pairtype, stage3hr.c:5074,
// + Stage3pair_optimal_score, stage3hr.c:9719).  Per read pair, over the
// NP x NP cells (end-5 hit i5, end-3 hit i3), NP <= 16:
//   * each hit's refspan, end, chromosome (upper bound of its uint32 left
//     in chr_offsets) and up to three aligned-part intervals, all in int32
//     with the JAX function's wraparound: sums are taken as uint32 and
//     reinterpreted, since signed overflow is undefined in C++;
//   * the pair type, the concordant and outer inserts, the 3 x 3 part
//     overlap behind the insert-0 rejection, the pair score;
//   * concordant cells dominate the paired ones (__syncthreads_or), cells
//     above the best score + subopt drop (block minimum), and the rest are
//     ranked by one ascending bitonic sort of 64-bit keys
//         eff << 16 | r5 << 12 | r3 << 8 | (i5 * NP + i3)
//     where r5 / r3 are the ranks of the cell's left5 / left3 among the
//     row's NP values (equal values share a rank).  r5 is taken on
//     float32(int32 left5), r3 on the exact int32 left3: the JAX function
//     sorts left5 after a float32 one-hot selection (ops/select.take_cols),
//     so this key gives exactly the order of its three stable argsorts
//     (eff, rounded left5, left3, cell index); eff < 2^21;
//   * the first K keys give i5, i3, pairtype, the insert (rounded through
//     float32 and back, saturating, as take_cols returns it) and the pair
//     score; unfilled slots are 0, 0, PT_UNPAIRED, 0, BIG;
//   * with `gate` set (no known splice sites), the epilogue is the
//     candidate-budget overflow gate, pair form (gsnap_pe.py :241-283):
//     thread 0 takes the row's concordance, npairs, best pair score and
//     the ends' best scores and bounds, and clears each end's overflow
//     flag when the pair is safe and that end did not truncate.  Its sums
//     are int32 in JAX and wrap there; here they are taken as uint32 and
//     reinterpreted, so any bound value gives the same answer.
//
// Bound: tiny work — one CTA of NP^2 = 256 threads per pair, 2048 CTAs per
// batch, 32 hit rows in, 5 x K int32 out.  Launch- and latency-bound: the
// block does two loads of its 2 x NP hits into shared memory, a handful of
// barriers and the 36 compare-exchange steps of a 256-key bitonic sort.
#include "common.cuh"

namespace {

constexpr int kNP = 16;
constexpr int kCells = kNP * kNP;
constexpr int kPairUnpaired = 4;
constexpr int kPtConcordant = 0, kPtInversion = 1, kPtScramble = 2,
              kPtToolong = 3;
constexpr int kKindIns = 1, kKindDel = 2, kKindSplice = 3,
              kKindShortexon = 4;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

struct HitRows {  // one end's ranked pairing hits, [B, NP] each
  const int64_t* left;
  const int64_t* right;
  const int64_t* mid;
  const int32_t* kind;
  const int32_t* split;
  const int32_t* split2;
  const int32_t* nindels;
  const int32_t* score;
  const bool* plusp;
};

struct PairGate {  // the ends' overflow state, [B] each, and the settings
  const bool* ovf5;
  const bool* trunc5;
  const int32_t* bound5;
  const int32_t* hb5;
  const bool* ovf3;
  const bool* trunc3;
  const int32_t* bound3;
  const int32_t* hb3;
  bool* ovf5_o;
  bool* ovf3_o;
  int on, indel_penalty_middle, novel;
};

struct EndShared {  // the same hits staged in shared memory, derived form
  int32_t left[kNP], end[kNP], score[kNP];
  int32_t lo[3][kNP], hi[3][kNP];
  int64_t chr[kNP];
  bool ok[3][kNP];
  bool plus[kNP];
  float rounded[kNP];   // float32(int32 left): the left5 sort value
  int rank[kNP];
};

__device__ void stage_hit(const HitRows& h, int64_t o, int32_t L,
                          const int64_t* __restrict__ chr_offsets, int nchr1,
                          EndShared& s, int j) {
  const uint32_t uleft = (uint32_t)h.left[o];
  const int32_t left = (int32_t)uleft;
  const int32_t right = (int32_t)(uint32_t)h.right[o];
  const int32_t mid = (int32_t)(uint32_t)h.mid[o];
  const int kind = h.kind[o];
  const int32_t split = h.split[o], split2 = h.split2[o];
  const int32_t nind = h.nindels[o];
  const int32_t span =
      kind == kKindDel      ? add32(L, nind)
      : kind == kKindIns    ? sub32(L, nind)
      : kind == kKindSplice ? add32(L, sub32(right, left))
                            : L;
  s.left[j] = left;
  s.end[j] = add32(left, span);
  s.score[j] = h.score[o];
  s.plus[j] = h.plusp[o];
  s.rounded[j] = __int2float_rn(left);
  // searchsorted(chr_offsets, left, side="right")
  int lo = 0, hi = nchr1;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (chr_offsets[m] <= (int64_t)uleft) lo = m + 1;
    else hi = m;
  }
  s.chr[j] = lo;
  const bool multi = kind == kKindSplice || kind == kKindDel ||
                     kind == kKindIns || kind == kKindShortexon;
  s.lo[0][j] = left;
  s.hi[0][j] = add32(left, multi ? split : L);
  s.ok[0][j] = true;
  s.lo[1][j] = kind == kKindShortexon ? add32(mid, split)
               : kind == kKindIns     ? add32(add32(right, split), nind)
                                      : add32(right, split);
  s.hi[1][j] = kind == kKindShortexon ? add32(mid, split2) : add32(right, L);
  s.ok[1][j] = multi;
  s.lo[2][j] = add32(right, split2);
  s.hi[2][j] = add32(right, L);
  s.ok[2][j] = kind == kKindShortexon;
}

__global__ void __launch_bounds__(kCells)
pair_grid_kernel(HitRows h5, HitRows h3, const int32_t* __restrict__ len5,
                 const int32_t* __restrict__ len3,
                 const int64_t* __restrict__ chr_offsets, int32_t* i5_o,
                 int32_t* i3_o, int32_t* pairtype_o, int32_t* insert_o,
                 int32_t* pscore_o, int32_t* npairs_o, bool* concordant_o,
                 PairGate g, int np, int K, int nchr1, int32_t pairmax,
                 int32_t subopt) {
  __shared__ EndShared s5, s3;
  __shared__ uint64_t keys[kCells];
  __shared__ int32_t s_insert[kCells];
  __shared__ int8_t s_type[kCells];
  __shared__ int32_t s_best;
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t L5 = len5[row], L3 = len3[row];

  if (t < np) stage_hit(h5, row * np + t, L5, chr_offsets, nchr1, s5, t);
  else if (t >= kNP && t < kNP + np)
    stage_hit(h3, row * np + t - kNP, L3, chr_offsets, nchr1, s3, t - kNP);
  if (t == 0) s_best = GSNAP_BIG_SCORE;
  __syncthreads();
  if (t < np) {   // ranks with ties shared: count of strictly smaller
    int r5 = 0, r3 = 0;
    for (int k = 0; k < np; ++k) {
      r5 += s5.rounded[k] < s5.rounded[t];
      r3 += s3.left[k] < s3.left[t];
    }
    s5.rank[t] = r5;
    s3.rank[t] = r3;
  }

  // this thread's cell
  const bool active = t < np * np;
  const int a = active ? t / np : 0, c = active ? t % np : 0;
  const int32_t l5 = s5.left[a], e5 = s5.end[a];
  const int32_t l3 = s3.left[c], e3 = s3.end[c];
  const bool p5 = s5.plus[a], p3 = s3.plus[c];
  int pt;
  if (s5.chr[a] != s3.chr[c]) pt = kPairUnpaired;
  else if (p5 != p3) pt = kPtInversion;
  else if (p5) pt = e3 < l5 ? kPtScramble
                   : l3 > add32(e5, pairmax) ? kPtToolong : kPtConcordant;
  else pt = l3 > e5 ? kPtScramble
            : add32(e3, pairmax) < l5 ? kPtToolong : kPtConcordant;
  const bool valid = s5.score[a] < GSNAP_BIG_SCORE && s3.score[c] < GSNAP_BIG_SCORE;
  const int32_t insert =
      pt == kPtConcordant ? (p5 ? sub32(e3, l5) : sub32(e5, l3))
                          : sub32(max(e5, e3), min(l5, l3));
  const int32_t pscore = s5.score[a] + s3.score[c];
  bool overlap = false;
  for (int x = 0; x < 3; ++x)
    for (int y = 0; y < 3; ++y)
      overlap |= s5.ok[x][a] && s3.ok[y][c] &&
                 !(s3.hi[y][c] < s5.lo[x][a] || s3.lo[y][c] > s5.hi[x][a]);
  const int32_t q = L5 + L3;
  const bool insert0 = !overlap && (p5 ? e5 > add32(l3, q) : e3 > add32(l5, q));
  const bool conc = active && valid && pt == kPtConcordant && !insert0;
  const bool paired = active && valid &&
                      (pt == kPtInversion || pt == kPtScramble || pt == kPtToolong);
  const bool have_conc = __syncthreads_or(conc);
  int32_t eff = (have_conc ? conc : paired) ? pscore : GSNAP_BIG_SCORE;
  if (eff < GSNAP_BIG_SCORE) atomicMin(&s_best, eff);
  s_insert[t] = insert;
  s_type[t] = (int8_t)pt;
  __syncthreads();
  if (eff > s_best + subopt) eff = GSNAP_BIG_SCORE;
  keys[t] = active ? ((uint64_t)eff << 16) | ((uint64_t)s5.rank[a] << 12) |
                         ((uint64_t)s3.rank[c] << 8) | (uint64_t)t
                   : ~0ull;
  __syncthreads();

  for (int k = 2; k <= kCells; k <<= 1) {   // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int ixj = t ^ j;
      if (ixj > t) {
        const uint64_t x = keys[t], y = keys[ixj];
        if ((x > y) == ((t & k) == 0)) {
          keys[t] = y;
          keys[ixj] = x;
        }
      }
      __syncthreads();
    }
  }

  const uint64_t key = keys[t];
  const int32_t eff2 = (int32_t)(key >> 16);
  const bool ok = t < K && eff2 < GSNAP_BIG_SCORE;
  const int npairs = __syncthreads_count(ok);
  if (t < K) {
    const int flat = (int)(key & 0xFFu);
    const int64_t o = row * K + t;
    i5_o[o] = ok ? flat / np : 0;
    i3_o[o] = ok ? flat % np : 0;
    pairtype_o[o] = ok ? s_type[flat] : kPairUnpaired;
    insert_o[o] = ok ? __float2int_rn(__int2float_rn(s_insert[flat])) : 0;
    pscore_o[o] = ok ? eff2 : GSNAP_BIG_SCORE;
  }
  if (t == 0) {
    npairs_o[row] = npairs;
    concordant_o[row] = have_conc;
  }
  if (t == 0 && g.on) {
    const int32_t pbest = ok ? eff2 : GSNAP_BIG_SCORE;
    const int32_t s5b = s5.score[0], s3b = s3.score[0];
    const int32_t b5 = g.bound5[row], b3 = g.bound3[row];
    const int32_t hb5 = g.hb5[row], hb3 = g.hb3[row];
    const int32_t top = add32(pbest, subopt);
    const bool conc_ok = have_conc && npairs > 0;
    const bool sub_ok = add32(b5, s3b) > top && add32(b3, s5b) > top &&
                        add32(b5, b3) > top;
    const int32_t alloc5 = sub32(top, s3b), alloc3 = sub32(top, s5b);
    bool ind_ok = (alloc5 < g.indel_penalty_middle || hb5 > alloc5) &&
                  (alloc3 < g.indel_penalty_middle || hb3 > alloc3);
    if (g.novel) ind_ok = ind_ok && hb5 > alloc5 && hb3 > alloc3;
    const bool safe = conc_ok && sub_ok && ind_ok;
    g.ovf5_o[row] = g.ovf5[row] && !(safe && !g.trunc5[row]);
    g.ovf3_o[row] = g.ovf3[row] && !(safe && !g.trunc3[row]);
  }
}

}  // namespace

extern "C" int gsnap_pair_grid(
    const void* left5, const void* right5, const void* mid5, const void* kind5,
    const void* split5, const void* split25, const void* nind5,
    const void* score5, const void* plus5, const void* left3,
    const void* right3, const void* mid3, const void* kind3,
    const void* split3, const void* split23, const void* nind3,
    const void* score3, const void* plus3, const void* len5, const void* len3,
    const void* chr_offsets, void* i5, void* i3, void* pairtype, void* insert,
    void* pscore, void* npairs, void* concordant, const void* ovf5,
    const void* trunc5, const void* bound5, const void* hb5, const void* ovf3,
    const void* trunc3, const void* bound3, const void* hb3, void* ovf5_o,
    void* ovf3_o, int B, int np, int K, int nchr1, int pairmax, int subopt,
    int gate, int indel_penalty_middle, int novel, void* stream) {
  if (np < 1 || np > kNP || K < 1 || K > np * np || nchr1 < 1 || subopt < 0)
    return (int)cudaErrorInvalidValue;
  if (gate && !(ovf5 && trunc5 && bound5 && hb5 && ovf3 && trunc3 && bound3 &&
                hb3 && ovf5_o && ovf3_o))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const HitRows h5{(const int64_t*)left5, (const int64_t*)right5,
                   (const int64_t*)mid5, (const int32_t*)kind5,
                   (const int32_t*)split5, (const int32_t*)split25,
                   (const int32_t*)nind5, (const int32_t*)score5,
                   (const bool*)plus5};
  const HitRows h3{(const int64_t*)left3, (const int64_t*)right3,
                   (const int64_t*)mid3, (const int32_t*)kind3,
                   (const int32_t*)split3, (const int32_t*)split23,
                   (const int32_t*)nind3, (const int32_t*)score3,
                   (const bool*)plus3};
  const PairGate g{(const bool*)ovf5,    (const bool*)trunc5,
                   (const int32_t*)bound5, (const int32_t*)hb5,
                   (const bool*)ovf3,    (const bool*)trunc3,
                   (const int32_t*)bound3, (const int32_t*)hb3,
                   (bool*)ovf5_o,        (bool*)ovf3_o,
                   gate,                 indel_penalty_middle,
                   novel};
  pair_grid_kernel<<<B, kCells, 0, (cudaStream_t)stream>>>(
      h5, h3, (const int32_t*)len5, (const int32_t*)len3,
      (const int64_t*)chr_offsets, (int32_t*)i5, (int32_t*)i3,
      (int32_t*)pairtype, (int32_t*)insert, (int32_t*)pscore,
      (int32_t*)npairs, (bool*)concordant, g, np, K, nchr1, pairmax, subopt);
  return (int)cudaGetLastError();
}
