// Kernel K8: the paired-end pairing grid and pair ranking.
//
// Replaces gmap_gsnap_tpu/align/gsnap_pe.py align_batch_pe :119-239
// (Stage3_pair_up_concordant + Stage3_determine_pairtype, stage3hr.c:5074,
// + Stage3pair_optimal_score, stage3hr.c:9719) and :241-283 (the pair
// overflow gate).  Per read pair, over the NP x NP cells (end-5 hit i5,
// end-3 hit i3), NP <= 16:
//   * each hit's refspan, end, chromosome (upper bound of its uint32 left
//     in chr_offsets) and up to three aligned-part intervals, all in int32
//     with the JAX function's wraparound: sums are taken as uint32 and
//     reinterpreted, since signed overflow is undefined in C++;
//   * the pair type, the concordant and outer inserts, the 3 x 3 part
//     overlap behind the insert-0 rejection, the pair score;
//   * concordant cells dominate the paired ones, cells above the best
//     score + subopt drop, and the rest are ranked by the 64-bit keys
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
//     candidate-budget overflow gate, pair form: lane 0 takes the row's
//     concordance, npairs, best pair score and the ends' best scores and
//     bounds, and clears each end's overflow flag when the pair is safe
//     and that end did not truncate.  Its sums are int32 in JAX and wrap
//     there; here they are taken as uint32 and reinterpreted, so any
//     bound value gives the same answer.
//
// Design: one warp a pair, kWarps pairs a CTA, no block barrier.  Lanes
// 0-15 load end 5's hits and lanes 16-31 end 3's, one coalesced load a
// field, search chr_offsets through the read-only cache, and stage the
// derived hit in the warp's shared memory (read by __syncwarp'd lanes);
// lane 0 loads the gate's inputs with them.  Each lane then evaluates 8
// of the 256 cells (cell lane + 32 j) in registers, skipping cells of an
// invalid hit.  Concordance is one __any_sync, the best score one warp
// minimum, and the ranked cells are only the valid ones (most cells are
// BIG: rows of fewer than 16 hits, cells not paired): ballots count and
// compact their keys into the warp's shared row, which is padded to the
// next power of two (32 to 256) and sorted in registers with
// row_sort.cuh's warp sort; a pair with no valid cell sorts nothing.  The
// K slots are then written with coalesced stores, each slot's pair type
// and insert recomputed from the staged hits.
//
// Bound: bytes.  A pair reads the 9 fields of its 2 x NP ranked hits
// that it uses (45 B a hit), its lengths and gate state, and writes 5 x K
// int32 and its npairs, concordance and gate flags: ~3.5 KB a pair at
// NP = 16, K = 100 (chip_smoke's _grid_reads), so 2048 pairs need
// 0.0021 ms at 3.35 TB/s; the arithmetic (256 cells of ~60 operations, a
// sort of the few valid keys) is below that.  What the warp waits on is
// its round trips (the hits, then the dependent steps of the chromosome
// search) and its issue; on an H100, 2048 pairs take ~4.3x the bound.
#include "row_sort.cuh"

namespace {

constexpr int kNP = 16;
constexpr int kCells = kNP * kNP;
constexpr int kWarps = 4;  // pairs a CTA
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

struct EndHits {  // one end's hits in the warp's shared memory, derived
  int32_t left[kNP], end[kNP], score[kNP], chr[kNP], rank[kNP];
  int32_t lo[3][kNP], hi[3][kNP];
  float rounded[kNP];   // float32(int32 left): the left5 sort value
  uint8_t ok[3][kNP];
  uint8_t plus[kNP];
};

// a or b, field by field (registers; a runtime choice between the two
// parameter structs would copy them to local memory)
__device__ __forceinline__ HitRows pick(const HitRows& a, const HitRows& b,
                                        bool second) {
  return {second ? b.left : a.left,       second ? b.right : a.right,
          second ? b.mid : a.mid,         second ? b.kind : a.kind,
          second ? b.split : a.split,     second ? b.split2 : a.split2,
          second ? b.nindels : a.nindels, second ? b.score : a.score,
          second ? b.plusp : a.plusp};
}

struct WarpRow {  // a warp's shared memory: its pair's hits and keys
  EndHits e[2];   // end 5, end 3
  uint64_t keys[kCells];
};

__device__ __forceinline__ void stage_hit(
    const HitRows& h, int64_t o, int32_t L,
    const int64_t* __restrict__ chr_offsets, int nchr1, EndHits& s, int j) {
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
    if (__ldg(chr_offsets + m) <= (int64_t)uleft) lo = m + 1;
    else hi = m;
  }
  s.chr[j] = lo;
  const bool multi = kind == kKindSplice || kind == kKindDel ||
                     kind == kKindIns || kind == kKindShortexon;
  s.lo[0][j] = left;
  s.hi[0][j] = add32(left, multi ? split : L);
  s.ok[0][j] = 1;
  s.lo[1][j] = kind == kKindShortexon ? add32(mid, split)
               : kind == kKindIns     ? add32(add32(right, split), nind)
                                      : add32(right, split);
  s.hi[1][j] = kind == kKindShortexon ? add32(mid, split2) : add32(right, L);
  s.ok[1][j] = multi;
  s.lo[2][j] = add32(right, split2);
  s.hi[2][j] = add32(right, L);
  s.ok[2][j] = kind == kKindShortexon;
}

struct Cell {
  int pt;
  int32_t insert, pscore;
  bool conc, paired;
};

// cell (a, c): Stage3_determine_pairtype, the inserts, the insert-0 rule
__device__ __forceinline__ Cell eval_cell(const EndHits& s5,
                                          const EndHits& s3, int a, int c,
                                          int32_t L5, int32_t L3,
                                          int32_t pairmax) {
  Cell o;
  const int32_t l5 = s5.left[a], e5 = s5.end[a];
  const int32_t l3 = s3.left[c], e3 = s3.end[c];
  const bool p5 = s5.plus[a], p3 = s3.plus[c];
  if (s5.chr[a] != s3.chr[c]) o.pt = kPairUnpaired;
  else if (p5 != p3) o.pt = kPtInversion;
  else if (p5) o.pt = e3 < l5 ? kPtScramble
                      : l3 > add32(e5, pairmax) ? kPtToolong : kPtConcordant;
  else o.pt = l3 > e5 ? kPtScramble
              : add32(e3, pairmax) < l5 ? kPtToolong : kPtConcordant;
  const bool valid =
      s5.score[a] < GSNAP_BIG_SCORE && s3.score[c] < GSNAP_BIG_SCORE;
  o.insert = o.pt == kPtConcordant ? (p5 ? sub32(e3, l5) : sub32(e5, l3))
                                   : sub32(max(e5, e3), min(l5, l3));
  o.pscore = s5.score[a] + s3.score[c];
  bool overlap = false;
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 3; ++y)
      overlap |= s5.ok[x][a] && s3.ok[y][c] &&
                 !(s3.hi[y][c] < s5.lo[x][a] || s3.lo[y][c] > s5.hi[x][a]);
  const int32_t q = L5 + L3;
  const bool insert0 =
      !overlap && (p5 ? e5 > add32(l3, q) : e3 > add32(l5, q));
  o.conc = valid && o.pt == kPtConcordant && !insert0;
  o.paired = valid && (o.pt == kPtInversion || o.pt == kPtScramble ||
                       o.pt == kPtToolong);
  return o;
}

// ascending sort of the warp's first 32 * KPL keys, in registers
template <int KPL>
__device__ __forceinline__ void sort_keys(uint64_t* keys, int lane) {
  uint64_t v[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) v[r] = keys[lane * KPL + r];
  row_sort<uint64_t, KPL, 1>(v, nullptr);
#pragma unroll
  for (int r = 0; r < KPL; ++r) keys[lane * KPL + r] = v[r];
}

__global__ void __launch_bounds__(32 * kWarps)
pair_grid_kernel(HitRows h5, HitRows h3, const int32_t* __restrict__ len5,
                 const int32_t* __restrict__ len3,
                 const int64_t* __restrict__ chr_offsets, int32_t* i5_o,
                 int32_t* i3_o, int32_t* pairtype_o, int32_t* insert_o,
                 int32_t* pscore_o, int32_t* npairs_o, bool* concordant_o,
                 PairGate g, int B, int np, int K, int nchr1,
                 int32_t pairmax, int32_t subopt) {
  __shared__ WarpRow s_rows[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= B) return;  // the whole warp: no block barrier follows
  WarpRow& w = s_rows[warp];
  const EndHits& s5 = w.e[0];
  const EndHits& s3 = w.e[1];
  const int32_t L5 = len5[row], L3 = len3[row];
  // lane 0's gate inputs, loaded with the hits
  bool ovf5 = false, trunc5 = false, ovf3 = false, trunc3 = false;
  int32_t b5 = 0, b3 = 0, hb5 = 0, hb3 = 0;
  if (g.on && lane == 0) {
    ovf5 = g.ovf5[row];
    trunc5 = g.trunc5[row];
    b5 = g.bound5[row];
    hb5 = g.hb5[row];
    ovf3 = g.ovf3[row];
    trunc3 = g.trunc3[row];
    b3 = g.bound3[row];
    hb3 = g.hb3[row];
  }
  const int end = lane >> 4, j = lane & 15;
  if (j < np)
    stage_hit(pick(h5, h3, end), row * np + j, end ? L3 : L5, chr_offsets,
              nchr1, w.e[end], j);
  __syncwarp();
  if (j < np) {  // ranks with ties shared: count of strictly smaller
    const EndHits& s = w.e[end];
    int r = 0;
    for (int k = 0; k < np; ++k)
      r += end ? s.left[k] < s.left[j] : s.rounded[k] < s.rounded[j];
    w.e[end].rank[j] = r;
  }
  __syncwarp();

  // this lane's 8 cells, t = lane + 32 i
  const int n = np * np;
  int32_t eff[8];
  bool conc[8], paired[8];
  bool any_conc = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = lane + 32 * i;
    conc[i] = paired[i] = false;
    eff[i] = 0;
    const int a = t / np, c = t - a * np;
    // a cell of an invalid hit is neither concordant nor paired
    if (t < n && s5.score[a] < GSNAP_BIG_SCORE &&
        s3.score[c] < GSNAP_BIG_SCORE) {
      const Cell cl = eval_cell(s5, s3, a, c, L5, L3, pairmax);
      conc[i] = cl.conc;
      paired[i] = cl.paired;
      eff[i] = cl.pscore;
      any_conc |= cl.conc;
    }
  }
  const bool have_conc = __any_sync(GSNAP_FULL_MASK, any_conc);
  int32_t best = GSNAP_BIG_SCORE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    eff[i] = (have_conc ? conc[i] : paired[i]) ? eff[i] : GSNAP_BIG_SCORE;
    best = min(best, eff[i]);
  }
  best = __reduce_min_sync(GSNAP_FULL_MASK, best);
  // the valid keys, compacted in cell order into the warp's row
  const unsigned below = (1u << lane) - 1u;
  int nvalid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = lane + 32 * i;
    const bool v = eff[i] < GSNAP_BIG_SCORE && eff[i] <= best + subopt;
    const unsigned ballot = __ballot_sync(GSNAP_FULL_MASK, v);
    if (v)
      w.keys[nvalid + __popc(ballot & below)] =
          ((uint64_t)eff[i] << 16) | ((uint64_t)s5.rank[t / np] << 12) |
          ((uint64_t)s3.rank[t % np] << 8) | (uint64_t)t;
    nvalid += __popc(ballot);
  }
  if (nvalid > 0) {
    const int P = nvalid <= 32 ? 32 : nvalid <= 64 ? 64
                  : nvalid <= 128 ? 128 : 256;
    for (int i = nvalid + lane; i < P; i += 32) w.keys[i] = ~0ull;
    __syncwarp();
    if (P == 32) sort_keys<1>(w.keys, lane);
    else if (P == 64) sort_keys<2>(w.keys, lane);
    else if (P == 128) sort_keys<4>(w.keys, lane);
    else sort_keys<8>(w.keys, lane);
    __syncwarp();
  }

  for (int o = lane; o < K; o += 32) {
    const int64_t at = row * K + o;
    if (o < nvalid) {
      const uint64_t key = w.keys[o];
      const int flat = (int)(key & 0xFFu), a = flat / np, c = flat % np;
      const Cell cl = eval_cell(s5, s3, a, c, L5, L3, pairmax);
      i5_o[at] = a;
      i3_o[at] = c;
      pairtype_o[at] = cl.pt;
      insert_o[at] = __float2int_rn(__int2float_rn(cl.insert));
      pscore_o[at] = (int32_t)(key >> 16);
    } else {
      i5_o[at] = 0;
      i3_o[at] = 0;
      pairtype_o[at] = kPairUnpaired;
      insert_o[at] = 0;
      pscore_o[at] = GSNAP_BIG_SCORE;
    }
  }
  if (lane == 0) {
    const int npairs = min(nvalid, K);
    npairs_o[row] = npairs;
    concordant_o[row] = have_conc;
    if (g.on) {
      const int32_t pbest =
          nvalid > 0 ? (int32_t)(w.keys[0] >> 16) : GSNAP_BIG_SCORE;
      const int32_t s5b = s5.score[0], s3b = s3.score[0];
      const int32_t top = add32(pbest, subopt);
      const bool conc_ok = have_conc && npairs > 0;
      const bool sub_ok = add32(b5, s3b) > top && add32(b3, s5b) > top &&
                          add32(b5, b3) > top;
      const int32_t alloc5 = sub32(top, s3b), alloc3 = sub32(top, s5b);
      bool ind_ok = (alloc5 < g.indel_penalty_middle || hb5 > alloc5) &&
                    (alloc3 < g.indel_penalty_middle || hb3 > alloc3);
      if (g.novel) ind_ok = ind_ok && hb5 > alloc5 && hb3 > alloc3;
      const bool safe = conc_ok && sub_ok && ind_ok;
      g.ovf5_o[row] = ovf5 && !(safe && !trunc5);
      g.ovf3_o[row] = ovf3 && !(safe && !trunc3);
    }
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
  pair_grid_kernel<<<gsnap_blocks(B, kWarps), 32 * kWarps, 0,
                     (cudaStream_t)stream>>>(
      h5, h3, (const int32_t*)len5, (const int32_t*)len3,
      (const int64_t*)chr_offsets, (int32_t*)i5, (int32_t*)i3,
      (int32_t*)pairtype, (int32_t*)insert, (int32_t*)pscore,
      (int32_t*)npairs, (bool*)concordant, g, B, np, K, nchr1, pairmax,
      subopt);
  return (int)cudaGetLastError();
}
