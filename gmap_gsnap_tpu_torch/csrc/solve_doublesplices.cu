// Kernel K7: short middle exons between two local introns.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _solve_doublesplices
// (:706, with _fetch_span :502 and the maxent lookups of ops/maxent
// :160 / ops/select :49) — solve_doublesplice, stage1hr.c:6612.  Per
// (read, triple i -> m -> j) and per sense class:
//   * junction 1 is a candidate at scan position s when 2 <= s <= len - 2,
//     all three diagonals are >= 64 and each side is a site of the
//     class's first junction: with `novel`, by its dinucleotides (sense:
//     donor GT on i at s, acceptor AG on m at s - 2; antisense:
//     antiacceptor CT on i, antidonor AC on m), or by its known-site bit
//     at d + s (gsnap -s, JAX :753-764); junction 2 likewise on (m, j).
//     The first K = 8 of each in ascending s are kept (JAX: top_k of the
//     negated key);
//   * each kept position is scored (maxent on both sides, 1.0 on a known
//     site, as JAX :808-811; mismatches before s on i and on m for
//     junction 1, before s on m and from s on j for junction 2);
//   * the 8 x 8 grid: a cell needs s2 > s1, the mismatch total within the
//     budget and all four probabilities sufficient; its key is -total * 8
//     + (((p1i + p1m) + p2m) + p2j) in float32 (-1e9 when not valid), and
//     the first maximum in s1-major cell order wins;
//   * antisense wins only when its key is strictly greater.  Outputs of
//     invalid triples are the JAX ones: sense = !(anti > sense), left /
//     mid / right = the diagonals, the rest 0.
//
// Bound: operations and bytes alike (~0.004 ms each at 4096 reads x 8
// triples): per triple ~8,000 operations (site-mask words, 32 scored
// slots, 128 grid cells); of each candidate row a read's triples name,
// its pref row (~400 bytes, in L2 after K3), its genome span (~40 bytes)
// and with known sites its mask words, and at most 64 reads a triple of
// the 786 KB maxent tables (L2).  The design this one replaces (a
// global load per base for every site test and maxent window, the two
// classes one after the other, half the warp idle while scoring) took
// 0.1842 ms at 4096 rows, NC=32, T=8 on the H100 (700 W).
//
// Design: one warp per triple, both classes at once; the span, mask and
// window helpers are splice_span.cuh's, shared with K5.
//   1. Each segment's genome span, the 2-bit codes of d - 20 .. d + L +
//      ~40, is read once (a word a lane) into the warp's shared memory.
//   2. The eight (segment, site kind) masks over s = 0..L are built with
//      word operations, 32 positions a lane: a dinucleotide test is two
//      2-bit compares over a 64-bit window of 32 codes and a compaction
//      of the even bits (the bit-parallel scan of genome_hr.h); a known
//      mask word is one funnel shift of two bitvector words.  Mask ids:
//      0 / 1 donor on i / m, 2 / 3 antiacceptor on i / m, 4 / 5 acceptor
//      on m / j, 6 / 7 antidonor on m / j.
//   3. Candidate list q (0 / 1: junction 1 / 2 sense, 2 / 3 antisense) is
//      mask q AND mask 4 + q AND the inb window; lane 8q + r takes the
//      list's r-th set bit (popc over the words, then the lowest bits
//      cleared).
//   4. Every lane scores its slot: one short (9-base, 2 factors) and one
//      long (23-base, 6 factors) maxent window read from the span, the
//      table offsets and index fields chosen by class, so the two halves
//      of the warp run the same instructions.  The arithmetic is
//      maxent.cuh's: factors multiplied in _MODELS order with
//      __fmul_rn, then __fdiv_rn(o, __fadd_rn(1, o)).
//   5. Each lane takes two cells of each class's grid, reading the slots
//      by shuffles, and a warp reduction takes each class's first
//      maximum.
#include "splice_span.cuh"

namespace {

constexpr int kK = 8;
constexpr int kMaxWarps = 8;     // warps a CTA, where they fit
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory

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

// 32-bit words of one warp's shared memory: three spans, the known and
// the site masks
__host__ __device__ inline int warp_words(int L) {
  return 3 * gsnap_span::span_words(L) + 16 * gsnap_span::mask_words(L);
}

__global__ void solve_doublesplices_kernel(
    const uint32_t* __restrict__ ref16, const float* __restrict__ tab,
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
    const gsnap_maxent::Known known, int64_t nwords, int B, int T, int NC,
    int L, int novel) {
  using namespace gsnap_span;
  extern __shared__ __align__(16) uint32_t smem[];
  const int wib = threadIdx.x >> 5;
  const int64_t warp = (int64_t)blockIdx.x * (blockDim.x >> 5) + wib;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * T) return;  // warp-uniform exit
  const int64_t b = warp / T;
  const int64_t ci = b * NC + ti[warp];
  const int64_t cm = b * NC + tm[warp];
  const int64_t cj = b * NC + tj[warp];
  const int64_t di = top_d[ci], dm = top_d[cm], dj = top_d[cj];
  const bool margins = di >= 64 && dm >= 64 && dj >= 64;

  Cell best[2] = {{-1e9f, 0}, {-1e9f, 0}};
  float pa = 0.0f, pb = 0.0f;  // (p1i, p1m) or (p2m, p2j) of the lane's slot
  int s = -1, ma = 0, mb = 0;  // its position (-1: none) and mismatches
  if (margins) {  // warp-uniform: below 64 nothing is a candidate
    const int nmw = mask_words(L), nws = span_words(L);
    uint32_t* span = smem + (int64_t)wib * warp_words(L);
    uint32_t* kmask = span + 3 * nws;
    uint32_t* smask = kmask + 8 * nmw;
    // the diagonal of segment g (0 i, 1 m, 2 j)
    auto dseg = [&](int g) {
      return (uint64_t)(g == 0 ? di : g == 1 ? dm : dj);
    };
    // 1. the spans
    for (int g = 0; g < 3; ++g)
      load_span(span + g * nws, ref16, nwords, dseg(g), L, lane);
    __syncwarp();
    // 2. the site masks, word k of mask id a lane
    for (int e = lane; e < 8 * nmw; e += 32) {
      const int id = e / nmw, k = e - id * nmw;
      const bool aside = id < 4;       // site at [p, p+1], else [p-2, p-1]
      const int g = (id & 1) + !aside;  // segment: 0 i, 1 m, 2 j
      const int kind = aside ? ((id & 2) ? kAntiacceptor : kDonor)
                             : ((id & 2) ? kAntidonor : kAcceptor);
      const uint32_t kw = known_word(known, kind, dseg(g), k);
      kmask[e] = kw;
      smask[e] =
          kw | (novel ? site_word(span + g * nws, dseg(g), kind, k) : 0u);
    }
    __syncwarp();

    // 3. lane 8 q + r: the r-th candidate of list q
    const int len = lengths[b];
    const int q = lane >> 3;
    const int hi = min(len - 2, L);
    int r = lane & 7;
    for (int k = 0; k < nmw; ++k) {
      const int a0 = max(2 - 32 * k, 0), e0 = min(hi - 32 * k, 31);
      const uint32_t inb = a0 > e0 ? 0u
                                   : (0xFFFFFFFFu >> (31 - e0)) &
                                         (0xFFFFFFFFu << a0);
      uint32_t w = smask[q * nmw + k] & smask[(4 + q) * nmw + k] & inb;
      const int c = __popc(w);
      if (r < c) {
        for (int x = 0; x < r; ++x) w &= w - 1;
        s = 32 * k + __ffs(w) - 1;
        break;
      }
      r -= c;
    }

    // 4. the slot's probabilities and mismatches
    if (s >= 0) {
      const bool sense = q < 2, j2 = q & 1;
      const int ga = j2 ? 1 : 0, gb = j2 ? 2 : 1;  // segments of the sides
      const int off_a = span_origin(dseg(ga)), off_b = span_origin(dseg(gb));
      // sense: donor (short) on side a, acceptor (long) on side b;
      // antisense: antiacceptor (long) on a, antidonor (short) on b
      float p_short, p_long;
      window_probs(tab, sense,
                   sense ? span_at(span + ga * nws, off_a + s - 3)
                         : span_at(span + gb * nws, off_b + s - 6),
                   sense ? span_at(span + gb * nws, off_b + s - 20)
                         : span_at(span + ga * nws, off_a + s - 3),
                   &p_short, &p_long);
      const int kw = s >> 5, kb = s & 31;
      pa = (kmask[q * nmw + kw] >> kb) & 1 ? 1.0f
                                           : (sense ? p_short : p_long);
      pb = (kmask[(4 + q) * nmw + kw] >> kb) & 1 ? 1.0f
                                                 : (sense ? p_long : p_short);
      const int64_t row_a = j2 ? cm : ci;
      ma = pref[row_a * (L + 1) + s];
      if (j2) {
        const int32_t* pj = pref + cj * (L + 1);
        mb = pj[len] - pj[s];
      } else {
        mb = pref[cm * (L + 1) + s];
      }
    }

    // 5. the grids: cells lane and lane + 32 of each class
    const int bud = budget[b];
#pragma unroll
    for (int cls = 0; cls < 2; ++cls) {
      const int l2 = 16 * cls + 8 + (lane & 7);  // junction-2 slot's lane
      const int s2 = __shfl_sync(GSNAP_FULL_MASK, s, l2);
      const float p2m = __shfl_sync(GSNAP_FULL_MASK, pa, l2);
      const float p2j = __shfl_sync(GSNAP_FULL_MASK, pb, l2);
      const int cm2 = __shfl_sync(GSNAP_FULL_MASK, ma, l2);
      const int mj2 = __shfl_sync(GSNAP_FULL_MASK, mb, l2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cell = lane + 32 * h;
        const int l1 = 16 * cls + cell / kK;  // junction-1 slot's lane
        const int s1 = __shfl_sync(GSNAP_FULL_MASK, s, l1);
        const float p1i = __shfl_sync(GSNAP_FULL_MASK, pa, l1);
        const float p1m = __shfl_sync(GSNAP_FULL_MASK, pb, l1);
        const int mi1 = __shfl_sync(GSNAP_FULL_MASK, ma, l1);
        const int cm1 = __shfl_sync(GSNAP_FULL_MASK, mb, l1);
        float key = -1e9f;
        if (s1 >= 0 && s2 >= 0 && s2 > s1) {
          const int nmm2 = cm2 - cm1;
          const int total = mi1 + nmm2 + mj2;
          if (total <= bud && nmm2 >= 0 && suff_local(s1, mi1, p1i) &&
              suff_local(s2 - s1, nmm2, p1m) &&
              suff_local(s2 - s1, nmm2, p2m) &&
              suff_local(len - s2, mj2, p2j)) {
            const float p =
                __fadd_rn(__fadd_rn(__fadd_rn(p1i, p1m), p2m), p2j);
            key = __fadd_rn(__fmul_rn(-(float)total, 8.0f), p);
          }
        }
        better(best[cls], key, cell);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int cls = 0; cls < 2; ++cls) {
        const float k = __shfl_xor_sync(GSNAP_FULL_MASK, best[cls].key, o);
        const int c = __shfl_xor_sync(GSNAP_FULL_MASK, best[cls].cell, o);
        better(best[cls], k, c);
      }
    }
  }

  // the winning cell's slots (cell 0 when none is valid: masked below)
  const bool use_anti = best[1].key > best[0].key;
  const Cell w = use_anti ? best[1] : best[0];
  const int l1 = 16 * use_anti + w.cell / kK;
  const int l2 = 16 * use_anti + kK + w.cell % kK;
  const int sp1 = __shfl_sync(GSNAP_FULL_MASK, s, l1);
  const float p1i = __shfl_sync(GSNAP_FULL_MASK, pa, l1);
  const float p1m = __shfl_sync(GSNAP_FULL_MASK, pb, l1);
  const int mi1 = __shfl_sync(GSNAP_FULL_MASK, ma, l1);
  const int cm1 = __shfl_sync(GSNAP_FULL_MASK, mb, l1);
  const int sp2 = __shfl_sync(GSNAP_FULL_MASK, s, l2);
  const float p2m = __shfl_sync(GSNAP_FULL_MASK, pa, l2);
  const float p2j = __shfl_sync(GSNAP_FULL_MASK, pb, l2);
  const int cm2 = __shfl_sync(GSNAP_FULL_MASK, ma, l2);
  const int mj2 = __shfl_sync(GSNAP_FULL_MASK, mb, l2);
  if (lane == 0) {
    const bool v = tvalid[warp] && w.key > -1e8f;
    valid_o[warp] = v;
    split_o[warp] = v ? sp1 : 0;
    split2_o[warp] = v ? sp2 : 0;
    sense_o[warp] = !use_anti;
    // junction probabilities in donor/acceptor display order
    prob_d_o[warp] = v ? (use_anti ? p2j : p1i) : 0.0f;
    prob_a_o[warp] = v ? (use_anti ? p2m : p1m) : 0.0f;
    prob_d2_o[warp] = v ? (use_anti ? p1m : p2m) : 0.0f;
    prob_a2_o[warp] = v ? (use_anti ? p1i : p2j) : 0.0f;
    nmm1_o[warp] = v ? mi1 : 0;
    nmm2_o[warp] = v ? cm2 - cm1 : 0;
    nmm3_o[warp] = v ? mj2 : 0;
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
  // as many warps a CTA as fit (fewer for long reads; one at the least)
  const int64_t per_warp = (int64_t)warp_words(L) * 4;
  const int64_t fit = kSmemMax / per_warp;
  const int warps = (int)(fit < kMaxWarps ? fit : kMaxWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * per_warp;
  const gsnap_maxent::Known known{{(const uint32_t*)kd, (const uint32_t*)ka,
                     (const uint32_t*)kad, (const uint32_t*)kaa},
                    kwords};
  if ((int64_t)B * T == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_doublesplices_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = ((int64_t)B * T + warps - 1) / warps;
  solve_doublesplices_kernel<<<(unsigned)blocks, 32 * warps, smem,
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
