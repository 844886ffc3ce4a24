// Genome spans in shared memory and splice-site mask words, shared by the
// splice kernels K5 (solve_splices.cu) and K7 (solve_doublesplices.cu).
//
// A segment's span is the 2-bit genome codes from word (d - 20) >> 4 on,
// read once into a warp's shared memory (span_words(L) words), which
// covers every site test and maxent window at scan positions s = 0..L.
// The site masks over s are built 32 positions a word: a dinucleotide
// test is two 2-bit compares over a 64-bit window of 32 codes and a
// compaction of the even bits (the bit-parallel scan of genome_hr.h); a
// known-site mask word is one funnel shift of two bitvector words.  The
// maxent windows of a scored position are read from the span too, and
// their factors multiplied as maxent.cuh says.
#pragma once

#include "maxent.cuh"

namespace gsnap_span {

using namespace gsnap_maxent;

// mask words over s = 0..L, and span words of a segment (see span_at)
__host__ __device__ inline int mask_words(int L) { return (L + 32) / 32; }
__host__ __device__ inline int span_words(int L) {
  return 2 * mask_words(L) + 4;
}

// Reads the span of diagonal d (span_words(L) words) into span[], one
// word a lane; a word past the genome reads the last, the guard of fill
// (T), as the JAX package's clamped row gathers do.
__device__ __forceinline__ void load_span(uint32_t* span,
                                          const uint32_t* __restrict__ ref16,
                                          int64_t nwords, uint64_t d, int L,
                                          int lane) {
  for (int e = lane; e < span_words(L); e += 32) {
    uint64_t w = ((d - 20) >> 4) + (uint64_t)e;
    if (w > (uint64_t)(nwords - 1)) w = (uint64_t)(nwords - 1);
    span[e] = __ldg(ref16 + w);
  }
}

// span index of genome position d + x: a span's index 0 is the first
// base of genome word (d - 20) >> 4
__device__ __forceinline__ int span_origin(uint64_t d) {
  return 20 + (int)((d - 20) & 15);
}

// The 32 codes at span index rel .. rel + 31 (2 bits each, the first in
// the low bits).
__device__ __forceinline__ uint64_t span_at(const uint32_t* span, int rel) {
  const int q = rel >> 4, r = 2 * (rel & 15);
  const uint32_t lo = __funnelshift_r(span[q], span[q + 1], r);
  const uint32_t hi = __funnelshift_r(span[q + 1], span[q + 2], r);
  return (uint64_t)hi << 32 | lo;
}

constexpr uint64_t kEven = 0x5555555555555555ull;

// bit 2b set where code b of x equals c
__device__ __forceinline__ uint64_t codes_equal(uint64_t x, uint32_t c) {
  const uint64_t t = x ^ (kEven * c);
  return ~(t | (t >> 1)) & kEven;
}

// bits 0, 2, .., 62 of x as bits 0 .. 31
__device__ __forceinline__ uint32_t even_bits(uint64_t x) {
  x &= kEven;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  x = (x | (x >> 16)) & 0x00000000FFFFFFFFull;
  return (uint32_t)x;
}

// Word k of the site mask of `kind` on the span of diagonal d: bit b set
// where genome position d + 32 k + b is a scan position carrying the
// kind's dinucleotide: donor GT / antiacceptor CT at [p, p+1], acceptor
// AG / antidonor AC at [p-2, p-1].
__device__ __forceinline__ uint32_t site_word(const uint32_t* span,
                                              uint64_t d, int kind, int k) {
  const bool aside = kind == kDonor || kind == kAntiacceptor;
  const int rel = 32 * k + span_origin(d) - (aside ? 0 : 2);
  const uint32_t c1 = aside ? (kind == kAntiacceptor ? 1u : 2u) : 0u;
  const uint32_t c2 = aside ? 3u : (kind == kAntidonor ? 1u : 2u);
  return even_bits(codes_equal(span_at(span, rel), c1) &
                   codes_equal(span_at(span, rel + 1), c2));
}

// Word k of the known-site mask of `kind` for diagonal d: bits d + 32 k
// .. d + 32 k + 31 of the class's bitvector, each word index clipped to
// the last word as gmap_gsnap_tpu/ops/genome.py fetch_span_bits clips
// them (INVALID diagonals and the genome end read it).  0 without known
// sites.
__device__ __forceinline__ uint32_t known_word(const Known& known, int kind,
                                               uint64_t d, int k) {
  if (known.nw == 0) return 0u;
  const uint64_t last = (uint64_t)(known.nw - 1);
  uint64_t w0 = (d >> 5) + (uint64_t)k, w1 = w0 + 1;
  w0 = w0 > last ? last : w0;
  w1 = w1 > last ? last : w1;
  // a chain of selects, not known.w[kind]: a kernel parameter indexed
  // at run time would be copied to local memory
  const uint32_t* kv = kind == kDonor       ? known.w[kDonor]
                       : kind == kAcceptor  ? known.w[kAcceptor]
                       : kind == kAntidonor ? known.w[kAntidonor]
                                            : known.w[kAntiacceptor];
  return __funnelshift_r(__ldg(kv + w0), __ldg(kv + w1), (uint32_t)(d & 31));
}

// field of n codes from code a of a window
__device__ __forceinline__ uint32_t field(uint64_t w, int a, int n) {
  return (uint32_t)(w >> (2 * a)) & ((1u << (2 * n)) - 1u);
}

__device__ __forceinline__ float odds_prob(float o) {
  return __fdiv_rn(o, __fadd_rn(1.0f, o));
}

// The float32 probabilities of a sense class's short and long windows:
// sense, ws = the 32 codes from the donor's position - 3 and wl from the
// acceptor's position - 20; antisense, ws from the antidonor's position -
// 6 and wl from the antiacceptor's position - 3.  Factors are multiplied
// in _MODELS order with __fmul_rn, so the result is bit-equal to
// maxent.py's; the table offsets and index fields are chosen by class,
// so lanes of the two classes run the same instructions.
__device__ __forceinline__ void window_probs(const float* __restrict__ tab,
                                             bool sense, uint64_t ws,
                                             uint64_t wl, float* p_short,
                                             float* p_long) {
  float os = __ldg(tab + (sense ? kDonorScore : kAntiDonorScore) +
                   (sense ? field(ws, 0, 3) | field(ws, 5, 4) << 6
                          : field(ws, 0, 4) | field(ws, 6, 3) << 8));
  os = __fmul_rn(os, __ldg(tab + (sense ? kDonorDi : kAntiDonorDi) +
                           field(ws, sense ? 3 : 4, 2)));
  float ol =
      __ldg(tab + (sense ? kAcc1 : kAnti1) + field(wl, sense ? 0 : 16, 7));
  ol = __fmul_rn(ol, __ldg(tab + (sense ? kAcc2 : kAnti2) +
                           field(wl, sense ? 7 : 9, 7)));
  ol = __fmul_rn(ol, __ldg(tab + (sense ? kAcc3 : kAnti3) +
                           (sense ? field(wl, 14, 4) | field(wl, 20, 3) << 8
                                  : field(wl, 0, 3) | field(wl, 5, 4) << 6)));
  ol = __fmul_rn(ol, __ldg(tab + (sense ? kAccDi : kAntiDi) +
                           field(wl, sense ? 18 : 3, 2)));
  ol = __fmul_rn(ol, __ldg(tab + (sense ? kAcc467 : kAnti467) +
                           field(wl, sense ? 4 : 12, 7)));
  ol = __fmul_rn(ol, __ldg(tab + (sense ? kAcc589 : kAnti589) +
                           field(wl, sense ? 11 : 5, 7)));
  *p_short = odds_prob(os);
  *p_long = odds_prob(ol);
}

}  // namespace gsnap_span
