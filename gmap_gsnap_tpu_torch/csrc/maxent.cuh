// MaxEnt splice-site probability on the card, shared by kernels K5 and K7.
//
// Counterpart of gmap_gsnap_tpu/ops/maxent.py (splice_idx_span :160 and
// the table lookups of gsnap_gapped._solve_splices / _solve_doublesplices
// through ops/select.table_lookup :49).  The 16 float32 tables arrive as
// one array in the order of ops/maxent.py KINDS x _MODELS (12 tables of
// 16384 entries and 4 of 16, 786 KB: above a block's 227 KB of shared
// memory, so they are read with __ldg and stay in L2).
//
// Bit-exactness: the probability is the product of the table factors
// taken left to right in _MODELS order, then odds / (1 + odds), each step
// rounded to float32.  __fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from
// contracting 1 + o * f into an FMA (its default), which would change the
// last bit — and the last bit decides prob > thr in the sufficiency gate,
// the first-maximum ties and the sense/antisense comparison.
#pragma once

#include "common.cuh"

namespace gsnap_maxent {

enum Kind { kDonor = 0, kAcceptor = 1, kAntidonor = 2, kAntiacceptor = 3 };

// table offsets in the flat array (ops/maxent.flat_tables)
constexpr int kDonorScore = 0, kDonorDi = 16384;
constexpr int kAcc1 = 16400, kAcc2 = 32784, kAcc3 = 49168, kAccDi = 65552,
              kAcc467 = 65568, kAcc589 = 81952;
constexpr int kAntiDonorScore = 98336, kAntiDonorDi = 114720;
constexpr int kAnti1 = 114736, kAnti2 = 131120, kAnti3 = 147504,
              kAntiDi = 163888, kAnti467 = 163904, kAnti589 = 180288;
constexpr int kTotal = 196672;

// 2-bit code at genome position p; a position past the padded word
// array reads its last word, the guard of fill (T), as in the JAX
// package's clamped row gathers
__device__ __forceinline__ uint32_t code_at(const uint32_t* __restrict__ ref16,
                                            int64_t nwords, uint64_t p) {
  const uint64_t w = p >> 4;
  const uint32_t word =
      __ldg(ref16 + (w < (uint64_t)nwords ? (int64_t)w : nwords - 1));
  return (word >> (2 * (uint32_t)(p & 15))) & 3u;
}

// splice dinucleotide of `kind` at scan position site (genome coordinate
// of the scan position): donor GT / antiacceptor CT at [site, site+1],
// acceptor AG / antidonor AC at [site-2, site-1]
__device__ __forceinline__ bool site_at(const uint32_t* __restrict__ ref16,
                                        int64_t nwords, int kind,
                                        uint64_t site) {
  switch (kind) {
    case kDonor:
      return code_at(ref16, nwords, site) == 2 &&
             code_at(ref16, nwords, site + 1) == 3;
    case kAcceptor:
      return code_at(ref16, nwords, site - 2) == 0 &&
             code_at(ref16, nwords, site - 1) == 2;
    case kAntiacceptor:
      return code_at(ref16, nwords, site) == 1 &&
             code_at(ref16, nwords, site + 1) == 3;
    default:  // kAntidonor
      return code_at(ref16, nwords, site - 2) == 0 &&
             code_at(ref16, nwords, site - 1) == 1;
  }
}

// Known splice sites (gsnap -s): four genome-length bitvectors of
// uint32 words, indexed by Kind (donor, acceptor, antidonor,
// antiacceptor), as db/splicesites.device_bitmasks builds them; nw == 0
// when there are none.
struct Known {
  const uint32_t* w[4];
  int64_t nw;
};

// Bit `site` of the class's vector: gmap_gsnap_tpu/ops/genome.py
// fetch_span_bits(bits, start, n)[s] for site = start + s.  That
// function gathers words clip(start >> 5 + j, 0, nw - 1) and returns bit
// b of (raw[j] >> sh) | (raw[j + 1] << (32 - sh)) (sh = start & 31, the
// second term 0 when sh == 0); bit b of word j of that is bit (sh + b) &
// 31 of word min((start + s) >> 5, nw - 1), s = 32 j + b, which this
// reads directly (no shift by 32 arises).  A site past the vector, as
// from an INVALID diagonal, reads the last word.
__device__ __forceinline__ bool known_bit(const Known& kn, int kind,
                                          uint64_t site) {
  if (kn.nw == 0) return false;
  uint64_t w = site >> 5;
  if (w > (uint64_t)(kn.nw - 1)) w = (uint64_t)(kn.nw - 1);
  return (__ldg(kn.w[kind] + w) >> (site & 31)) & 1u;
}

__device__ __forceinline__ float fac(const float* __restrict__ t, int off,
                                     uint32_t idx) {
  return __ldg(t + off + idx);
}

// float32 probability of `kind` at genome coordinate site (>= 20)
__device__ __forceinline__ float prob(const uint32_t* __restrict__ ref16,
                                      int64_t nwords,
                                      const float* __restrict__ t, int kind,
                                      uint64_t site) {
  const int margin = (kind == kAcceptor) ? 20 : (kind == kAntidonor) ? 6 : 3;
  const int width = (kind == kDonor || kind == kAntidonor) ? 9 : 23;
  uint32_t w[23];
#pragma unroll
  for (int i = 0; i < 23; ++i)
    w[i] = i < width ? code_at(ref16, nwords, site - margin + i) : 0u;
#define I7(a, b, c, d, e, f, g)                                            \
  (w[a] | (w[b] << 2) | (w[c] << 4) | (w[d] << 6) | (w[e] << 8) |          \
   (w[f] << 10) | (w[g] << 12))
#define I2(a, b) (w[a] | (w[b] << 2))
  float o;
  switch (kind) {
    case kDonor:
      o = fac(t, kDonorScore, I7(0, 1, 2, 5, 6, 7, 8));
      o = __fmul_rn(o, fac(t, kDonorDi, I2(3, 4)));
      break;
    case kAcceptor:
      o = fac(t, kAcc1, I7(0, 1, 2, 3, 4, 5, 6));
      o = __fmul_rn(o, fac(t, kAcc2, I7(7, 8, 9, 10, 11, 12, 13)));
      o = __fmul_rn(o, fac(t, kAcc3, I7(14, 15, 16, 17, 20, 21, 22)));
      o = __fmul_rn(o, fac(t, kAccDi, I2(18, 19)));
      o = __fmul_rn(o, fac(t, kAcc467, I7(4, 5, 6, 7, 8, 9, 10)));
      o = __fmul_rn(o, fac(t, kAcc589, I7(11, 12, 13, 14, 15, 16, 17)));
      break;
    case kAntidonor:
      o = fac(t, kAntiDonorScore, I7(0, 1, 2, 3, 6, 7, 8));
      o = __fmul_rn(o, fac(t, kAntiDonorDi, I2(4, 5)));
      break;
    default:  // kAntiacceptor
      o = fac(t, kAnti1, I7(16, 17, 18, 19, 20, 21, 22));
      o = __fmul_rn(o, fac(t, kAnti2, I7(9, 10, 11, 12, 13, 14, 15)));
      o = __fmul_rn(o, fac(t, kAnti3, I7(0, 1, 2, 5, 6, 7, 8)));
      o = __fmul_rn(o, fac(t, kAntiDi, I2(3, 4)));
      o = __fmul_rn(o, fac(t, kAnti467, I7(12, 13, 14, 15, 16, 17, 18)));
      o = __fmul_rn(o, fac(t, kAnti589, I7(5, 6, 7, 8, 9, 10, 11)));
      break;
  }
#undef I7
#undef I2
  return __fdiv_rn(o, __fadd_rn(1.0f, o));
}

// sufficient_splice_prob_local (stage1hr.c:6093), float32 thresholds
__device__ __forceinline__ bool suff_local(int support, int nmm, float p) {
  const int s = support - 3 * nmm;
  const float thr = s < 14 ? 0.95f : s < 20 ? 0.90f : s < 26 ? 0.85f : 0.70f;
  return p > thr;
}

}  // namespace gsnap_maxent
