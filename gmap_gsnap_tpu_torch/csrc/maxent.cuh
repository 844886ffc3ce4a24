// MaxEnt splice-site tables, known-site vectors and the sufficiency gate
// on the card, shared by kernels K5 and K7 (splice_span.cuh reads the
// windows and multiplies the factors).
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

// Known splice sites (gsnap -s): four genome-length bitvectors of
// uint32 words, indexed by Kind (donor, acceptor, antidonor,
// antiacceptor), as db/splicesites.device_bitmasks builds them; nw == 0
// when there are none.
struct Known {
  const uint32_t* w[4];
  int64_t nw;
};

// sufficient_splice_prob_local (stage1hr.c:6093), float32 thresholds
__device__ __forceinline__ bool suff_local(int support, int nmm, float p) {
  const int s = support - 3 * nmm;
  const float thr = s < 14 ? 0.95f : s < 20 ? 0.90f : s < 26 ? 0.85f : 0.70f;
  return p > thr;
}

}  // namespace gsnap_maxent
