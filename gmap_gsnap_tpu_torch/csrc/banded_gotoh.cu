// Kernel K11: the band-packed 3-state Gotoh sweep of GMAP's junction
// dynprog.
//
// Replaces gmap_gsnap_tpu/ops/dynprog.py banded_matrices (:107)
// (compute_scores_lookup_fwd semantics, src/dynprog.c:1424-1570).  One
// warp per problem, one lane per band cell k < W <= 32 (cell (r, c) at
// k = c - r + lband), looping over the M query rows:
//   * vertical (gap2, a gap in the genome): (r-1, c) is band k+1 of the
//     previous row — a __shfl_down by one lane (NEG_INF past the band);
//   * diagonal: (r-1, c-1) is band k of the previous row, in the lane's
//     own registers; ndiag = best of the two gap states >= (jump late)
//     or > (jump early) the nogap state;
//   * horizontal (gap1): gap1[k] = extend*k + max_{j<k}(nogap[j] + open -
//     extend*j), JAX's exclusive running max, as an inclusive max scan
//     over the lanes (__shfl_up) shifted by one lane.
// The gap costs (two tiers) are arguments, the 6 x 6 pair matrix (code 5
// scores 0 against everything, N against N is FULLMATCH) is read from
// device memory.  All in int32, with JAX's exact integer arithmetic.
//
// Bound: per problem M dependent row steps of a few shuffles; the
// outputs (3 int32 + 1 bool per cell, [M+1, W]) are written once, the
// query and genome codes read once — tiny, latency-bound.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int32_t kNegInf = -1000000;

__global__ void __launch_bounds__(kWarps * 32) banded_gotoh_kernel(
    const int32_t* __restrict__ q, const int32_t* __restrict__ g,
    const int32_t* __restrict__ len1, const int32_t* __restrict__ len2,
    const int32_t* __restrict__ lband, const int32_t* __restrict__ rband,
    const int32_t* __restrict__ pairmat, const uint8_t* __restrict__ late,
    int32_t* __restrict__ nogap, int32_t* __restrict__ gap1,
    int32_t* __restrict__ gap2, uint8_t* __restrict__ ndiag, int B, int M,
    int N, int W, int open_, int extend) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int k = threadIdx.x & 31;
  const bool inw = k < W;
  const int lb = lband[b], rb = rband[b], l2 = len2[b];
  const int bandw = lb + rb;
  const bool lt = late[b] != 0;
  const int32_t* qb = q + (int64_t)b * M;
  const int32_t* gb = g + (int64_t)b * N;
  const int64_t base = (int64_t)b * (M + 1) * W;

  // row 0: c = k - lband
  const int c0 = k - lb;
  int32_t ng = c0 == 0 ? 0 : kNegInf;
  int32_t g1 = (c0 >= 1 && c0 <= min(rb, l2)) ? open_ + extend * c0 : kNegInf;
  int32_t g2 = kNegInf;
  if (inw) {
    nogap[base + k] = ng;
    gap1[base + k] = g1;
    gap2[base + k] = g2;
    ndiag[base + k] = 0;
  }
  for (int r = 1; r <= M; ++r) {
    const int c = r + k - lb;
    const bool incol = c >= 1 && c <= l2;
    const bool valid = incol && k <= bandw;
    // vertical: band k+1 of the previous row
    int32_t ng_up = __shfl_down_sync(GSNAP_FULL_MASK, ng, 1);
    int32_t g2_up = __shfl_down_sync(GSNAP_FULL_MASK, g2, 1);
    if (k + 1 >= W) ng_up = g2_up = kNegInf;
    int32_t ng2 = max(ng_up + open_, g2_up) + extend;
    if (c == 0) ng2 = open_ + extend * r;
    if (!(valid || c == 0)) ng2 = kNegInf;
    // diagonal: band k of the previous row
    const int32_t best12 = max(g1, g2);
    const int32_t dg = max(ng, best12);
    const bool nd = lt ? best12 >= ng : best12 > ng;
    int gc = c - 1;
    gc = gc < 0 ? 0 : (gc > N - 1 ? N - 1 : gc);
    gc = incol ? gb[gc] : 5;
    const int32_t new_ng =
        valid ? dg + pairmat[qb[r - 1] * 6 + gc] : kNegInf;
    // horizontal: exclusive running max within the row
    int32_t run = new_ng + open_ - extend * k;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t v = __shfl_up_sync(GSNAP_FULL_MASK, run, off);
      if (k >= off) run = max(run, v);
    }
    int32_t excl = __shfl_up_sync(GSNAP_FULL_MASK, run, 1);
    if (k == 0) excl = kNegInf;
    const int32_t new_g1 = valid ? excl + extend * k : kNegInf;
    ng = new_ng;
    g1 = new_g1;
    g2 = ng2;
    if (inw) {
      const int64_t at = base + (int64_t)r * W + k;
      nogap[at] = ng;
      gap1[at] = g1;
      gap2[at] = g2;
      ndiag[at] = nd && valid;
    }
  }
}

}  // namespace

extern "C" int gmap_banded_gotoh(const void* q, const void* g,
                                 const void* len1, const void* len2,
                                 const void* lband, const void* rband,
                                 const void* pairmat, const void* late,
                                 void* nogap, void* gap1, void* gap2,
                                 void* ndiag, int B, int M, int N, int W,
                                 int open_, int extend, void* stream) {
  if (W < 1 || W > 32 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  banded_gotoh_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)g, (const int32_t*)len1,
      (const int32_t*)len2, (const int32_t*)lband, (const int32_t*)rband,
      (const int32_t*)pairmat, (const uint8_t*)late, (int32_t*)nogap,
      (int32_t*)gap1, (int32_t*)gap2, (uint8_t*)ndiag, B, M, N, W, open_,
      extend);
  return (int)cudaGetLastError();
}
