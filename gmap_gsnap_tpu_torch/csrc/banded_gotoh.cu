// Kernel K11: the band-packed 3-state Gotoh sweep of GMAP's junction
// dynprog.
//
// Replaces gmap_gsnap_tpu/ops/dynprog.py banded_matrices (:107)
// (compute_scores_lookup_fwd semantics, src/dynprog.c:1424-1570).  One
// warp per problem and one problem a CTA, one lane per band cell
// k < W <= 32 (cell (r, c) at k = c - r + lband), looping over the M
// query rows:
//   * vertical (gap2, a gap in the genome): (r-1, c) is band k+1 of the
//     previous row — a __shfl_down by one lane (NEG_INF past the band);
//   * diagonal: (r-1, c-1) is band k of the previous row, in the lane's
//     own registers; ndiag = best of the two gap states >= (jump late)
//     or > (jump early) the nogap state;
//   * horizontal (gap1): gap1[k] = extend*k + max_{j<k}(nogap[j] + open -
//     extend*j), JAX's exclusive running max, as a max scan over the
//     lanes whose first level takes lanes k-1 and k-2 at once.
// All in int32, with JAX's exact integer arithmetic.
//
// Bound: the outputs (3 int32 + 1 bool per cell, [M+1, W]) are written
// once and the codes read once, which the card moves in well under a
// microsecond at the GMAP path's sizes; what bounds the kernel is one
// warp's chain of M dependent row steps (a row's nogap needs the
// previous row's gap1, which needs the previous row's scan), issued in
// order by a warp with no other to hide its latencies (a shuffle 26
// cycles, a shared load 29, a global store ~10 cycles of its SM's store
// pipe: tools/probe_seed_gotoh.py).  So nothing else waits on that
// chain: a warp stages its query and genome codes and its lengths and
// bands with one round of coalesced loads, the 6 x 6 pair matrix and the
// gap costs arrive by value in the kernel's parameters (no host-to-device
// copy), a row's substitution score is looked up in shared memory a row
// ahead, and each problem has an SM's store pipe to itself (one warp a
// CTA), so that its four coalesced stores a row queue behind no other
// warp's (GOTOH_ROW_STORES=0 stores the last row alone, to show what the
// row stores cost).  Staging the rows in shared memory and copying them
// out, a wavefront over anti-diagonals (lane = row, 2M + W steps) and a
// radix-4 scan were each slower on the card.
//
// GOTOH_STAMP(i): the end of phase i of a warp (0 its start, 1 the codes
// staged, 2 the row loop), defined by a probe build
// (tools/probe_seed_gotoh.py) and empty in the default one.
#include "common.cuh"

#ifndef GOTOH_STAMP
#define GOTOH_STAMP(i)
#endif
#ifndef GOTOH_ROW_STORES
#define GOTOH_ROW_STORES 1
#endif

namespace {

constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory
constexpr int32_t kNegInf = -1000000;
constexpr int kCodes = 6;  // ACGT, N, '*' (past the chromosome)

// The problem-independent arguments, passed by value.
struct GotohParams {
  int32_t pair[kCodes * kCodes];  // score of (query code, genome code)
  int M, N, W, open_, extend;
};

__global__ void __launch_bounds__(32) banded_gotoh_kernel(
    const int32_t* __restrict__ q, const int32_t* __restrict__ g,
    const int32_t* __restrict__ len2, const int32_t* __restrict__ lband,
    const int32_t* __restrict__ rband, const uint8_t* __restrict__ late,
    int32_t* __restrict__ nogap, int32_t* __restrict__ gap1,
    int32_t* __restrict__ gap2, uint8_t* __restrict__ ndiag,
    const GotohParams p) {
  extern __shared__ __align__(16) uint8_t s_q[];  // M query, N genome codes
  __shared__ int32_t s_pair[kCodes * kCodes];
  const int b = blockIdx.x, k = threadIdx.x;
  const int M = p.M, N = p.N, W = p.W, open_ = p.open_, extend = p.extend;
  GOTOH_STAMP(0);
  uint8_t* s_g = s_q + M;
  const int32_t* qb = q + (int64_t)b * M;
  const int32_t* gb = g + (int64_t)b * N;
  for (int i = k; i < kCodes * kCodes; i += 32) s_pair[i] = p.pair[i];
  for (int i = k; i < M; i += 32) s_q[i] = (uint8_t)qb[i];
  for (int i = k; i < N; i += 32) s_g[i] = (uint8_t)gb[i];
  const int lb = lband[b], rb = rband[b], l2 = len2[b];
  const bool lt = late[b] != 0;
  __syncwarp();
  const bool inw = k < W;
  const int bandw = lb + rb;
  const int32_t run_off = open_ - extend * k;
  const int64_t base = (int64_t)b * (M + 1) * W;
  GOTOH_STAMP(1);

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
  // pair[q[r-1]][g[c-1]], the genome code 5 outside the sequence
  auto score = [&](int r) -> int32_t {
    const int c = r + k - lb;
    int gc = c - 1;
    gc = gc < 0 ? 0 : (gc > N - 1 ? N - 1 : gc);
    gc = (c >= 1 && c <= l2) ? s_g[gc] : 5;
    return s_pair[s_q[r - 1] * kCodes + gc];
  };
  int32_t sc = score(1);
  for (int r = 1; r <= M; ++r) {
    const int32_t sc_next = r < M ? score(r + 1) : 0;
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
    const bool nd = lt ? best12 >= ng : best12 > ng;
    const int32_t new_ng = valid ? max(ng, best12) + sc : kNegInf;
    // horizontal: exclusive running max within the row.  After the
    // first level, e at lane k >= 1 is the max of run over lanes
    // [max(k-2, 0), k-1]; each level doubles the window from lanes
    // whose own window is defined (k - off >= 1)
    const int32_t run = new_ng + run_off;
    const int32_t a1 = __shfl_up_sync(GSNAP_FULL_MASK, run, 1);
    const int32_t a2 = __shfl_up_sync(GSNAP_FULL_MASK, run, 2);
    int32_t e = k >= 2 ? max(a1, a2) : a1;
    for (int off = 2; off < 32; off <<= 1) {
      const int32_t v = __shfl_up_sync(GSNAP_FULL_MASK, e, off);
      if (k > off) e = max(e, v);
    }
    ng = new_ng;
    g1 = valid && k > 0 ? e + extend * k : kNegInf;
    g2 = ng2;
    sc = sc_next;
    if (inw && (GOTOH_ROW_STORES || r == M)) {
      const int64_t at = base + (int64_t)r * W + k;
      nogap[at] = ng;
      gap1[at] = g1;
      gap2[at] = g2;
      ndiag[at] = nd && valid;
    }
  }
  GOTOH_STAMP(2);
}

}  // namespace

// pairmat: the 36 scores of the 6 x 6 pair matrix (query code major) in
// host memory, read here into the kernel's parameters.
extern "C" int gmap_banded_gotoh(const void* q, const void* g,
                                 const void* len2, const void* lband,
                                 const void* rband, const void* late,
                                 void* nogap, void* gap1, void* gap2,
                                 void* ndiag, const int64_t* pairmat, int B,
                                 int M, int N, int W, int open_, int extend,
                                 void* stream) {
  if (W < 1 || W > 32 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(M + N + 15) / 16 * 16;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  GotohParams p;
  for (int i = 0; i < kCodes * kCodes; ++i) p.pair[i] = (int32_t)pairmat[i];
  p.M = M;
  p.N = N;
  p.W = W;
  p.open_ = open_;
  p.extend = extend;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_gotoh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  banded_gotoh_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)g, (const int32_t*)len2,
      (const int32_t*)lband, (const int32_t*)rband, (const uint8_t*)late,
      (int32_t*)nogap, (int32_t*)gap1, (int32_t*)gap2, (uint8_t*)ndiag, p);
  return (int)cudaGetLastError();
}
