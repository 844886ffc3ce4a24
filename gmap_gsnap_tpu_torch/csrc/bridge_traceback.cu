// Kernel K12: the intron junction search and both sides' tracebacks of
// GMAP's junction dynprog.
//
// Replaces gmap_gsnap_tpu/ops/dynprog.py bridge_intron (:328, with
// dinucl_codes_left/right :270/:284 and intron_score_table :298) followed
// by traceback (:194) on the left and the right side (bridge_intron_gap,
// dynprog.c:3701-3830, and the traceback state machine of
// dynprog.c:2612-2715).  One CTA per junction problem b; the K11
// matrices of its left side are problem b, of its reversed right side
// problem nb + b:
//   * the threads stride over the M x 2W candidates in JAX's linear order
//     (per rL = 1..M: family A, cL varying in the band with cR pinned at
//     rR = len1 - rL, then family B, cR varying with cL pinned at rL);
//     each scores nogap + known-site reward - the gap-avoidance flag of
//     its varying side + the intron reward of its dinucleotide pair (the
//     codes computed here from the genome windows; the reward and type
//     tables, which carry cdna_direction, finalp and nosplicing, come
//     from the wrapper) + the pinned side, NEG_INF where the split is out
//     of range or the two sides would overlap (the sep test);
//   * a block reduction of  score * 2^32 + (2^32 - 1 - candidate)  gives
//     JAX's first maximum; thread 0 turns it into (rL, cL, rR, cR), the
//     final score (halfp takes half the intron reward back) and the
//     normalised intron type;
//   * threads 0 and 1 then run the traceback state machine T steps from
//     (rL, cL) on the left matrices (jump early) and from (rR, cR) on the
//     right ones (jump late), re-deriving each direction from the three
//     states as JAX does, and write ops / opr / opc.
//
// Bound: per problem 2 x M x W candidates of a few dependent loads each
// and 2 x T sequential traceback steps (latency-bound); it reads the
// candidate rows of the two sides' matrices and writes 2 + 6 T values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kNegInf = -1000000;
constexpr int kOpNone = 0, kOpDiag = 1, kOpHoriz = 2, kOpVert = 3;
constexpr int kNogap = 0, kGap1 = 1, kGap2 = 2, kDone = 3;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// LEFT_* code of the dinucleotide at column c of the left genome window
// (0 past its end), dinucl_codes_left
__device__ __forceinline__ int left_di(const int32_t* gl, int NL, int c) {
  if (c >= NL) return 0;
  const int a = gl[c], b = c + 1 < NL ? gl[c + 1] : 5;
  if (a == 1 && b == 3) return 0x06;  // CT
  if (a == 0 && b == 3) return 0x08;  // AT
  if (a == 2 && b == 1) return 0x10;  // GC
  if (a == 2 && b == 3) return 0x21;  // GT
  return 0;
}

// RIGHT_* code at column c of the reversed right window, dinucl_codes_right
__device__ __forceinline__ int right_di(const int32_t* gr, int NR, int c) {
  if (c >= NR) return 0;
  const int r1 = gr[c], r2 = c + 1 < NR ? gr[c + 1] : 5;
  if (r2 == 0 && r1 == 3) return 0x01;  // AT
  if (r2 == 2 && r1 == 1) return 0x02;  // GC
  if (r2 == 0 && r1 == 1) return 0x0C;  // AC
  if (r2 == 0 && r1 == 2) return 0x30;  // AG
  return 0;
}

struct Side {
  const int32_t* nogap;  // [M+1, W] of this side's problem
  const int32_t* gap1;
  const int32_t* gap2;
  const uint8_t* ndiag;
};

struct Problem {
  Side L, R;
  int len1, len2L, len2R, lbL, lbR, NL, NR, M, W;
  int32_t sep;
  const int32_t *gl, *gr, *lkn, *rkn, *itab;
};

// candidate idx of the [M, 2W] block: (score, intron type bitmask)
__device__ __forceinline__ void candidate(const Problem& p, int idx,
                                          int32_t* score, int* ity) {
  const int W = p.W;
  const int m = idx / (2 * W), col = idx % (2 * W);
  const bool inB = col >= W;
  const int kb = inB ? col - W : col;
  const int rL = m + 1, rR = p.len1 - rL;
  const bool rok = rL >= 1 && rL <= p.len1 - 1;
  const int rowL = clampi(rL, 0, p.M), rowR = clampi(rR, 0, p.M);
  if (!inB) {  // family A: cL varies, cR pinned at rR
    const int cL = rL + kb - p.lbL;
    const bool okL = cL >= 1 && cL <= p.len2L - 1;
    const int ldi = cL <= p.len2L - 2 ? left_di(p.gl, p.NL, clampi(cL, 0, p.NL))
                                      : 0;
    const int rdi = rR <= p.len2R - 2 ? right_di(p.gr, p.NR, clampi(rR, 0, p.NR))
                                      : 0;
    const bool okR = rR >= 1 && rR <= p.len2R - 1;
    *ity = ldi & rdi;
    const bool ok = okL && okR && rok && rR < p.sep - cL;
    *score = ok ? p.L.nogap[rowL * W + kb] + p.lkn[clampi(cL, 0, p.NL)] -
                      (int32_t)p.L.ndiag[rowL * W + kb] + p.itab[*ity] +
                      (p.R.nogap[rowR * W + clampi(p.lbR, 0, W - 1)] +
                       p.rkn[clampi(rR, 0, p.NR)])
                : kNegInf;
  } else {  // family B: cR varies, cL pinned at rL
    const int cR = rR + kb - p.lbR;
    const bool okR = cR >= 1 && cR <= p.len2R - 1;
    const int rdi = cR <= p.len2R - 2 ? right_di(p.gr, p.NR, clampi(cR, 0, p.NR))
                                      : 0;
    const int ldi = rL <= p.len2L - 2 ? left_di(p.gl, p.NL, clampi(rL, 0, p.NL))
                                      : 0;
    const bool okL = rL >= 1 && rL <= p.len2L - 1;
    *ity = ldi & rdi;
    const bool ok = okR && okL && rok && rL < p.sep - cR;
    *score = ok ? (p.L.nogap[rowL * W + clampi(p.lbL, 0, W - 1)] +
                   p.lkn[clampi(rL, 0, p.NL)]) +
                      p.itab[*ity] + p.R.nogap[rowR * W + kb] +
                      p.rkn[clampi(cR, 0, p.NR)] -
                      (int32_t)p.R.ndiag[rowR * W + kb]
                : kNegInf;
  }
}

__device__ __forceinline__ int32_t cell(const int32_t* a, int r, int k,
                                        int M1, int W) {
  return (k >= 0 && k < W && r >= 0 && r < M1) ? a[r * W + k] : kNegInf;
}

// the traceback state machine of dynprog.py traceback (:194)
__device__ void traceback(const Side& s, int r, int c, int lband, bool late,
                          int M1, int W, int T, int open_, int8_t* ops,
                          int32_t* opr, int32_t* opc) {
  int state = kNogap;
  auto ge = [late](int32_t a, int32_t b) { return late ? a >= b : a > b; };
  for (int t = 0; t < T; ++t) {
    const int k = c - r + lband;
    const bool at_origin = r <= 0 && c <= 0;
    const bool done = state == kDone || (state == kNogap && (r <= 0 || c <= 0));
    const int32_t ng = cell(s.nogap, r - 1, k, M1, W);
    const int32_t g1 = cell(s.gap1, r - 1, k, M1, W);
    const int32_t g2 = cell(s.gap2, r - 1, k, M1, W);
    const bool takeh = ge(g1, ng);
    const bool takev = ge(g2, max(ng, g1));
    const int ng_next = takev ? kGap2 : (takeh ? kGap1 : kNogap);
    bool h = ge(cell(s.gap1, r, k - 1, M1, W),
                cell(s.nogap, r, k - 1, M1, W) + open_) && r > 0 && c > 1;
    if (r == 0) h = c > 1;
    bool v = ge(cell(s.gap2, r - 1, k + 1, M1, W),
                cell(s.nogap, r - 1, k + 1, M1, W) + open_) && c > 0 && r > 1;
    if (c == 0) v = r > 1;
    ops[t] = (int8_t)(done ? kOpNone
                           : (state == kNogap ? kOpDiag
                                              : (state == kGap1 ? kOpHoriz
                                                                : kOpVert)));
    opr[t] = state == kGap1 ? r : r - 1;
    opc[t] = state == kGap2 ? c : c - 1;
    const int nr = (done || state == kGap1) ? r : r - 1;
    const int nc = (done || state == kGap2) ? c : c - 1;
    state = (done || at_origin)
                ? kDone
                : (state == kNogap ? ng_next
                                   : (state == kGap1 ? (h ? kGap1 : kNogap)
                                                     : (v ? kGap2 : kNogap)));
    r = nr;
    c = nc;
  }
}

__global__ void __launch_bounds__(kThreads) bridge_traceback_kernel(
    const int32_t* __restrict__ nogap, const int32_t* __restrict__ gap1,
    const int32_t* __restrict__ gap2, const uint8_t* __restrict__ ndiag,
    const int32_t* __restrict__ len1, const int32_t* __restrict__ len2L,
    const int32_t* __restrict__ len2R, const int32_t* __restrict__ lbandL,
    const int32_t* __restrict__ lbandR, const int32_t* __restrict__ gl,
    const int32_t* __restrict__ grv, const int32_t* __restrict__ lknown,
    const int32_t* __restrict__ rknown, const int32_t* __restrict__ loff,
    const int32_t* __restrict__ roff, const int32_t* __restrict__ tabs,
    int32_t* __restrict__ fs, int32_t* __restrict__ ityp,
    int8_t* __restrict__ ops, int32_t* __restrict__ opr,
    int32_t* __restrict__ opc, int nb, int M, int W, int NL, int NR, int T,
    int open_, int halfp) {
  __shared__ int s_start[4];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t mat = (int64_t)(M + 1) * W;
  Problem p;
  p.L = {nogap + b * mat, gap1 + b * mat, gap2 + b * mat, ndiag + b * mat};
  const int64_t rb = (int64_t)(nb + b) * mat;
  p.R = {nogap + rb, gap1 + rb, gap2 + rb, ndiag + rb};
  p.len1 = len1[b];
  p.len2L = len2L[b];
  p.len2R = len2R[b];
  p.lbL = lbandL[b];
  p.lbR = lbandR[b];
  p.NL = NL;
  p.NR = NR;
  p.M = M;
  p.W = W;
  p.sep = (int32_t)((uint32_t)roff[b] - (uint32_t)loff[b]);
  p.gl = gl + (int64_t)b * NL;
  p.gr = grv + (int64_t)b * NR;
  p.lkn = lknown + (int64_t)b * (NL + 1);
  p.rkn = rknown + (int64_t)b * (NR + 1);
  p.itab = tabs;

  int64_t key = INT64_MIN;
  for (int idx = tid; idx < M * 2 * W; idx += blockDim.x) {
    int32_t score;
    int ity;
    candidate(p, idx, &score, &ity);
    key = gmap_max64(key, gmap_first_max_key(score, idx));
  }
  key = gmap_block_max(key);
  if (tid == 0) {
    const int best = gmap_key_index(key);
    int32_t bestscore;
    int ity;
    candidate(p, best, &bestscore, &ity);
    const int brow = best / (2 * W), bcol = best % (2 * W);
    const bool inB = bcol >= W;
    const int bk = inB ? bcol - W : bcol;
    const int rL = brow + 1, rR = p.len1 - rL;
    s_start[0] = rL;
    s_start[1] = inB ? rL : rL + bk - p.lbL;
    s_start[2] = rR;
    s_start[3] = inB ? rR + bk - p.lbR : rR;
    const int32_t besti = tabs[ity];
    fs[b] = halfp ? bestscore - besti / 2 : bestscore;
    ityp[b] = tabs[64 + ity];
  }
  __syncthreads();
  if (tid < 2) {
    const int64_t o = ((int64_t)tid * nb + b) * T;
    traceback(tid == 0 ? p.L : p.R, s_start[2 * tid], s_start[2 * tid + 1],
              tid == 0 ? p.lbL : p.lbR, tid == 1, M + 1, W, T, open_,
              ops + o, opr + o, opc + o);
  }
}

}  // namespace

extern "C" int gmap_bridge_traceback(
    const void* nogap, const void* gap1, const void* gap2, const void* ndiag,
    const void* len1, const void* len2L, const void* len2R,
    const void* lbandL, const void* lbandR, const void* gl, const void* grv,
    const void* lknown, const void* rknown, const void* loff,
    const void* roff, const void* tabs, void* fs, void* ityp, void* ops,
    void* opr, void* opc, int nb, int M, int W, int NL, int NR, int T,
    int open_, int halfp, void* stream) {
  if (W < 1 || W > 32 || M < 1 || NL < 1 || NR < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  bridge_traceback_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nogap, (const int32_t*)gap1, (const int32_t*)gap2,
      (const uint8_t*)ndiag, (const int32_t*)len1, (const int32_t*)len2L,
      (const int32_t*)len2R, (const int32_t*)lbandL, (const int32_t*)lbandR,
      (const int32_t*)gl, (const int32_t*)grv, (const int32_t*)lknown,
      (const int32_t*)rknown, (const int32_t*)loff, (const int32_t*)roff,
      (const int32_t*)tabs, (int32_t*)fs, (int32_t*)ityp, (int8_t*)ops,
      (int32_t*)opr, (int32_t*)opc, nb, M, W, NL, NR, T, open_, halfp);
  return (int)cudaGetLastError();
}
