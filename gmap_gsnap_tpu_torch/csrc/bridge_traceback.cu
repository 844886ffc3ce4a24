// Kernel K12: the intron junction search and both sides' tracebacks of
// GMAP's junction dynprog.
//
// Replaces gmap_gsnap_tpu/ops/dynprog.py bridge_intron (:328, with
// dinucl_codes_left/right :270/:284 and intron_score_table :298) followed
// by traceback (:194) on the left and the right side (bridge_intron_gap,
// dynprog.c:3701-3830, and the traceback state machine of
// dynprog.c:2612-2715).  One CTA per junction problem b; the K11
// matrices of its left side are problem b, of its reversed right side
// problem nb + b.
//
// Design.  A main-path call carries 8-14 junctions, so as many CTAs share
// 132 SMs and the kernel's time is one CTA's latency: what it waits on is
// one global round trip and the traceback, up to T steps each of whose
// addresses depends on the step before.  So the CTA is 1024 threads (32
// warps to hide the shared-memory latency of the parallel phases) and:
//   * staging: both sides' nogap, gap1, gap2 and ndiag ([M+1, W] each),
//     the known-site rewards and the score and type tables go to shared
//     memory once, each as the 16-byte chunks that cover it (a problem's
//     block starts at b (M+1) W elements, not 16-byte aligned for W =
//     23; the last chunk reads only to the array's end and zero-fills
//     the rest), with asynchronous copies (cp.async) all in flight at
//     once, so that the staging costs one round trip; the dinucleotide
//     codes of both genome windows are computed meanwhile (dynamic
//     shared memory, bridge_smem_bytes; over 48 KB with the attribute
//     set);
//   * decisions: lane k of each warp computes, for column k of its rows,
//     the three decisions the state machine takes at (r, k): NOGAP's next
//     state from (r-1, k), GAP1's continue bit from (r, k-1) with its r ==
//     0 / c > 1 rules, GAP2's from (r-1, k+1) with its c == 0 / r > 1
//     rules, each with >= (jump late, the right side) or > (jump early,
//     the left side) as dynprog.py re-derives them, and packs them into a
//     byte a cell;
//   * the junction search: 64 threads a candidate row take its 2W
//     columns in JAX's linear order (per rL = 1..M: family A, cL varying
//     in the band with cR pinned at rR = len1 - rL, then family B, cR
//     varying with cL pinned at rL), reading shared memory, one
//     branch-free expression for both families; each scores nogap +
//     known-site reward - the gap-avoidance flag of its varying side +
//     the intron reward of its dinucleotide pair (the reward and type
//     tables, which carry cdna_direction, finalp and nosplicing, come
//     from the wrapper) + the pinned side, NEG_INF where the split is out
//     of range or the two sides would overlap (the separation test, in
//     int32 as JAX's); a block reduction of  score * 2^32 + (2^32 - 1 -
//     candidate)  (warp shuffles and one cross-warp step) gives JAX's
//     first maximum, and the thread that holds it turns it into (rL, cL,
//     rR, cR), the final score (halfp takes half the intron reward back)
//     and the normalised intron type;
//   * the walk: one thread a side, in two warps, walks from (rL, cL) and
//     (rR, cR), each step one shared byte and a move of (r, c, state),
//     and stops at DONE.  A position off the table (the walk can leave
//     the band: out of it every cell reads NEG_INF, and NEG_INF >= or >
//     NEG_INF + open holds, so a GAP1 walk steps past k = 0) takes the
//     same decisions computed from shared memory with NEG_INF off the
//     band.  The steps go to shared memory; after DONE the outputs are
//     constant (OP_NONE, r - 1, c - 1 of the frozen (r, c)), and the CTA
//     writes all 2 T steps of both sides with coalesced stores.
//
// Bound: the bytes (both sides' nogap and ndiag, the problem's inputs,
// 2 + 18 T bytes out) take well under a microsecond for 14 junctions; the
// kernel is bound by its serial chain instead, and its slowest CTA sets
// its time.  A probe that stamps every CTA with clock64 on an H100
// (tools/probe_bridge_phases.py, 14 and 128 random junctions) reads
// 13.9k-24.6k cycles a CTA: ~3.6k of set-up and copy issue, ~1.3k for
// the copies to land, ~3.9k for the decision table, ~4-5k for the search
// and its reduction, and the rest for the walks and the stores, ~170-190
// cycles a step of the longer walk, so the CTA with the longest walk
// (~60 steps, ~10.4k cycles) is the slowest.
#include <cuda_pipeline.h>

#include "common.cuh"

// BRIDGE_STAMP(i): the end of phase i of a CTA (0 its start, 1 the copies
// issued, 2 landed, 3 the decision table, 4 the search and its reduction,
// 5 the walks, 6 thread 0's stores); empty unless a probe defines it
// (tools/probe_bridge_phases.py)
#ifndef BRIDGE_STAMP
#define BRIDGE_STAMP(i)
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemMax = 232448;   // a CTA's opt-in shared memory
constexpr int kStaticSmem = 512;   // s_start, s_walk, gmap_block_max's
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

// Words of shared memory that stage16 needs for n bytes: the 16-byte
// chunks that cover them wherever they start.
__host__ __device__ inline int64_t chunk_words(int64_t n) {
  return (n + 15) / 16 * 4 + 4;
}

// A 16-byte chunk to shared dst by an asynchronous copy (cp.async) that
// reads the first `bytes` of it at global src and zero-fills the rest;
// the source size is a register, not a switch over constants.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
#else
  __pipeline_memcpy_async(dst, src, 16, 16 - bytes);
#endif
}

// n bytes at global src: the 16-byte chunks that cover them, copied to
// the 16-byte aligned dst with asynchronous copies (cp.async), every copy
// of the CTA in flight at once (__pipeline_wait_prior(0) and
// __syncthreads() complete them); returns where src's first byte lands.
// The first chunk starts up to 15 bytes before src, inside src's
// allocation (device allocations are aligned to 256 bytes); the last
// reads only up to src + n and zero-fills the rest of its 16 bytes.
__device__ __forceinline__ const uint8_t* stage16(int32_t* dst,
                                                  const void* src, int n) {
  const uintptr_t a = (uintptr_t)src;
  const int shift = (int)(a & 15);
  const uint4* from = (const uint4*)(a - shift);
  const int end = shift + n, chunks = (end + 15) >> 4;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    copy16((uint4*)dst + i, from + i, min(16, end - 16 * i));
  return (const uint8_t*)dst + shift;
}

// Dynamic shared memory of one CTA (kernels/limits.py
// bridge_traceback_bytes): as 16-byte chunks, nogap, gap1, gap2 and
// ndiag of both sides, the known-site rewards and the score and type
// tables; the walks' opr / opc; bytes: the decision table of both sides,
// the dinucleotide codes, the walks' ops.
__host__ __device__ inline int64_t bridge_smem_bytes(int M, int W, int NL,
                                                     int NR, int T) {
  const int64_t mat = (int64_t)(M + 1) * W;
  return 4 * (6 * chunk_words(4 * mat) + 2 * chunk_words(mat) +
              chunk_words(4 * (NL + 1)) + chunk_words(4 * (NR + 1)) +
              chunk_words(4 * 128) + 4 * (int64_t)T) +
         (2 * mat + (NL + 1) + (NR + 1) + 2 * (int64_t)T);
}

struct Side {  // one side's staged [M+1, W] matrices
  const int32_t* nogap;
  const int32_t* gap1;
  const int32_t* gap2;
  const uint8_t* ndiag;
};

struct Problem {
  Side L, R;
  int len1, len2L, len2R, lbL, lbR, NL, NR, M, W;
  int32_t sep;
  const uint8_t *ldi, *rdi;    // [NL + 1], [NR + 1]
  const int32_t *lkn, *rkn;    // [NL + 1], [NR + 1]
  const int32_t* itab;
};

// Candidate (m, col) of the [M, 2W] block: its score and intron type
// bitmask.  Family A (col < W): cL varies in the band, cR is pinned at rR;
// family B: cR varies, cL is pinned at rL.  Both families are one
// branch-free expression over the varying and the pinned side.
__device__ __forceinline__ int32_t candidate(const Problem& p, int m,
                                             int col, int* ity) {
  const int W = p.W;
  const bool inB = col >= W;
  const int kb = inB ? col - W : col;
  const int rL = m + 1, rR = p.len1 - rL;
  const bool rok = rL >= 1 && rL <= p.len1 - 1;
  const int rowL = clampi(rL, 0, p.M), rowR = clampi(rR, 0, p.M);
  const int cL = inB ? rL : rL + kb - p.lbL;  // the left column
  const int cR = inB ? rR + kb - p.lbR : rR;  // the right column
  const bool okL = cL >= 1 && cL <= p.len2L - 1;
  const bool okR = cR >= 1 && cR <= p.len2R - 1;
  const int ldi = cL <= p.len2L - 2 ? p.ldi[clampi(cL, 0, p.NL)] : 0;
  const int rdi = cR <= p.len2R - 2 ? p.rdi[clampi(cR, 0, p.NR)] : 0;
  *ity = ldi & rdi;
  // the sides may not overlap: pinned row < sep - varying column, in
  // int32 as JAX's
  const int cvar = inB ? cR : cL, cpin = inB ? rL : rR;
  const bool ok = okL && okR && rok &&
                  cpin < (int32_t)((uint32_t)p.sep - (uint32_t)cvar);
  const Side var = inB ? p.R : p.L;
  const int row = inB ? rowR : rowL;
  const int kpin = clampi(inB ? p.lbL : p.lbR, 0, W - 1);
  const int32_t pin = inB ? p.L.nogap[rowL * W + kpin]
                          : p.R.nogap[rowR * W + kpin];
  return ok ? var.nogap[row * W + kb] - (int32_t)var.ndiag[row * W + kb] +
                  p.lkn[clampi(cL, 0, p.NL)] + p.rkn[clampi(cR, 0, p.NR)] +
                  p.itab[*ity] + pin
            : kNegInf;
}

// a[i] where ok, NEG_INF elsewhere (a cell off the band or the rows)
__device__ __forceinline__ int32_t cell(const int32_t* a, bool ok, int i) {
  return ok ? a[i] : kNegInf;
}

__device__ __forceinline__ bool ge(bool late, int32_t a, int32_t b) {
  return late ? a >= b : a > b;
}

// The three decisions of dynprog.py traceback (:194) at (r, c), k = c -
// r + lband, any (r, k): bits 0-1 NOGAP's next state from (r-1, k), bit 2
// GAP1 continues (from (r, k-1)), bit 3 GAP2 continues (from (r-1, k+1)).
__device__ __forceinline__ int decide(const Side& s, int r, int c, int k,
                                      bool late, int M1, int W, int open_) {
  const bool up = r >= 1 && r <= M1, row = r >= 0 && r < M1;
  const bool kin = k >= 0 && k < W, kl = k >= 1 && k <= W,
             kr = k >= -1 && k < W - 1;
  const int iu = (r - 1) * W + k, ir = r * W + k;
  const int32_t ng = cell(s.nogap, up && kin, iu);
  const int32_t g1 = cell(s.gap1, up && kin, iu);
  const int32_t g2 = cell(s.gap2, up && kin, iu);
  const bool takeh = ge(late, g1, ng);
  const bool takev = ge(late, g2, max(ng, g1));
  const int next = takev ? kGap2 : (takeh ? kGap1 : kNogap);
  bool h = ge(late, cell(s.gap1, row && kl, ir - 1),
              cell(s.nogap, row && kl, ir - 1) + open_) && r > 0 && c > 1;
  if (r == 0) h = c > 1;
  bool v = ge(late, cell(s.gap2, up && kr, iu + 1),
              cell(s.nogap, up && kr, iu + 1) + open_) && c > 0 && r > 1;
  if (c == 0) v = r > 1;
  return next | (int)h << 2 | (int)v << 3;
}

// decide() for the walk's rare steps off the table, kept out of its loop
__device__ __noinline__ int decide_off(const Side s, int r, int c, int k,
                                       bool late, int M1, int W, int open_) {
  return decide(s, r, c, k, late, M1, W, open_);
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
  extern __shared__ __align__(16) uint8_t s_raw[];
  __shared__ int s_start[4];    // rL, cL, rR, cR
  __shared__ int s_walk[2][3];  // per side: steps kept, frozen r, c
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int M1 = M + 1, mat = M1 * W;
  BRIDGE_STAMP(0);
  // the staged inputs, then the walks' steps, then bytes
  int32_t* at = (int32_t*)s_raw;
  auto take = [&](int64_t words) {
    int32_t* x = at;
    at += words;
    return x;
  };
  const int32_t *s_ng[2], *s_g1[2], *s_g2[2];
  const uint8_t* s_nd[2];
  for (int s = 0; s < 2; ++s) {
    const int64_t o = (int64_t)(s * nb + b) * mat;
    const int64_t w4 = chunk_words(4 * (int64_t)mat);
    s_ng[s] = (const int32_t*)stage16(take(w4), nogap + o, 4 * mat);
    s_g1[s] = (const int32_t*)stage16(take(w4), gap1 + o, 4 * mat);
    s_g2[s] = (const int32_t*)stage16(take(w4), gap2 + o, 4 * mat);
    s_nd[s] = stage16(take(chunk_words(mat)), ndiag + o, mat);
  }
  const int32_t* s_lkn = (const int32_t*)stage16(
      take(chunk_words(4 * (NL + 1))), lknown + (int64_t)b * (NL + 1),
      4 * (NL + 1));
  const int32_t* s_rkn = (const int32_t*)stage16(
      take(chunk_words(4 * (NR + 1))), rknown + (int64_t)b * (NR + 1),
      4 * (NR + 1));
  const int32_t* s_tab = (const int32_t*)stage16(take(chunk_words(4 * 128)),
                                                 tabs, 4 * 128);
  __pipeline_commit();
  BRIDGE_STAMP(1);
  int32_t* s_opr = take(2 * T);  // [2][T]
  int32_t* s_opc = take(2 * T);
  uint8_t* s_dec = (uint8_t*)at;              // [2][mat]
  uint8_t* s_ldi = s_dec + 2 * mat;           // [NL + 1]
  uint8_t* s_rdi = s_ldi + NL + 1;            // [NR + 1]
  int8_t* s_ops = (int8_t*)(s_rdi + NR + 1);  // [2][T]

  // the dinucleotide codes and the scalars load while the copies fly
  const int32_t* glb = gl + (int64_t)b * NL;
  const int32_t* grb = grv + (int64_t)b * NR;
  for (int c = tid; c <= NL; c += blockDim.x) s_ldi[c] = left_di(glb, NL, c);
  for (int c = tid; c <= NR; c += blockDim.x) s_rdi[c] = right_di(grb, NR, c);

  Problem p;
  p.L = {s_ng[0], s_g1[0], s_g2[0], s_nd[0]};
  p.R = {s_ng[1], s_g1[1], s_g2[1], s_nd[1]};
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
  p.ldi = s_ldi;
  p.rdi = s_rdi;
  p.lkn = s_lkn;
  p.rkn = s_rkn;
  p.itab = s_tab;
  __pipeline_wait_prior(0);
  __syncthreads();
  BRIDGE_STAMP(2);

  // the decision table, lane k of a warp taking column k of its rows:
  // left side jumps early, right side late
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  if (lane < W) {
    for (int s = 0; s < 2; ++s) {
      const Side sd = s ? p.R : p.L;
      const int lb = s ? p.lbR : p.lbL;
      for (int r = warp; r < M1; r += nwarps)
        s_dec[s * mat + r * W + lane] = (uint8_t)decide(
            sd, r, lane + r - lb, lane, s == 1, M1, W, open_);
    }
  }

  BRIDGE_STAMP(3);

  // the candidates, column col of a row in 64 threads; each thread keeps
  // its best key and that candidate's intron type
  int64_t mine = INT64_MIN;
  int my_ity = 0;
  const int col = tid & 63;
  if (col < 2 * W) {
    for (int m = tid >> 6; m < M; m += blockDim.x >> 6) {
      int ity;
      const int32_t score = candidate(p, m, col, &ity);
      const int64_t key = gmap_first_max_key(score, m * 2 * W + col);
      if (key > mine) {
        mine = key;
        my_ity = ity;
      }
    }
  }
  // synchronises: the table is complete; the one thread holding the
  // maximum (keys are distinct) turns it into the junction
  const int64_t key = gmap_block_max(mine);
  BRIDGE_STAMP(4);
  if (mine == key) {
    const int best = gmap_key_index(key);
    const int32_t bestscore = gmap_key_value(key);
    const int ity = my_ity;
    const int brow = best / (2 * W), bcol = best % (2 * W);
    const bool inB = bcol >= W;
    const int bk = inB ? bcol - W : bcol;
    const int rL = brow + 1, rR = p.len1 - rL;
    s_start[0] = rL;
    s_start[1] = inB ? rL : rL + bk - p.lbL;
    s_start[2] = rR;
    s_start[3] = inB ? rR + bk - p.lbR : rR;
    const int32_t besti = s_tab[ity];
    fs[b] = halfp ? bestscore - besti / 2 : bestscore;
    ityp[b] = s_tab[64 + ity];
  }
  __syncthreads();

  if ((tid & 31) == 0 && tid < 64) {  // lane 0 of warps 0 and 1: a side each
    const int s = tid >> 5;
    const Side sd = s ? p.R : p.L;
    const int lb = s ? p.lbR : p.lbL;
    const uint8_t* dec = s_dec + s * mat;
    int r = s_start[2 * s], c = s_start[2 * s + 1];
    int state = kNogap, t = 0;
    for (; t < T; ++t) {
      if (state == kDone || (state == kNogap && (r <= 0 || c <= 0))) break;
      const int k = c - r + lb;
      const int d = (r >= 0 && r < M1 && k >= 0 && k < W)
                        ? dec[r * W + k]
                        : decide_off(sd, r, c, k, s == 1, M1, W, open_);
      s_ops[s * T + t] = (int8_t)(state == kNogap  ? kOpDiag
                                  : state == kGap1 ? kOpHoriz
                                                   : kOpVert);
      s_opr[s * T + t] = state == kGap1 ? r : r - 1;
      s_opc[s * T + t] = state == kGap2 ? c : c - 1;
      const bool at_origin = r <= 0 && c <= 0;
      const int next = state == kNogap  ? (d & 3)
                       : state == kGap1 ? ((d & 4) ? kGap1 : kNogap)
                                        : ((d & 8) ? kGap2 : kNogap);
      if (state != kGap1) --r;
      if (state != kGap2) --c;
      state = at_origin ? kDone : next;
    }
    s_walk[s][0] = t;
    s_walk[s][1] = r;
    s_walk[s][2] = c;
  }
  __syncthreads();
  BRIDGE_STAMP(5);

  // both sides' T steps; past DONE: OP_NONE at the frozen (r - 1, c - 1)
  for (int i = tid; i < 2 * T; i += blockDim.x) {
    const int s = i >= T, t = i - s * T;
    const int64_t o = ((int64_t)s * nb + b) * T + t;
    const bool kept = t < s_walk[s][0];
    ops[o] = kept ? s_ops[i] : (int8_t)kOpNone;
    opr[o] = kept ? s_opr[i] : s_walk[s][1] - 1;
    opc[o] = kept ? s_opc[i] : s_walk[s][2] - 1;
  }
  BRIDGE_STAMP(6);
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
  const int64_t smem = bridge_smem_bytes(M, W, NL, NR, T);
  if (smem + kStaticSmem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bridge_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bridge_traceback_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)nogap, (const int32_t*)gap1, (const int32_t*)gap2,
      (const uint8_t*)ndiag, (const int32_t*)len1, (const int32_t*)len2L,
      (const int32_t*)len2R, (const int32_t*)lbandL, (const int32_t*)lbandR,
      (const int32_t*)gl, (const int32_t*)grv, (const int32_t*)lknown,
      (const int32_t*)rknown, (const int32_t*)loff, (const int32_t*)roff,
      (const int32_t*)tabs, (int32_t*)fs, (int32_t*)ityp, (int8_t*)ops,
      (int32_t*)opr, (int32_t*)opc, nb, M, W, NL, NR, T, open_, halfp);
  return (int)cudaGetLastError();
}
