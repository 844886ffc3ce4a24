// Kernel K15: first and last seed query position per selected diagonal.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _qpos_ranges (:385), the
// reference's Segment querypos5 / querypos3 (stage1hr.c:9000): for each
// read b and selected diagonal d_sel[b, p], the min and max qpos over the
// seed slots w of the unsorted [B, W] seed grid whose diagonal equals it
// (2^30 and -1 where none does).  Empty seed slots carry the last usable
// oligo's qpos and d_sel may be INVALID_DIAG; the plain compare matches
// such slots exactly as this one does, and a diagonal repeated in d_sel
// gets the same answer at each of its places.
//
// Bound: bytes — each slot's diagonal and qpos read once (12 B a slot),
// the P selected diagonals and the two outputs (0.0063 ms at 4096 rows,
// W = 384, P = 32; 0.060 ms at W = 4096, P = 128, on the H100's 3.35
// TB/s).  The design this one replaces (a warp per (read, selected
// diagonal), each striding over the read's whole row) read every row P
// times from L2 and took 0.0366 ms at the first shape (H100, 700 W).
//
// Design: a warp per read, several reads a CTA, no block barrier.
//   1. The read's P selected diagonals, as keys d << 32 | p, are sorted
//      in registers (row_sort.cuh); the sorted d go to the warp's shared
//      row, each with a lo / hi pair.
//   2. The warp streams the read's slots once, 4 a lane a step with
//      16-byte loads; a slot finds the first sorted place of its diagonal
//      by a branch-free binary search (log2 P steps; an INVALID slot
//      none, its place found once) and, where the diagonal is there,
//      takes its qpos into that place's lo / hi: in the lane's registers
//      while it matches the place it matched last, else with shared
//      atomicMin / atomicMax (min and max do not depend on the order of
//      the slots).
//   3. Each place p reads the lo / hi of its diagonal's first place, so
//      repeated and INVALID entries of d_sel come out right.
// Diagonals are compared on their 32 bits: a diagonal or selected
// diagonal outside [0, 2^32) (K1 and K2 make none) traps.
#include "row_sort.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // reads of a CTA, a warp each
constexpr int kMaxP = 1024;       // 32 lanes x 32 keys
constexpr int kNone = 1 << 30;

// the first of the n (a power of two) sorted values s[] that is >= x,
// or n - 1 when every one is below x
__device__ __forceinline__ int first_at_least(const uint32_t* s, int n,
                                              uint32_t x) {
  int i = 0;
  for (int step = n >> 1; step > 0; step >>= 1)
    if (s[i + step - 1] < x) i += step;
  return i;
}

template <int KPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock) qpos_ranges_kernel(
    const int64_t* __restrict__ diag, const int32_t* __restrict__ qpos,
    const int64_t* __restrict__ d_sel, int32_t* __restrict__ qp5,
    int32_t* __restrict__ qp3, int B, int W, int P) {
  constexpr int N = 32 * KPL;  // sorted places, a power of two
  extern __shared__ __align__(16) uint32_t smem[];
  const int slot = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + slot;
  if (b >= B) return;  // warp-uniform exit
  uint32_t* s_d = smem + (size_t)slot * 3 * N;  // sorted diagonals
  int32_t* s_lo = (int32_t*)(s_d + N);
  int32_t* s_hi = s_lo + N;

  // 1. the selected diagonals, sorted with their places
  uint64_t key[KPL];
  uint64_t high = 0;  // any bits above 32 of a diagonal
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int e = lane * KPL + r;
    if (e < P) {
      const uint64_t d = (uint64_t)d_sel[b * P + e];
      high |= d >> 32;
      key[r] = d << 32 | (uint32_t)e;
    } else {
      key[r] = ~0ull;  // after every real key, its d never searched below P
    }
  }
  row_sort<uint64_t, KPL, 1>(key, nullptr);
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int e = lane * KPL + r;
    s_d[e] = (uint32_t)(key[r] >> 32);
    s_lo[e] = kNone;
    s_hi[e] = -1;
  }
  __syncwarp();

  // 2. every slot once.  A lane keeps the place it matched last with its
  // lo / hi in registers and takes them to shared memory only when it
  // matches another: the INVALID slots that fill a row's end (and match
  // an INVALID selected diagonal) then cost no atomics, and no search
  const int64_t* dg = diag + b * W;
  const int32_t* qg = qpos + b * W;
  constexpr uint32_t kInvalid = (uint32_t)GSNAP_INVALID_DIAG;
  int inv = first_at_least(s_d, N, kInvalid);  // INVALID's place, or -1
  if (inv >= P || s_d[inv] != kInvalid) inv = -1;
  int cg = -1, clo = kNone, chi = -1;  // the cached place and its range
  auto flush = [&]() {
    if (cg >= 0) {
      atomicMin(&s_lo[cg], clo);
      atomicMax(&s_hi[cg], chi);
    }
  };
  auto take = [&](uint64_t d, int q) {
    high |= d >> 32;
    const uint32_t x = (uint32_t)d;
    int i = inv;
    if (x != kInvalid) {
      i = first_at_least(s_d, N, x);
      if (i >= P || s_d[i] != x) i = -1;
    }
    if (i < 0) return;
    if (i != cg) {
      flush();
      cg = i;
      clo = q;
      chi = q;
    } else {
      clo = min(clo, q);
      chi = max(chi, q);
    }
  };
  int w0 = 0;
  if ((W & 3) == 0 && ((uintptr_t)dg & 15) == 0 && ((uintptr_t)qg & 15) == 0) {
    const uint4* dv = (const uint4*)dg;
    const uint4* qv = (const uint4*)qg;
#pragma unroll 2
    for (int v = lane; v < (W >> 2); v += 32) {
      const uint4 d01 = __ldg(dv + 2 * v), d23 = __ldg(dv + 2 * v + 1);
      const uint4 q4 = __ldg(qv + v);
      take((uint64_t)d01.y << 32 | d01.x, (int)q4.x);
      take((uint64_t)d01.w << 32 | d01.z, (int)q4.y);
      take((uint64_t)d23.y << 32 | d23.x, (int)q4.z);
      take((uint64_t)d23.w << 32 | d23.z, (int)q4.w);
    }
    w0 = W;
  }
  for (int w = w0 + lane; w < W; w += 32) take((uint64_t)dg[w], qg[w]);
  flush();
  if (high) __trap();
  __syncwarp();

  // 3. each place from its diagonal's first place
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int e = lane * KPL + r;
    if (e < P) {
      const int g = first_at_least(s_d, N, s_d[e]);
      const int64_t o = b * P + (uint32_t)key[r];
      qp5[o] = s_lo[g];
      qp3[o] = s_hi[g];
    }
  }
}

template <int KPL>
int launch_ranges(const int64_t* diag, const int32_t* qpos,
                  const int64_t* d_sel, int32_t* qp5, int32_t* qp3, int B,
                  int W, int P, cudaStream_t stream) {
  const size_t smem = (size_t)kRowsPerBlock * 3 * 32 * KPL * 4;  // <= 48 KB
  qpos_ranges_kernel<KPL><<<gsnap_blocks(B, kRowsPerBlock),
                            32 * kRowsPerBlock, smem, stream>>>(
      diag, qpos, d_sel, qp5, qp3, B, W, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gsnap_qpos_ranges(const void* diag, const void* qpos,
                                 const void* d_sel, void* qp5, void* qp3,
                                 int B, int W, int P, void* stream) {
  if (P < 0 || P > kMaxP || W < 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * P == 0) return 0;
  const auto* dg = (const int64_t*)diag;
  const auto* qg = (const int32_t*)qpos;
  const auto* ds = (const int64_t*)d_sel;
  auto* o5 = (int32_t*)qp5;
  auto* o3 = (int32_t*)qp3;
  const cudaStream_t st = (cudaStream_t)stream;
#define GSNAP_RANGES(KPL) \
  launch_ranges<KPL>(dg, qg, ds, o5, o3, B, W, P, st)
  if (P <= 32) return GSNAP_RANGES(1);
  if (P <= 64) return GSNAP_RANGES(2);
  if (P <= 128) return GSNAP_RANGES(4);
  if (P <= 256) return GSNAP_RANGES(8);
  if (P <= 512) return GSNAP_RANGES(16);
  return GSNAP_RANGES(32);
#undef GSNAP_RANGES
}
