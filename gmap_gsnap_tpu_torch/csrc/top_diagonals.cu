// Kernel K2: vote on each read's diagonals and keep the best ncand.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _top_diagonals (:354): sort
// the read's W diagonals (uint32; INVALID sorts last), a run head's votes
// are its run length, and the NC heads of most votes are kept in (votes
// desc, diagonal asc) order — lax.top_k's lower-index tie rule on the
// sorted row — with votes 0 and INVALID after the read's last head.
//
// Bound: bytes — the row read once, NC diagonals and votes written.  At
// 4096 rows x W=384, NC=32 that is ~0.004 ms on the H100 (700 W); the
// design this one replaces (two bitonic sorts of the whole padded row
// in shared memory with a block barrier at every stage, a binary search
// per run head and the sorted row through a global scratch row) took
// 0.1601 ms there, and 1.8708 ms at W=4096, NC=128.
//
// Design (row_sort.cuh): the row, padded with INVALID to N = W rounded up
// to a power of two (at least 32), sits in registers, N / (32 NW) a
// thread: one warp a row where N <= 512 (four rows a CTA, no block
// barrier), else a CTA of NW = min(N / 512, 16) warps a row, whose
// bitonic stages go through shared memory only across warps.
//   1. sort the row (row_sort); the sorted row stays in shared memory.
//   2. run heads: a position is a run's first when it differs from the
//      one before; a head is a first that is not INVALID.  A head's votes
//      are the distance to the next first (the next run, the INVALID
//      run or N), found within the thread's registers or, past them,
//      from the minimum first position of the later threads
//      (row_later_min) — no search.  ndistinct counts the heads.
//   3. each head's key (0xFFFF - votes) << 16 | position orders the heads
//      as the output does, and the keys are distinct.  The M = min(NC,
//      ndistinct) smallest keys are selected without sorting the row
//      again: a binary search on the key's high half (votes) then on the
//      whole key counts keys at or below a candidate threshold (row
//      sums), and the keys at or below the M-th are compacted (row
//      exclusive sums) and sorted alone in shared memory.
//   4. output j < M is the diagonal at the key's position and its votes.
// Shared memory a row: the sorted row (N), the selected keys (NC rounded
// up to a power of two) and 32 ints for the row's sums.
#include "row_sort.cuh"

namespace {

constexpr int kMaxN = 32768;
constexpr int kRowsPerWarpBlock = 4;  // rows of a CTA when a warp is a row
constexpr int kRedInts = 32;
constexpr int kSmemMax = 232448;      // a CTA's opt-in shared memory

template <int KPL, int NW>
__global__ void __launch_bounds__(NW == 1 ? 32 * kRowsPerWarpBlock : 32 * NW)
    top_diagonals_kernel(const int64_t* __restrict__ diag,
                         int64_t* __restrict__ top_d,
                         int32_t* __restrict__ votes_o,
                         int32_t* __restrict__ ndistinct, int B, int W,
                         int NC, int S) {
  constexpr int N = 32 * KPL * NW;
  constexpr int T = 32 * NW;  // threads of a row
  constexpr uint32_t kInvalid = (uint32_t)GSNAP_INVALID_DIAG;
  constexpr uint32_t kNoKey = 0xFFFFFFFFu;
  extern __shared__ __align__(16) uint32_t smem[];
  const int slot = NW == 1 ? (int)(threadIdx.x >> 5) : 0;
  const int64_t b = (int64_t)blockIdx.x * (NW == 1 ? kRowsPerWarpBlock : 1)
                    + slot;
  if (b >= B) return;  // a whole warp (NW == 1) or the whole CTA
  uint32_t* row = smem + (int64_t)slot * (N + S + kRedInts);
  uint32_t* sel = row + N;
  int* red = (int*)(sel + S);
  const int t = row_thread<NW>();

  // 1. the sorted row, in registers and then in shared memory
  const int64_t* d = diag + b * W;
  for (int e = t; e < N; e += T) row[e] = e < W ? (uint32_t)d[e] : kInvalid;
  row_sync<NW>();
  uint32_t v[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) v[r] = row[t * KPL + r];
  row_sync<NW>();
  row_sort<uint32_t, KPL, NW>(v, row);
#pragma unroll
  for (int r = 0; r < KPL; ++r) row[t * KPL + r] = v[r];
  row_sync<NW>();

  // 2. run firsts and heads (bit r of the masks: position t * KPL + r)
  uint64_t first = 0, head = 0;
  int my_first = N, nheads = 0;
#pragma unroll
  for (int r = KPL - 1; r >= 0; --r) {
    const int p = t * KPL + r;
    const bool f = p == 0 || v[r] != (r > 0 ? v[r - 1] : row[p - 1]);
    if (f) {
      first |= 1ull << r;
      my_first = p;
      if (v[r] != kInvalid) {
        head |= 1ull << r;
        ++nheads;
      }
    }
  }
  const int nd = row_sum<NW>(nheads, red);
  int next = row_later_min<NW>(my_first, N, red);
  // 3. the heads' keys (kNoKey elsewhere), in v's registers
  uint32_t (&key)[KPL] = v;
#pragma unroll
  for (int r = KPL - 1; r >= 0; --r) {
    const int p = t * KPL + r;
    key[r] = (head >> r) & 1 ? (0xFFFFu - (uint32_t)(next - p)) << 16 |
                                   (uint32_t)p
                             : kNoKey;
    if ((first >> r) & 1) next = p;
  }
  const int m = min(NC, nd);
  uint32_t cut = kNoKey - 1;  // every head's key is below it
  if (nd > NC) {
    uint32_t lo = kNoKey, hi = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      if ((head >> r) & 1) {
        lo = min(lo, key[r] >> 16);
        hi = max(hi, key[r] >> 16);
      }
    lo = row_extreme<NW>(lo, false, red);
    hi = row_extreme<NW>(hi, true, red);
    const uint32_t high =
        row_lowest_reaching<KPL, NW>(key, lo, hi, 16, m, red);
    cut = row_lowest_reaching<KPL, NW>(
        key, high << 16, high << 16 | (uint32_t)(N - 1), 0, m, red);
  }
  int nsel = 0;
#pragma unroll
  for (int r = 0; r < KPL; ++r) nsel += key[r] <= cut;
  int at = row_exclusive_sum<NW>(nsel, red);
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    if (key[r] <= cut) sel[at++] = key[r];
  int s = 1;
  while (s < m) s <<= 1;
  for (int e = m + t; e < s; e += T) sel[e] = kNoKey;
  row_sync<NW>();

  // the m selected keys, sorted in shared memory
  row_sort_shared<NW>(sel, s, t, T);

  // 4. outputs
  for (int j = t; j < NC; j += T) {
    const int64_t o = b * NC + j;
    if (j < m) {
      const uint32_t kj = sel[j];
      votes_o[o] = (int32_t)(0xFFFFu - (kj >> 16));
      top_d[o] = (int64_t)row[kj & 0xFFFFu];
    } else {
      votes_o[o] = 0;
      top_d[o] = GSNAP_INVALID_DIAG;
    }
  }
  if (t == 0) ndistinct[b] = nd;
}

template <int KPL, int NW>
int launch_top(const int64_t* diag, int64_t* top_d, int32_t* votes,
               int32_t* nd, int B, int W, int NC, int S,
               cudaStream_t stream) {
  constexpr int N = 32 * KPL * NW;
  constexpr int rows = NW == 1 ? kRowsPerWarpBlock : 1;
  const size_t smem = (size_t)rows * (N + S + kRedInts) * sizeof(uint32_t);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        top_diagonals_kernel<KPL, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  top_diagonals_kernel<KPL, NW><<<gsnap_blocks(B, rows), 32 * NW * rows, smem,
                                  stream>>>(diag, top_d, votes, nd, B, W, NC,
                                            S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gsnap_top_diagonals(const void* diag, void* top_d, void* votes,
                                   void* ndistinct, int B, int W, int NC,
                                   void* stream) {
  if (W < 1 || W > kMaxN || NC < 1 || NC > W)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int n = 32, s = 1;
  while (n < W) n <<= 1;
  while (s < NC) s <<= 1;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* dg = (const int64_t*)diag;
  auto* td = (int64_t*)top_d;
  auto* vo = (int32_t*)votes;
  auto* nd = (int32_t*)ndistinct;
  switch (n) {
    case 32: return launch_top<1, 1>(dg, td, vo, nd, B, W, NC, s, st);
    case 64: return launch_top<2, 1>(dg, td, vo, nd, B, W, NC, s, st);
    case 128: return launch_top<4, 1>(dg, td, vo, nd, B, W, NC, s, st);
    case 256: return launch_top<8, 1>(dg, td, vo, nd, B, W, NC, s, st);
    case 512: return launch_top<16, 1>(dg, td, vo, nd, B, W, NC, s, st);
    case 1024: return launch_top<16, 2>(dg, td, vo, nd, B, W, NC, s, st);
    case 2048: return launch_top<16, 4>(dg, td, vo, nd, B, W, NC, s, st);
    case 4096: return launch_top<16, 8>(dg, td, vo, nd, B, W, NC, s, st);
    case 8192: return launch_top<16, 16>(dg, td, vo, nd, B, W, NC, s, st);
    case 16384: return launch_top<32, 16>(dg, td, vo, nd, B, W, NC, s, st);
    default: return launch_top<64, 16>(dg, td, vo, nd, B, W, NC, s, st);
  }
}
