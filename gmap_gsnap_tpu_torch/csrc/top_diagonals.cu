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

// ---------------------------------------------------------------- wide rows
//
// Rows wider than kMaxN (the runner's exact seed grid, W = S x the size
// threshold, for reads whose grid still truncates at the wide lane's
// 4,096 slots: reads past ~4,100 bases, or repeats) do not fit a CTA's
// registers.  One CTA of 1,024 threads a row sorts the row through two
// scratch rows of device memory with a stable LSD radix sort (4 passes of
// 8 bits; a tile of 1,024 keys at a time, each key's place from its
// digit's count before the tile and its rank among the tile's keys of
// that digit: 8 ballots within a warp, the warps' counts in shared
// memory), then walks its sorted row in 1,024 contiguous chunks, a chunk
// a thread: a head's votes are the distance to the next first (the next
// one in its chunk, else the first of a later chunk: row_later_min).  The
// m = min(NC, ndistinct) heads of most votes, fewest-position first, are
// found by a two-level histogram of the votes (12 bits each: the m-th
// largest vote count v*, and how many heads lie above it), the heads
// above v* and the first heads at v* (in position order: a per-chunk
// count and an exclusive sum over the chunks) are collected, and only
// they are sorted, in shared memory.  Slow beside the register path, and
// taken only where it cannot be.

constexpr int kWideThreads = 1024;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxNC = 1024;
constexpr int kWideMaxW = 1 << 24;  // votes and positions in 24 bits
constexpr int kHistBins = 4096;     // 12 bits of a vote count

// the bin b* (from the top) holding the m-th largest of the counted
// values, and the number of values in the bins above it (block-wide)
__device__ void wide_cut(const int* hist, int m, int* red, int* s_out) {
  const int t = threadIdx.x;
  constexpr int per = kHistBins / kWideThreads;
  int mine = 0;
  for (int j = 0; j < per; ++j) mine += hist[t * per + j];
  // values in the bins above this thread's: every later thread's
  const int total = row_sum<kWideWarps>(mine, red);
  const int before = row_exclusive_sum<kWideWarps>(mine, red);
  int above = total - before - mine;
  for (int j = per - 1; j >= 0; --j) {
    const int c = hist[t * per + j];
    if (above < m && above + c >= m) {
      s_out[0] = t * per + j;
      s_out[1] = above;
    }
    above += c;
  }
  __syncthreads();
}

template <typename Src>
__device__ void radix_pass(const Src* src, uint32_t* dst, int n, int shift,
                           int* s_hist, int* s_base, int* s_tile,
                           int* s_wc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j < 256; j += kWideThreads) s_hist[j] = 0;
  __syncthreads();
  for (int i = t; i < n; i += kWideThreads)
    atomicAdd(&s_hist[((uint32_t)src[i] >> shift) & 255u], 1);
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int d = 0; d < 256; ++d) {
      s_base[d] = run;
      run += s_hist[d];
    }
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < n; t0 += kWideThreads) {
    const int i = t0 + t;
    const bool ok = i < n;
    const uint32_t k = ok ? (uint32_t)src[i] : 0u;
    const uint32_t d = (k >> shift) & 255u;
    uint32_t peers = __ballot_sync(GSNAP_FULL_MASK, ok);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const uint32_t m = __ballot_sync(GSNAP_FULL_MASK, (d >> bit) & 1u);
      peers &= (d >> bit) & 1u ? m : ~m;
    }
    for (int j = t; j < kWideWarps * 256; j += kWideThreads) s_wc[j] = 0;
    __syncthreads();
    if (ok && (peers & below) == 0) s_wc[warp * 256 + d] = __popc(peers);
    __syncthreads();
    if (t < 256) {  // each digit's place in the tile, warp by warp
      int run = 0;
      for (int w = 0; w < kWideWarps; ++w) {
        const int c = s_wc[w * 256 + t];
        s_wc[w * 256 + t] = run;
        run += c;
      }
      s_tile[t] = run;
    }
    __syncthreads();
    if (ok)
      dst[s_base[d] + s_wc[warp * 256 + d] + __popc(peers & below)] = k;
    __syncthreads();
    if (t < 256) s_base[t] += s_tile[t];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWideThreads) top_diagonals_wide_kernel(
    const int64_t* __restrict__ diag, int64_t* __restrict__ top_d,
    int32_t* __restrict__ votes_o, int32_t* __restrict__ ndistinct,
    uint32_t* __restrict__ scratch, int W, int NC, int S) {
  constexpr uint32_t kInvalid = (uint32_t)GSNAP_INVALID_DIAG;
  __shared__ int s_int[kWideWarps * 256 + 3 * 256];  // radix, then hists
  __shared__ uint64_t sel[kWideMaxNC];
  __shared__ int red[32];
  __shared__ int s_cut[2];
  __shared__ int s_nsel;
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  uint32_t* A = scratch + b * 2 * (int64_t)W;
  uint32_t* Bf = A + W;

  // 1. the sorted row, in Bf
  {
    int* s_wc = s_int;
    int* s_hist = s_wc + kWideWarps * 256;
    radix_pass(diag + b * W, A, W, 0, s_hist, s_hist + 256, s_hist + 512,
               s_wc);
    radix_pass(A, Bf, W, 8, s_hist, s_hist + 256, s_hist + 512, s_wc);
    radix_pass(Bf, A, W, 16, s_hist, s_hist + 256, s_hist + 512, s_wc);
    radix_pass(A, Bf, W, 24, s_hist, s_hist + 256, s_hist + 512, s_wc);
  }
  const uint32_t* row = Bf;

  // 2. each thread's chunk, and the first run start after it
  const int chunk = (W + kWideThreads - 1) / kWideThreads;
  const int c0 = min(W, t * chunk), c1 = min(W, c0 + chunk);
  int my_first = W;
  for (int i = c0; i < c1; ++i)
    if (i == 0 || row[i] != row[i - 1]) {
      my_first = i;
      break;
    }
  const int after = row_later_min<kWideWarps>(my_first, W, red);
  // calls f(position, votes) for every head in the chunk
  auto heads = [&](auto f) {
    int h = -1;
    uint32_t prev = c0 > 0 ? row[c0 - 1] : 0u;
    for (int i = c0; i < c1; ++i) {
      const uint32_t x = row[i];
      if (i == 0 || x != prev) {
        if (h >= 0) f(h, i - h);
        h = x != kInvalid ? i : -1;
      }
      prev = x;
    }
    if (h >= 0) f(h, after - h);
  };

  // 3. the m-th largest vote count v*, by its high then its low 12 bits
  int* hist = s_int;
  for (int j = t; j < kHistBins; j += kWideThreads) hist[j] = 0;
  __syncthreads();
  int nh = 0;
  heads([&](int, int v) {
    atomicAdd(&hist[v >> 12], 1);
    ++nh;
  });
  __syncthreads();
  const int nd = row_sum<kWideWarps>(nh, red);
  const int m = min(NC, nd);
  int vstar = 0, gt = 0;
  if (m > 0) {
    wide_cut(hist, m, red, s_cut);
    const int hi = s_cut[0], above = s_cut[1];
    for (int j = t; j < kHistBins; j += kWideThreads) hist[j] = 0;
    __syncthreads();
    heads([&](int, int v) {
      if ((v >> 12) == hi) atomicAdd(&hist[v & 4095], 1);
    });
    __syncthreads();
    wide_cut(hist, m - above, red, s_cut);
    vstar = hi << 12 | s_cut[0];
    gt = above + s_cut[1];
  }
  // 4. the heads above v*, and the first m - gt at v* by position
  int neq = 0;
  heads([&](int, int v) { neq += v == vstar; });
  int eq_rank = row_exclusive_sum<kWideWarps>(neq, red);
  if (t == 0) s_nsel = 0;
  __syncthreads();
  heads([&](int p, int v) {
    bool take = v > vstar;
    if (v == vstar) take = eq_rank++ < m - gt;
    if (take)
      sel[atomicAdd(&s_nsel, 1)] =
          (uint64_t)(0xFFFFFFu - (uint32_t)v) << 24 | (uint32_t)p;
  });
  __syncthreads();
  for (int e = m + t; e < S; e += kWideThreads) sel[e] = ~0ull;
  __syncthreads();
  for (int kk = 2; kk <= S; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = t; i < S; i += kWideThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = sel[i], y = sel[ixj];
          if ((y < x) == ((i & kk) == 0)) {
            sel[i] = y;
            sel[ixj] = x;
          }
        }
      }
      __syncthreads();
    }

  // 5. outputs
  for (int j = t; j < NC; j += kWideThreads) {
    const int64_t o = b * NC + j;
    if (j < m) {
      const uint64_t kj = sel[j];
      votes_o[o] = (int32_t)(0xFFFFFFu - (uint32_t)(kj >> 24));
      top_d[o] = (int64_t)row[kj & 0xFFFFFFu];
    } else {
      votes_o[o] = 0;
      top_d[o] = GSNAP_INVALID_DIAG;
    }
  }
  if (t == 0) ndistinct[b] = nd;
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

// K2 on rows wider than 32,768 (at most 2^24 - 1 slots, ncand <= 1,024):
// scratch holds 2 W uint32 a row
extern "C" int gsnap_top_diagonals_wide(const void* diag, void* top_d,
                                        void* votes, void* ndistinct,
                                        void* scratch, int B, int W, int NC,
                                        void* stream) {
  if (W < 1 || W >= kWideMaxW || NC < 1 || NC > W || NC > kWideMaxNC ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int s = 1;
  while (s < NC) s <<= 1;
  top_diagonals_wide_kernel<<<B, kWideThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)diag, (int64_t*)top_d, (int32_t*)votes,
      (int32_t*)ndistinct, (uint32_t*)scratch, W, NC, s);
  return (int)cudaGetLastError();
}
