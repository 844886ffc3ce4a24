// Kernel K16: the top diagonal pairs of a read by vote sum.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _select_pairs (:334) with
// its two eligibility rules: for candidate diagonals i (left piece) and j
// (right piece) of a read, score = votes[i] + votes[j] where the pair is
// eligible and both diagonals are valid, else -1; the first P (=
// min(maxpairs, NC^2)) entries of the stable descending sort of the NC^2
// scores, -1 entries included in flat order, give (i, j, score >= 0).
//   rule 0 (middle indels): ndel = int32(dj - di), nins = int32(di - dj)
//     with the uint32 difference wrapping, ndel in [1, a] or nins in
//     [1, b];
//   rule 1 (local splices): (dj - di) as uint32 in [1, a].
//
// Bound: bytes at NC = 32 (the diagonals, votes and P outputs of a read,
// under 3 MB at 4096 reads), operations at NC = 128 (an eligibility test
// and a key for each of the NC^2 entries).  The design this one replaces
// (one CTA a read running P rounds, each recomputing all NC^2 keys and
// ending in a block max-reduction with its barriers) took 0.2833 ms at
// 4096 rows, NC=32, P=16 on the H100 (700 W), 2.3x one stable torch.sort
// of the negated scores.
//
// Design (row_sort.cuh): each entry's key is computed once, in
// registers:
//   key = (0x3FFFF - (score + 1)) << 14 | flat,   flat = i * NC + j,
// so the ascending order of the keys is the stable descending order of
// the scores, and the keys are distinct.  score + 1 must lie in [0,
// 2^18 - 1) (what top_diagonals produces: votes <= W <= 32768) and flat
// below 2^14 (NC <= 128); an eligible score outside that traps, and the
// launch fails: it is never clamped.  Eligibility is one test on the
// uint32 difference dj - di, its bounds worked out on the host for
// either rule.  Thread t of the row holds the entries t + T * r (T
// threads, r < KPL, KPL = 1..32 as NC^2 needs): one warp a read up to
// NC = 32 (1,024 entries; four reads a CTA, no block barrier), up to 16
// warps a read at NC = 128, whose counts go through shared memory only
// across warps.  The P smallest keys are found without sorting the
// entries: a bisection on the key's high bits (the score) and then on
// the whole key counts the keys at or below a candidate threshold (row
// sums, as K2 does); exactly P keys lie at or below the last, and only
// those are compacted (row exclusive sums) and sorted, in shared memory.
// Padding entries (flat >= NC^2) carry key 0xFFFFFFFF, above every real
// key whenever there are any (NC < 128 then, so flat < 0x3FFF).
#include "row_sort.cuh"

namespace {

constexpr int kMaxNC = 128;
constexpr int kRowsPerWarpBlock = 4;  // reads of a CTA when a warp is a read
constexpr int kRedInts = 32;
constexpr int kSmemMax = 232448;      // a CTA's opt-in shared memory
constexpr uint32_t kNoKey = 0xFFFFFFFFu;
constexpr uint32_t kNoScore = 0x3FFFFu;  // the high bits of a -1 entry
constexpr int64_t kMaxScore = 0x3FFFE;   // score + 1 < 2^18 - 1

// shared-memory bytes of one read: diagonals, votes, the selected keys
// (s, P rounded up to a power of two) and the row's sums, rounded up to
// 8 bytes
__host__ __device__ inline size_t row_bytes(int NC, int s) {
  return ((size_t)NC * 8 + ((size_t)NC + s + kRedInts) * 4 + 7) / 8 * 8;
}

template <int KPL, int NW>
__global__ void __launch_bounds__(NW == 1 ? 32 * kRowsPerWarpBlock : 32 * NW)
    select_pairs_kernel(const int64_t* __restrict__ top_d,
                        const int32_t* __restrict__ votes,
                        int64_t* __restrict__ ii, int64_t* __restrict__ jj,
                        uint8_t* __restrict__ valid, int B, int NC, int P,
                        int S, uint32_t A, uint32_t Bn) {
  constexpr int T = 32 * NW;  // threads of a read
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int slot = NW == 1 ? (int)(threadIdx.x >> 5) : 0;
  const int64_t b = (int64_t)blockIdx.x * (NW == 1 ? kRowsPerWarpBlock : 1)
                    + slot;
  if (b >= B) return;  // a whole warp (NW == 1) or the whole CTA
  uint8_t* base = smem_raw + (size_t)slot * row_bytes(NC, S);
  uint64_t* s_d = (uint64_t*)base;  // bit 32: a valid diagonal; low: its bits
  int32_t* s_v = (int32_t*)(s_d + NC);
  uint32_t* sel = (uint32_t*)(s_v + NC);
  int* red = (int*)(sel + S);
  const int t = row_thread<NW>();

  for (int e = t; e < NC; e += T) {
    const int64_t d = top_d[b * NC + e];
    s_d[e] = (uint64_t)(d != GSNAP_INVALID_DIAG) << 32 | (uint32_t)d;
    s_v[e] = votes[b * NC + e];
  }
  row_sync<NW>();

  // every entry's key, once; (i, j) of entry t + T * r advance by T (j
  // stays where T is a multiple of NC)
  const int n = NC * NC;
  const int di_step = T / NC, dj_step = T - (T / NC) * NC;
  int i = t / NC, j = t - (t / NC) * NC;
  uint64_t dj = s_d[j];
  int32_t vj = s_v[j];
  uint32_t key[KPL];
  uint32_t lo = kNoScore;  // the row's smallest high bits
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int f = t + T * r;
    if (f < n) {
      const uint64_t di = s_d[i];
      const uint32_t dd = (uint32_t)dj - (uint32_t)di;
      uint32_t high = kNoScore;
      if (((di & dj) >> 32) && (dd - 1u < A || ~dd < Bn)) {
        const int64_t sc = (int64_t)s_v[i] + vj;
        if (sc < 0 || sc > kMaxScore) __trap();
        high = kNoScore - (uint32_t)(sc + 1);
      }
      key[r] = high << 14 | (uint32_t)f;
      lo = min(lo, high);
    } else {
      key[r] = kNoKey;
    }
    i += di_step;
    j += dj_step;
    if (j >= NC) {
      j -= NC;
      ++i;
    }
    if (dj_step != 0) {
      dj = s_d[j];
      vj = s_v[j];
    }
  }

  // the P-th smallest key: its high bits, then the key
  lo = row_extreme<NW>(lo, false, red);
  const uint32_t high =
      row_lowest_reaching<KPL, NW>(key, lo, kNoScore, 14, P, red);
  const uint32_t cut = row_lowest_reaching<KPL, NW>(
      key, high << 14, high << 14 | (uint32_t)(n - 1), 0, P, red);

  // the P keys at or below it, compacted and sorted
  int nsel = 0;
#pragma unroll
  for (int r = 0; r < KPL; ++r) nsel += key[r] <= cut;
  int at = row_exclusive_sum<NW>(nsel, red);
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    if (key[r] <= cut) sel[at++] = key[r];
  for (int e = P + t; e < S; e += T) sel[e] = kNoKey;
  row_sync<NW>();
  row_sort_shared<NW>(sel, S, t, T);

  for (int e = t; e < P; e += T) {
    const uint32_t k = sel[e];
    const int f = (int)(k & 0x3FFFu);
    const int64_t o = b * P + e;
    ii[o] = f / NC;
    jj[o] = f % NC;
    valid[o] = (k >> 14) != kNoScore;
  }
}

template <int KPL, int NW>
int launch_pairs(const int64_t* top_d, const int32_t* votes, int64_t* ii,
                 int64_t* jj, uint8_t* valid, int B, int NC, int P, int S,
                 uint32_t A, uint32_t Bn, cudaStream_t stream) {
  constexpr int rows = NW == 1 ? kRowsPerWarpBlock : 1;
  const size_t smem = (size_t)rows * row_bytes(NC, S);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_pairs_kernel<KPL, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_pairs_kernel<KPL, NW><<<gsnap_blocks(B, rows), 32 * NW * rows,
                                 smem, stream>>>(top_d, votes, ii, jj, valid,
                                                 B, NC, P, S, A, Bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gsnap_select_pairs(const void* top_d, const void* votes,
                                  void* ii, void* jj, void* valid, int B,
                                  int NC, int P, int rule, int64_t a, int b,
                                  void* stream) {
  if (NC < 1 || NC > kMaxNC || P < 1 || P > NC * NC || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int s = 1;
  while (s < P) s <<= 1;
  // eligibility as (dd - 1 < A) || (~dd < Bn) on dd = uint32(dj - di):
  // rule 0's ndel = int32(dd) in [1, a] and nins = int32(-dd) in [1, b]
  // (ndel - 1 and nins - 1 as uint32; bounds clamped to [0, 2^31 - 1]),
  // rule 1's dd in [1, a] (bound clamped to [0, 2^32 - 1])
  const auto clamp = [](int64_t x, int64_t top) {
    return (uint32_t)(x < 0 ? 0 : x > top ? top : x);
  };
  const uint32_t A = rule == 0 ? clamp(a, 0x7FFFFFFF) : clamp(a, 0xFFFFFFFF);
  const uint32_t Bn = rule == 0 ? clamp(b, 0x7FFFFFFF) : 0u;
  const int n = NC * NC;  // entries: one warp a read to 1,024
  const auto* td = (const int64_t*)top_d;
  const auto* vt = (const int32_t*)votes;
  auto* io = (int64_t*)ii;
  auto* jo = (int64_t*)jj;
  auto* vo = (uint8_t*)valid;
  const cudaStream_t st = (cudaStream_t)stream;
#define GSNAP_PAIRS(KPL, NW) \
  launch_pairs<KPL, NW>(td, vt, io, jo, vo, B, NC, P, s, A, Bn, st)
  if (n <= 32) return GSNAP_PAIRS(1, 1);
  if (n <= 64) return GSNAP_PAIRS(2, 1);
  if (n <= 128) return GSNAP_PAIRS(4, 1);
  if (n <= 256) return GSNAP_PAIRS(8, 1);
  if (n <= 512) return GSNAP_PAIRS(16, 1);
  if (n <= 1024) return GSNAP_PAIRS(32, 1);
  if (n <= 2048) return GSNAP_PAIRS(32, 2);
  if (n <= 4096) return GSNAP_PAIRS(32, 4);
  if (n <= 8192) return GSNAP_PAIRS(32, 8);
  return GSNAP_PAIRS(32, 16);
#undef GSNAP_PAIRS
}
