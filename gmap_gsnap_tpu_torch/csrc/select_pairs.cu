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
// Design: one CTA per read, the read's diagonals and votes in shared
// memory; P rounds of a block max-reduction on the key
// (score + 1) << 32 | (0xFFFFFFFF - flat), which is the stable
// descending order; each thread keeps a bit mask of its taken entries
// (at most 64 of NC^2 <= 16,384).  Bound: operations — NC^2 eligibility
// tests per round over under 1 MB of inputs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNC = 128;

__global__ void __launch_bounds__(kThreads) select_pairs_kernel(
    const int64_t* __restrict__ top_d, const int32_t* __restrict__ votes,
    int64_t* __restrict__ ii, int64_t* __restrict__ jj,
    uint8_t* __restrict__ valid, int NC, int P, int rule, int64_t a, int bb) {
  __shared__ int64_t s_d[kMaxNC];
  __shared__ int32_t s_v[kMaxNC];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < NC; i += blockDim.x) {
    s_d[i] = top_d[b * NC + i];
    s_v[i] = votes[b * NC + i];
  }
  __syncthreads();
  const int n = NC * NC;
  uint64_t taken = 0;  // bit t: entry tid + t * blockDim.x is taken
  for (int round = 0; round < P; ++round) {
    int64_t best = -1;
    int t = 0;
    for (int f = tid; f < n; f += blockDim.x, ++t) {
      if ((taken >> t) & 1) continue;
      const int i = f / NC, j = f - (f / NC) * NC;
      const int64_t di = s_d[i], dj = s_d[j];
      bool elig;
      if (rule == 0) {
        const int32_t ndel = (int32_t)(uint32_t)(dj - di);
        const int32_t nins = (int32_t)(uint32_t)(di - dj);
        elig = (ndel >= 1 && ndel <= a) || (nins >= 1 && nins <= bb);
      } else {
        const int64_t d = (int64_t)(uint32_t)(dj - di);
        elig = d >= 1 && d <= a;
      }
      elig = elig && di != GSNAP_INVALID_DIAG && dj != GSNAP_INVALID_DIAG;
      const int64_t s = elig ? (int64_t)s_v[i] + s_v[j] : -1;
      const int64_t key = (s + 1) * 4294967296ll +
                          (int64_t)(0xFFFFFFFFu - (uint32_t)f);
      best = gmap_max64(best, key);
    }
    best = gmap_block_max(best);
    const int f = (int)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFll));
    if (f % blockDim.x == tid) taken |= 1ull << (f / blockDim.x);
    if (tid == 0) {
      const int64_t s = (best >> 32) - 1;
      ii[b * P + round] = f / NC;
      jj[b * P + round] = f % NC;
      valid[b * P + round] = s >= 0;
    }
  }
}

}  // namespace

extern "C" int gsnap_select_pairs(const void* top_d, const void* votes,
                                  void* ii, void* jj, void* valid, int B,
                                  int NC, int P, int rule, int64_t a, int b,
                                  void* stream) {
  if (NC < 1 || NC > kMaxNC || P < 1 || P > NC * NC || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  select_pairs_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)top_d, (const int32_t*)votes, (int64_t*)ii,
      (int64_t*)jj, (uint8_t*)valid, NC, P, rule, a, b);
  return (int)cudaGetLastError();
}
