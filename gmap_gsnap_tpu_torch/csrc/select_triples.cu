// Kernel K6: diagonal triples i -> m -> j for short-exon doublesplices.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _select_triples (:668)
// — the candidate set of find_doublesplices, stage1hr.c:7698-7742.  One
// CTA per read, NC <= 128 diagonals in shared memory:
//   * an edge a -> c is eligible when both diagonals are valid and the
//     uint32 difference d_c - d_a lies in [1, maxdist];
//   * thread m keeps the two best predecessors and the two best
//     successors of middle m by (votes desc, index asc), ineligible ones
//     counting -1 — lax.top_k(., 2) with its lower-index tie rule, which
//     matters because votes tie often and every ineligible entry is -1;
//   * the 4 combinations per middle give NC * 4 vote sums (-1 unless both
//     neighbours exist and m is valid); each entry e = m * 4 + a * 2 + c
//     gets the 32-bit key (0x7FFFFF - (vsum + 1)) << 9 | e and a bitonic
//     sort of the keys in shared memory orders them by vsum descending,
//     then e ascending: argsort(-vsum, stable=True), as K2 orders votes;
//   * the first T keys give (ti, tm, tj, valid = vsum >= 0).
//
// Bound: the NC^2 eligibility tests per read (16K at NC = 128) in shared
// memory, then the sort of <= 512 keys; device memory traffic is the
// read's NC diagonals and votes in, 4T values out.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxNC = 128;
constexpr int kMaxKeys = 4 * kMaxNC;
constexpr int kThreads = 128;

struct Top2 {
  int v0, i0, v1, i1;
  __device__ void push(int v, int i) {  // i ascending: ties keep the lower
    if (v > v0) { v1 = v0; i1 = i0; v0 = v; i0 = i; }
    else if (v > v1) { v1 = v; i1 = i; }
  }
};

__global__ void select_triples_kernel(const int64_t* __restrict__ top_d,
                                      const int32_t* __restrict__ votes,
                                      int64_t* __restrict__ ti_o,
                                      int64_t* __restrict__ tm_o,
                                      int64_t* __restrict__ tj_o,
                                      uint8_t* __restrict__ valid_o, int NC,
                                      int T, int n, uint32_t maxdist) {
  __shared__ uint32_t sd[kMaxNC];
  __shared__ bool sok[kMaxNC];
  __shared__ int sv[kMaxNC];
  __shared__ int s_i2[kMaxNC * 2], s_j2[kMaxNC * 2];
  __shared__ uint32_t keys[kMaxKeys];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int c = tid; c < NC; c += blockDim.x) {
    const int64_t d = top_d[row * NC + c];
    sok[c] = d != GSNAP_INVALID_DIAG;
    sd[c] = (uint32_t)d;
    sv[c] = votes[row * NC + c];
  }
  __syncthreads();

  for (int m = tid; m < NC; m += blockDim.x) {
    Top2 pre{INT_MIN, -1, INT_MIN, -1}, suc{INT_MIN, -1, INT_MIN, -1};
    for (int c = 0; c < NC; ++c) {
      const bool edge_cm = sok[c] && sok[m] &&
                           sd[m] - sd[c] >= 1u && sd[m] - sd[c] <= maxdist;
      pre.push(edge_cm ? sv[c] : -1, c);
      const bool edge_mc = sok[m] && sok[c] &&
                           sd[c] - sd[m] >= 1u && sd[c] - sd[m] <= maxdist;
      suc.push(edge_mc ? sv[c] : -1, c);
    }
    s_i2[2 * m] = pre.i0;
    s_i2[2 * m + 1] = pre.i1;
    s_j2[2 * m] = suc.i0;
    s_j2[2 * m + 1] = suc.i1;
    const int vp[2] = {pre.v0, pre.v1}, vs[2] = {suc.v0, suc.v1};
    for (int a = 0; a < 2; ++a)
      for (int c = 0; c < 2; ++c) {
        const bool ok = vp[a] >= 0 && vs[c] >= 0 && sok[m];
        const int vsum = ok ? sv[m] + vp[a] + vs[c] : -1;
        const uint32_t e = (uint32_t)(m * 4 + a * 2 + c);
        keys[e] = ((0x7FFFFFu - (uint32_t)(vsum + 1)) << 9) | e;
      }
  }
  for (int e = 4 * NC + tid; e < n; e += blockDim.x) keys[e] = 0xFFFFFFFFu;
  __syncthreads();

  for (int k = 2; k <= n; k <<= 1) {  // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint32_t x = keys[i], y = keys[ixj];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < T; t += blockDim.x) {
    const uint32_t key = keys[t];
    const int e = (int)(key & 0x1FFu);
    const int m = e >> 2;
    const int vsum = (int)(0x7FFFFFu - (key >> 9)) - 1;
    ti_o[row * T + t] = s_i2[2 * m + ((e >> 1) & 1)];
    tm_o[row * T + t] = m;
    tj_o[row * T + t] = s_j2[2 * m + (e & 1)];
    valid_o[row * T + t] = vsum >= 0;
  }
}

}  // namespace

extern "C" int gsnap_select_triples(const void* top_d, const void* votes,
                                    void* ti, void* tm, void* tj,
                                    void* valid, int B, int NC, int T,
                                    int64_t maxdist, void* stream) {
  if (NC < 2 || NC > kMaxNC || T < 1 || T > 4 * NC || maxdist < 0 ||
      maxdist > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int n = 1;
  while (n < 4 * NC) n <<= 1;
  select_triples_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)top_d, (const int32_t*)votes, (int64_t*)ti,
      (int64_t*)tm, (int64_t*)tj, (uint8_t*)valid, NC, T, n,
      (uint32_t)maxdist);
  return (int)cudaGetLastError();
}
