// Kernel K1: seed diagonals on the compact seed grid.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _extract_oligos (:178),
// _seed_rank_map (:203) and _seed_diagonals (:289).  One CTA per read:
//   1. each thread packs the k-mers at its query positions (MSB-first),
//      checks them (no N, inside the read) and reads the k-mer's start
//      and end in the offsets table; usable = count in (0, threshold];
//   2. warp 0 scans the usable counts (inclusive, in shared memory):
//      oligo o owns slots [cum[o-1], cum[o]) of the read's W slots;
//   3. each thread takes slots t: the owner is the first o with
//      cum[o] > t (binary search), the slot's genome position is
//      positions[start[o] + t - cum[o-1]], and diag = position - o.
// Slots past the read's total stay INVALID and carry the last usable
// oligo as qpos, exactly as the JAX scatter + running max leaves them.
// Per-phase counts of in-threshold k-mers (shared atomics) give the
// pigeonhole inputs nphase_min and nph_half.
//
// Bound: two dependent global reads per k-mer into the 4^k+1 offsets
// table (random, so latency- and DRAM-transaction-bound), then one
// read of positions per slot (runs of consecutive addresses, so
// coalesced).  Keeping the scan and slot owners in shared memory means
// no intermediate [B, S] or [B, W] array touches device memory: 8 bytes
// of dynamic shared memory a k-mer (its start and its running count),
// opted in above 48 KB, so that a read may hold as many k-mers as fit a
// CTA (29,000 or so).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxQ = 32;     // sampling interval
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory
// static shared memory of the kernel: the phase counts, totals and olast
constexpr int kStaticSmem = (3 * kMaxQ + 3 + 1) * 4;

__global__ void __launch_bounds__(kThreads) seed_diagonals_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ nflags,
    const int32_t* __restrict__ lengths, const uint32_t* __restrict__ offsets,
    const uint32_t* __restrict__ positions, int64_t* __restrict__ diag,
    int32_t* __restrict__ qpos, uint8_t* __restrict__ trunc,
    int32_t* __restrict__ nphase_min, int32_t* __restrict__ nph_half, int L,
    int k, int q, int size_threshold, int W, int half, int64_t noffsets,
    int64_t npositions) {
  extern __shared__ __align__(16) uint32_t s_start[];  // [S], then s_cum
  __shared__ int32_t s_phase[3][kMaxQ];  // whole read, left half, right half
  __shared__ int32_t s_total[3];
  __shared__ int32_t s_olast;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = L - k + 1;
  int32_t* s_cum = (int32_t*)(s_start + S);
  const int len = lengths[row];
  const int half_len = len / 2;
  const uint8_t* c = codes + (int64_t)row * L;
  const uint8_t* nf = nflags + (int64_t)row * L;

  for (int i = tid; i < 3 * kMaxQ; i += blockDim.x) (&s_phase[0][0])[i] = 0;
  if (tid < 3) s_total[tid] = 0;
  if (tid == 0) s_olast = -1;
  __syncthreads();

  for (int o = tid; o < S; o += blockDim.x) {
    uint32_t oligo = 0;
    int bad = 0;
    for (int i = 0; i < k; ++i) {
      oligo = (oligo << 2) | c[o + i];
      bad |= nf[o + i];
    }
    const bool valid = !bad && o + k <= len;
    int count = 0;
    uint32_t start = 0;
    if (valid) {
      start = offsets[oligo];
      const int64_t nxt = (int64_t)oligo + 1 < noffsets ? oligo + 1 : noffsets - 1;
      count = (int)(offsets[nxt] - start);
    }
    const bool usable = valid && count > 0 && count <= size_threshold;
    s_start[o] = start;
    s_cum[o] = usable ? count : 0;
    if (usable) atomicMax(&s_olast, o);
    if (valid && count <= size_threshold) {
      atomicAdd(&s_phase[0][o % q], 1);
      atomicAdd(&s_total[0], 1);
      if (half && o + k <= half_len) {
        atomicAdd(&s_phase[1][o % q], 1);
        atomicAdd(&s_total[1], 1);
      }
      if (half && o >= half_len) {
        atomicAdd(&s_phase[2][o % q], 1);
        atomicAdd(&s_total[2], 1);
      }
    }
  }
  __syncthreads();

  if (tid < 32) {  // inclusive scan of the usable counts, 32 at a time
    int carry = 0;
    for (int base = 0; base < S; base += 32) {
      const int o = base + tid;
      int v = o < S ? s_cum[o] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(GSNAP_FULL_MASK, v, d);
        if (tid >= d) v += n;
      }
      if (o < S) s_cum[o] = v + carry;
      carry += __shfl_sync(GSNAP_FULL_MASK, v, 31);
    }
  }
  __syncthreads();

  const int total = s_cum[S - 1];
  const int nfilled = total < W ? total : W;
  const int olast = s_olast < 0 ? 0 : s_olast;
  int64_t* drow = diag + (int64_t)row * W;
  int32_t* qrow = qpos + (int64_t)row * W;
  for (int t = tid; t < W; t += blockDim.x) {
    int64_t d = GSNAP_INVALID_DIAG;
    int qp = olast;
    if (t < nfilled) {
      int lo = 0, hi = S - 1;  // first o with cum[o] > t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_cum[mid] > t) hi = mid; else lo = mid + 1;
      }
      const int first_slot = lo > 0 ? s_cum[lo - 1] : 0;
      int64_t g = (int64_t)s_start[lo] + (t - first_slot);
      g = g < 0 ? 0 : (g > npositions - 1 ? npositions - 1 : g);
      const uint32_t p = positions[g];
      qp = lo;
      if (p >= (uint32_t)lo) d = (int64_t)(p - (uint32_t)lo);
    }
    drow[t] = d;
    qrow[t] = qp;
  }

  if (tid == 0) {
    int m[3];
    for (int h = 0; h < 3; ++h) {
      m[h] = s_total[h];
      for (int p = 0; p < q; ++p) m[h] = min(m[h], s_phase[h][p]);
    }
    trunc[row] = total > W;
    nphase_min[row] = m[0];
    nph_half[row] = half ? min(m[1], m[2]) : 0;
  }
}

}  // namespace

extern "C" int gsnap_seed_diagonals(
    const void* codes, const void* nflags, const void* lengths,
    const void* offsets, const void* positions, void* diag, void* qpos,
    void* trunc, void* nphase_min, void* nph_half, int B, int L, int k, int q,
    int size_threshold, int W, int half, int64_t noffsets, int64_t npositions,
    void* stream) {
  const int S = L - k + 1;
  const size_t smem = (size_t)8 * (S < 1 ? 0 : S);
  if (S < 1 || smem + kStaticSmem > (size_t)kSmemMax || q < 1 || q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_diagonals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seed_diagonals_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)nflags, (const int32_t*)lengths,
      (const uint32_t*)offsets, (const uint32_t*)positions, (int64_t*)diag,
      (int32_t*)qpos, (uint8_t*)trunc, (int32_t*)nphase_min,
      (int32_t*)nph_half, L, k, q, size_threshold, W, half, noffsets,
      npositions);
  return (int)cudaGetLastError();
}

extern "C" const char* gsnap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
