// Kernel K9: GMAP seeding and diagonal segment extraction.
//
// Replaces gmap_gsnap_tpu/align/gmap_engine.py seed_segments_device (:48).
// One CTA per query row (a query or its reverse complement), Q oligos:
//   1. each thread takes a contiguous run of query positions, reads each
//      oligo's index run [offsets[o], offsets[o+1]) (kept when the count
//      is in (0, threshold] and the k-mer has no N), and a block scan of
//      the counts gives every kept oligo its first hit slot; nhits is the
//      total, and slots past H are dropped (the caller retries larger);
//   2. each kept oligo writes its hits into slots [base, base+cnt) < H
//      as 64-bit keys  diag << 32 | qpos,  diag = pos - qpos + Q in
//      uint32.  Within one diagonal the query positions of the hits are
//      distinct, so sorting these keys gives exactly the stable sort by
//      diagonal of the qpos-ascending slots that JAX does;
//   3. one bitonic sort of the nv = min(nhits, H) keys (padded with ~0 to
//      a power of two);
//   4. a hit starts a segment when it is the first, or its diagonal
//      differs from the previous hit's (JAX compares the first hit with
//      its own diagonal ^ 1), or the query gap to the previous hit is
//      > 2k; the segment ends before the next start, kept or not (a
//      dropped short segment still bounds its neighbours); a segment is
//      kept when qpos_end + k - qpos_start >= MIN_SEGLEN;
//   5. a block scan ranks the kept segments in hit order; the first
//      min(S, H) of them are sorted by the key  qstart << 48 | diag << 16
//      | rank  (qstart < 2^16, rank < 2^16), which is JAX's order by
//      (qstart, diag) with the segment's index breaking no tie (a
//      (qstart, diag) pair names one segment).  Slots past the kept
//      segments carry JAX's padding values: qstart and diag of sorted hit
//      slot H-1 (the last kept oligo and 0xFFFFFFFF when fewer than H
//      hits), qend of hit slot nv-1 (+ k), valid 0.
// The sort keys live in dynamic shared memory, or in a global scratch row
// when 8 H + 12 pow2(min(S, H)) bytes do not fit (H reaches 16,384 for
// 100 bp reads after the retries, 32,768 for 150 bp reads).
//
// Bound: the dependent offsets/positions loads (random, latency-bound)
// and the shared-memory bitonic sort of the hits (O(n log^2 n) compare-
// exchanges); each row reads Q oligos and its hits' positions once and
// writes 4 x min(S, H) segment values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinSeglen = 15;
constexpr uint64_t kPad = ~0ull;

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

struct Oligo {
  int32_t start;
  int32_t cnt;  // 0 when not kept
};

__device__ __forceinline__ Oligo read_oligo(const int32_t* oligos,
                                            const uint8_t* valid,
                                            const int32_t* offsets, int q,
                                            int64_t noffsets, int threshold) {
  int64_t o = oligos[q];
  o = o < 0 ? 0 : (o > noffsets - 2 ? noffsets - 2 : o);
  const int32_t s = offsets[o];
  const int32_t cnt = (int32_t)((uint32_t)offsets[o + 1] - (uint32_t)s);
  const bool keep = valid[q] && cnt > 0 && cnt <= threshold;
  return {s, keep ? cnt : 0};
}

__global__ void __launch_bounds__(kThreads) seed_segments_kernel(
    const int32_t* __restrict__ offsets, const uint32_t* __restrict__ positions,
    const int32_t* __restrict__ oligos_all, const uint8_t* __restrict__ valid_all,
    uint8_t* __restrict__ scratch, int32_t* __restrict__ qstart_out,
    int32_t* __restrict__ qend_out, int64_t* __restrict__ diag_out,
    uint8_t* __restrict__ valid_out, int32_t* __restrict__ nhits_out,
    int32_t* __restrict__ nsegs_out, int Q, int k, int H, int S, int threshold,
    int64_t noffsets, int64_t npositions, int ws, int use_smem) {
  extern __shared__ uint64_t smem[];
  __shared__ int32_t s_lastq;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int Sout = S < H ? S : H;
  const int ns = pow2_at_least(Sout);
  uint64_t* keys = use_smem ? smem : (uint64_t*)(scratch + (int64_t)row * ws);
  uint64_t* seg_keys = keys + H;
  int32_t* seg_qend = (int32_t*)(seg_keys + ns);
  const int32_t* oligos = oligos_all + (int64_t)row * Q;
  const uint8_t* valid = valid_all + (int64_t)row * Q;

  // 1. counts of this thread's run of query positions, block scan
  const int qchunk = (Q + blockDim.x - 1) / blockDim.x;
  const int q0 = tid * qchunk, q1 = min(Q, q0 + qchunk);
  int32_t mine = 0, lastq = -1;
  for (int q = q0; q < q1; ++q) {
    const Oligo ol = read_oligo(oligos, valid, offsets, q, noffsets, threshold);
    mine = (int32_t)((uint32_t)mine + (uint32_t)ol.cnt);
    if (ol.cnt) lastq = q;
  }
  int32_t nhits;
  int32_t base = gmap_block_exclusive_sum(mine, &nhits);
  const int64_t lq = gmap_block_max(lastq);
  if (tid == 0) s_lastq = (int32_t)(lq < 0 ? 0 : lq);
  const int nv = nhits < 0 ? H : (nhits < H ? nhits : H);

  // 2. hit keys into slots [0, nv)
  for (int q = q0; q < q1; ++q) {
    const Oligo ol = read_oligo(oligos, valid, offsets, q, noffsets, threshold);
    for (int j = 0; j < ol.cnt && base + j < H; ++j) {
      int64_t p = (int32_t)((uint32_t)ol.start + (uint32_t)j);
      p = p < 0 ? 0 : (p > npositions - 1 ? npositions - 1 : p);
      const uint32_t diag = positions[p] - (uint32_t)q + (uint32_t)Q;
      keys[base + j] = ((uint64_t)diag << 32) | (uint32_t)q;
    }
    base = (int32_t)((uint32_t)base + (uint32_t)ol.cnt);
  }
  const int n = pow2_at_least(nv > 0 ? nv : 1);
  for (int i = nv + tid; i < n; i += blockDim.x) keys[i] = kPad;
  __syncthreads();

  // 3. sort by (diag, qpos)
  gmap_bitonic_sort(keys, n);

  // 4-5. segment starts, their ends, kept ones ranked in hit order
  auto qpos_of = [&](int i) { return (int32_t)(uint32_t)keys[i]; };
  auto newseg = [&](int i) {
    return i == 0 || (keys[i] >> 32) != (keys[i - 1] >> 32) ||
           qpos_of(i) - qpos_of(i - 1) > 2 * k;
  };
  auto seg_end = [&](int i) {  // last hit of the segment starting at i
    int j = i + 1;
    while (j < nv && !newseg(j)) ++j;
    return j - 1;
  };
  auto kept = [&](int i) {
    return newseg(i) && qpos_of(seg_end(i)) + k - qpos_of(i) >= kMinSeglen;
  };
  const int hchunk = (nv + blockDim.x - 1) / blockDim.x;
  const int h0 = tid * hchunk, h1 = min(nv, h0 + hchunk);
  int32_t nkept = 0;
  for (int i = h0; i < h1; ++i) nkept += kept(i);
  int32_t nsegs;
  int32_t rank = gmap_block_exclusive_sum(nkept, &nsegs);
  for (int i = h0; i < h1 && rank < Sout; ++i) {
    if (!kept(i)) continue;
    const uint32_t diag = (uint32_t)(keys[i] >> 32);
    seg_keys[rank] = ((uint64_t)(uint32_t)qpos_of(i) << 48) |
                     ((uint64_t)diag << 16) | (uint32_t)rank;
    seg_qend[rank] = qpos_of(seg_end(i)) + k;
    ++rank;
  }
  const int m = nsegs < Sout ? nsegs : Sout;
  const int n2 = pow2_at_least(m > 0 ? m : 1);
  for (int i = m + tid; i < n2; i += blockDim.x) seg_keys[i] = kPad;
  __syncthreads();
  gmap_bitonic_sort(seg_keys, n2);

  // JAX's padding: hit slot H-1 of its sorted [H] arrays, qend at nv-1
  const bool full = nv == H;
  const int32_t pad_qs = full ? qpos_of(H - 1) : s_lastq;
  const int64_t pad_dg = full ? (int64_t)(keys[H - 1] >> 32) : 0xFFFFFFFFll;
  const int32_t pad_qe = (nv > 0 ? qpos_of(nv - 1) : 0) + k;
  const int64_t o = (int64_t)row * Sout;
  for (int j = tid; j < Sout; j += blockDim.x) {
    if (j < m) {
      const uint64_t key = seg_keys[j];
      qstart_out[o + j] = (int32_t)(key >> 48);
      diag_out[o + j] = (int64_t)((key >> 16) & 0xFFFFFFFFull);
      qend_out[o + j] = seg_qend[key & 0xFFFF];
      valid_out[o + j] = 1;
    } else {
      qstart_out[o + j] = pad_qs;
      diag_out[o + j] = pad_dg;
      qend_out[o + j] = pad_qe;
      valid_out[o + j] = 0;
    }
  }
  if (tid == 0) {
    nhits_out[row] = nhits;
    nsegs_out[row] = nsegs;
  }
}

}  // namespace

extern "C" int gmap_seed_segments(
    const void* offsets, const void* positions, const void* oligos,
    const void* valid, void* scratch, void* qstart, void* qend, void* diag,
    void* seg_valid, void* nhits, void* nsegs, int B, int Q, int k, int H,
    int S, int threshold, int64_t noffsets, int64_t npositions, int ws,
    int use_smem, void* stream) {
  const int Sout = S < H ? S : H;
  if (Q < 1 || Q > 65536 || H < 1 || (H & (H - 1)) || Sout > 65536 ||
      noffsets < 2 || npositions < 1)
    return (int)cudaErrorInvalidValue;
  if (!use_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = use_smem ? (size_t)ws : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seed_segments_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)offsets, (const uint32_t*)positions,
      (const int32_t*)oligos, (const uint8_t*)valid, (uint8_t*)scratch,
      (int32_t*)qstart, (int32_t*)qend, (int64_t*)diag, (uint8_t*)seg_valid,
      (int32_t*)nhits, (int32_t*)nsegs, Q, k, H, S, threshold, noffsets,
      npositions, ws, use_smem);
  return (int)cudaGetLastError();
}
