// Kernel K9: GMAP seeding and diagonal segment extraction.
//
// Replaces gmap_gsnap_tpu/align/gmap_engine.py seed_segments_device (:48).
// One CTA of 256 threads per query row (a query or its reverse
// complement), Q oligos:
//   1. the k-mers, a chunk of 1,024 at a time: each oligo's index run
//      [offsets[o], offsets[o+1]) read once (kept when the count is in
//      (0, threshold] and the k-mer has no N), its start and count into
//      shared memory, and one block scan of the counts gives every kept
//      oligo its first hit slot; nhits is the total, and slots past H are
//      dropped (the caller retries larger).  Queries of more than one
//      chunk count every chunk first and read each again to expand it;
//   2. the hits, a thread a slot: a slot's oligo by a binary search of the
//      chunk's first slots, its position read (a run of slots reads one
//      contiguous run of `positions`, coalesced), its key
//      diag << 32 | qpos,  diag = pos - qpos + Q in uint32.  Within one
//      diagonal the query positions of the hits are distinct, so sorting
//      these keys gives exactly the stable sort by diagonal of the
//      qpos-ascending slots that JAX does;
//   3. the nv = min(nhits, H) keys sorted: up to kRegHits (2,048) in
//      registers (row_sort.cuh: one warp to 128 keys, else eight, only the
//      stages across warps through shared memory); more in a global
//      scratch row by a block bitonic sort (the wrapper passes the scratch
//      only when H > kRegHits: kernels/limits.py seed_segments_register_hits);
//   4. a hit starts a segment when it is the first, or its diagonal
//      differs from the previous hit's (JAX compares the first hit with
//      its own diagonal ^ 1), or the query gap to the previous hit is
//      > 2k; the segment ends before the next start, kept or not (a
//      dropped short segment still bounds its neighbours), found for all
//      hits at once by one block suffix-minimum of each thread's first
//      start; a segment is kept when qpos_end + k - qpos_start >=
//      MIN_SEGLEN, and one block scan ranks the kept ones in hit order;
//   5. the first m = min(nsegs, S, H) kept segments sorted by the key
//      qstart << 48 | diag << 16 | rank  (qstart < 2^16, rank < 2^16),
//      which is JAX's order by (qstart, diag) with the segment's index
//      breaking no tie (a (qstart, diag) pair names one segment), as the
//      hits are;
//   6. slots past the kept segments carry JAX's padding values: qstart and
//      diag of sorted hit slot H-1 (the last kept oligo and 0xFFFFFFFF
//      when fewer than H hits), qend of hit slot nv-1 (+ k), valid 0.
// Shared memory (gmap_seed_smem_bytes, kernels/limits.py
// seed_segments_bytes) holds min(H, kRegHits) hit keys, min(pow2(min(S,
// H)), min(H, kRegHits)) segment keys and ends and a chunk's k-mers: it
// does not grow past H = kRegHits, so a CTA's footprint stays whatever H
// the caller's retries left.
//
// Bound: the dependent oligo -> offsets -> positions loads (random,
// latency-bound) and the sort of the hits; each row reads Q oligos, each
// kept k-mer's two offsets and its hits' positions once and writes 4 x
// min(S, H) segment values.
//
// GMAP_SEED_STAMP(i): the end of phase i of a row (0 its start, 1 the
// counts and their scan, 2 the hit expansion, 3 the sort, 4 the segments,
// 5 the segment sort, 6 the stores), defined by a probe build
// (tools/probe_seed_gotoh.py) and empty in the default one.
#include "row_sort.cuh"

#ifndef GMAP_SEED_STAMP
#define GMAP_SEED_STAMP(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;              // k-mers a chunk, 4 a thread
constexpr int kRegHits = kThreads * 8;    // hits sorted in registers
constexpr int kMinSeglen = 15;
// the kernel's static shared memory (its block reduction's red[32]): a
// CTA whose dynamic layout fills the 48 KB default (H >= kRegHits,
// min(S, H) > kRegHits / 2, Q >= kChunk) needs the opt-in for these
// bytes too
constexpr int kStaticSmem = 32 * sizeof(int);
constexpr uint64_t kPad = ~0ull;

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared-memory layout of a CTA (byte offsets of each array and the
// total), the same on the host and on the device.
struct SmemLayout {
  int nk, ns, cq;
  int seg_keys, seg_qend, kstart, kbase, bytes;
};

__host__ __device__ __forceinline__ SmemLayout smem_layout(int Q, int H,
                                                           int S) {
  SmemLayout l;
  const int Sout = S < H ? S : H;
  l.nk = H < kRegHits ? H : kRegHits;
  const int ps = pow2_at_least(Sout);
  l.ns = ps < l.nk ? ps : l.nk;
  l.cq = Q < kChunk ? Q : kChunk;
  l.seg_keys = 8 * l.nk;
  l.seg_qend = l.seg_keys + 8 * l.ns;
  l.kstart = l.seg_qend + 4 * l.ns;
  l.kbase = l.kstart + 4 * l.cq;
  l.bytes = (l.kbase + 4 * l.cq + 7) / 8 * 8;
  return l;
}

__device__ __forceinline__ int32_t qpos_of(uint64_t key) {
  return (int32_t)(uint32_t)key;
}

__device__ __forceinline__ uint32_t diag_of(uint64_t key) {
  return (uint32_t)(key >> 32);
}

// Ascending sort of a[0, nvalid) (padded with kPad to N = 32 KPL NW
// keys) in registers; a holds at least N keys when NW > 1 (the stages
// across warps exchange through it).  With NW == 1 warp 0 sorts alone.
// Every thread of the CTA calls it; it ends with a block barrier.
template <int KPL, int NW>
__device__ __forceinline__ void sort_in_registers(uint64_t* a, int nvalid) {
  if (NW > 1 || threadIdx.x < 32) {
    const int t = row_thread<NW>();
    uint64_t v[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int e = t * KPL + r;
      v[r] = e < nvalid ? a[e] : kPad;
    }
    // each thread writes back only the elements it read: no barrier
    // is needed between the loads and the first exchange
    row_sort<uint64_t, KPL, NW>(v, a);
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int e = t * KPL + r;
      if (e < nvalid) a[e] = v[r];
    }
  }
  __syncthreads();
}

// Ascending sort of a[0, nvalid) with a holding at least pow2(nvalid)
// keys: in registers to kRegHits keys, else a block bitonic sort in
// place (a then in global scratch).
__device__ void sort_keys(uint64_t* a, int nvalid) {
  const int n = pow2_at_least(nvalid > 0 ? nvalid : 1);
  if (n <= 32) {
    sort_in_registers<1, 1>(a, nvalid);
  } else if (n <= 64) {
    sort_in_registers<2, 1>(a, nvalid);
  } else if (n <= 128) {
    sort_in_registers<4, 1>(a, nvalid);
  } else if (n <= 256) {
    sort_in_registers<1, kWarps>(a, nvalid);
  } else if (n <= 512) {
    sort_in_registers<2, kWarps>(a, nvalid);
  } else if (n <= 1024) {
    sort_in_registers<4, kWarps>(a, nvalid);
  } else if (n <= kRegHits) {
    sort_in_registers<8, kWarps>(a, nvalid);
  } else {
    for (int i = nvalid + (int)threadIdx.x; i < n; i += kThreads) a[i] = kPad;
    __syncthreads();
    gmap_bitonic_sort(a, n);
  }
}

// Reads the k-mers [c0, c0 + n) of a row (n <= kChunk): each one's index
// start into kstart and its first hit slot within the chunk into kbase
// (an exclusive scan of the kept counts); returns the chunk's count
// (wrapping uint32 arithmetic, as JAX's int32 cumsum) and raises *lastq
// to the last kept k-mer.  Ends with a block barrier.
__device__ __forceinline__ uint32_t read_chunk(
    const int32_t* __restrict__ oligos, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ offsets, int c0, int n, int64_t noffsets,
    int threshold, int32_t* kstart, int32_t* kbase, int32_t* lastq) {
  const int tid = threadIdx.x;
  int32_t start[kChunk / kThreads], cnt[kChunk / kThreads];
#pragma unroll
  for (int r = 0; r < kChunk / kThreads; ++r) {
    const int q = tid + r * kThreads;
    start[r] = 0;
    cnt[r] = 0;
    if (q < n) {
      int64_t o = oligos[c0 + q];
      o = o < 0 ? 0 : (o > noffsets - 2 ? noffsets - 2 : o);
      const int32_t s = __ldg(offsets + o);
      const int32_t c = (int32_t)((uint32_t)__ldg(offsets + o + 1) -
                                  (uint32_t)s);
      const bool keep = valid[c0 + q] && c > 0 && c <= threshold;
      start[r] = s;
      cnt[r] = keep ? c : 0;
      if (keep) *lastq = c0 + q;
    }
  }
#pragma unroll
  for (int r = 0; r < kChunk / kThreads; ++r) {
    const int q = tid + r * kThreads;
    if (q < n) {
      kstart[q] = start[r];
      kbase[q] = cnt[r];
    }
  }
  __syncthreads();
  // thread t scans k-mers 4t .. 4t + 3 of the chunk
  uint32_t c4[4], mine = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = 4 * tid + r;
    c4[r] = q < n ? (uint32_t)kbase[q] : 0u;
    mine += c4[r];
  }
  int32_t total;
  uint32_t run = (uint32_t)gmap_block_exclusive_sum((int32_t)mine, &total);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = 4 * tid + r;
    if (q < n) kbase[q] = (int32_t)run;
    run += c4[r];
  }
  __syncthreads();
  return (uint32_t)total;
}

// Writes the keys of hit slots [lo, hi) (slot s of the chunk at c0 is
// local slot s - run0 of its first-slot table), a thread a slot, eight
// position reads in flight a thread.
__device__ __forceinline__ void expand_chunk(
    const uint32_t* __restrict__ positions, const int32_t* kstart,
    const int32_t* kbase, int c0, int n, uint32_t run0, int lo, int hi,
    int Q, int64_t npositions, uint64_t* keys) {
  constexpr int kBatch = 8;
  for (int s0 = lo; s0 < hi; s0 += kBatch * kThreads) {
    uint32_t pos[kBatch];
    int32_t qq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kThreads + (int)threadIdx.x;
      qq[u] = 0;
      pos[u] = 0;
      if (s < hi) {
        const int32_t local = (int32_t)((uint32_t)s - run0);
        // the last k-mer whose first slot is <= local owns it
        int a = 0, b = n - 1;
        while (a < b) {
          const int mid = (a + b + 1) >> 1;
          if (kbase[mid] <= local)
            a = mid;
          else
            b = mid - 1;
        }
        int64_t p = (int64_t)kstart[a] + (local - kbase[a]);
        p = p < 0 ? 0 : (p > npositions - 1 ? npositions - 1 : p);
        qq[u] = c0 + a;
        pos[u] = __ldg(positions + p);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kThreads + (int)threadIdx.x;
      if (s < hi) {
        const uint32_t diag = pos[u] - (uint32_t)qq[u] + (uint32_t)Q;
        keys[s] = ((uint64_t)diag << 32) | (uint32_t)qq[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) seed_segments_kernel(
    const int32_t* __restrict__ offsets, const uint32_t* __restrict__ positions,
    const int32_t* __restrict__ oligos_all, const uint8_t* __restrict__ valid_all,
    uint8_t* __restrict__ scratch, int32_t* __restrict__ qstart_out,
    int32_t* __restrict__ qend_out, int64_t* __restrict__ diag_out,
    uint8_t* __restrict__ valid_out, int32_t* __restrict__ nhits_out,
    int32_t* __restrict__ nsegs_out, int Q, int k, int H, int S, int threshold,
    int64_t noffsets, int64_t npositions, int ws) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red[32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int Sout = S < H ? S : H;
  const SmemLayout L = smem_layout(Q, H, S);
  int32_t* kstart = (int32_t*)(smem + L.kstart);
  int32_t* kbase = (int32_t*)(smem + L.kbase);
  const int32_t* oligos = oligos_all + (int64_t)row * Q;
  const uint8_t* valid = valid_all + (int64_t)row * Q;
  GMAP_SEED_STAMP(0);

  // 1. counts (a query of one chunk keeps its chunk's table for 2.)
  const int nchunks = (Q + kChunk - 1) / kChunk;
  int32_t lastq = -1;
  uint32_t total = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * kChunk;
    total += read_chunk(oligos, valid, offsets, c0, min(kChunk, Q - c0),
                        noffsets, threshold, kstart, kbase, &lastq);
  }
  const int32_t nhits = (int32_t)total;
  const int32_t lq = (int32_t)gmap_block_max(lastq);
  const int nv = nhits < 0 ? 0 : (nhits < H ? nhits : H);
  const bool in_regs = nv <= kRegHits;
  uint64_t* keys = in_regs ? (uint64_t*)smem
                           : (uint64_t*)(scratch + (int64_t)row * ws);
  uint64_t* seg_keys = in_regs ? (uint64_t*)(smem + L.seg_keys) : keys + H;
  int32_t* seg_qend =
      in_regs ? (int32_t*)(smem + L.seg_qend)
              : (int32_t*)(seg_keys + pow2_at_least(Sout));
  GMAP_SEED_STAMP(1);

  // 2. hit keys into slots [0, nv)
  uint32_t run = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * kChunk, n = min(kChunk, Q - c0);
    const uint32_t ct =
        nchunks == 1 ? total
                     : read_chunk(oligos, valid, offsets, c0, n, noffsets,
                                  threshold, kstart, kbase, &lastq);
    const int64_t hi64 = (int64_t)run + ct;
    const int hi = (int)(hi64 < nv ? hi64 : nv);
    if ((int64_t)run < nv)
      expand_chunk(positions, kstart, kbase, c0, n, run, (int)run, hi, Q,
                   npositions, keys);
    run += ct;
    if (nchunks > 1) __syncthreads();  // the next chunk's table
  }
  __syncthreads();
  GMAP_SEED_STAMP(2);

  // 3. sort by (diag, qpos)
  sort_keys(keys, nv);
  GMAP_SEED_STAMP(3);

  // 4. segments: thread t's hits [h0, h1); a start's segment ends before
  // the next start (the first start of a later thread when none of its
  // own follows)
  const int hchunk = (nv + kThreads - 1) / kThreads;
  const int h0 = min(nv, tid * hchunk), h1 = min(nv, h0 + hchunk);
  auto newseg = [&](int i) {
    if (i == 0) return true;
    const uint64_t a = keys[i - 1], b = keys[i];
    return diag_of(a) != diag_of(b) || qpos_of(b) - qpos_of(a) > 2 * k;
  };
  int first = nv;
  for (int i = h0; i < h1; ++i)
    if (newseg(i)) {
      first = i;
      break;
    }
  const int later = row_later_min<kWarps>(first, nv, red);
  int nkept = 0;
  {
    int next = later;
    for (int i = h1 - 1; i >= h0; --i) {
      if (!newseg(i)) continue;
      nkept += qpos_of(keys[next - 1]) + k - qpos_of(keys[i]) >= kMinSeglen;
      next = i;
    }
  }
  int32_t nsegs;
  const int32_t rank0 = gmap_block_exclusive_sum(nkept, &nsegs);
  {
    int next = later, rank = rank0 + nkept;
    for (int i = h1 - 1; i >= h0; --i) {
      if (!newseg(i)) continue;
      const int32_t qe = qpos_of(keys[next - 1]) + k;
      next = i;
      if (qe - qpos_of(keys[i]) < kMinSeglen) continue;
      if (--rank >= Sout) continue;
      seg_keys[rank] = ((uint64_t)(uint32_t)qpos_of(keys[i]) << 48) |
                       ((uint64_t)diag_of(keys[i]) << 16) | (uint32_t)rank;
      seg_qend[rank] = qe;
    }
  }
  // JAX's padding: hit slot H-1 of its sorted [H] arrays, qend at nv-1
  const bool full = nv == H;
  const int32_t pad_qs = full ? qpos_of(keys[H - 1]) : (lq < 0 ? 0 : lq);
  const int64_t pad_dg = full ? (int64_t)diag_of(keys[H - 1]) : 0xFFFFFFFFll;
  const int32_t pad_qe = (nv > 0 ? qpos_of(keys[nv - 1]) : 0) + k;
  __syncthreads();
  GMAP_SEED_STAMP(4);

  // 5. the first m kept segments by (qstart, diag)
  const int m = nsegs < Sout ? nsegs : Sout;
  sort_keys(seg_keys, m);
  GMAP_SEED_STAMP(5);

  // 6. stores
  const int64_t o = (int64_t)row * Sout;
  for (int j = tid; j < Sout; j += kThreads) {
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
  GMAP_SEED_STAMP(6);
}

}  // namespace

// The hits a row sorts in registers; rows with more (possible only when
// H > this) work in the global scratch row.
extern "C" int gmap_seed_register_hits() { return kRegHits; }

// Dynamic shared memory of a K9 CTA.
extern "C" int gmap_seed_smem_bytes(int Q, int H, int S) {
  return smem_layout(Q, H, S).bytes;
}

// scratch: B rows of ws bytes (ws >= 8 H + 12 pow2(min(S, H))), needed
// when H > gmap_seed_register_hits(), else may be null.
extern "C" int gmap_seed_segments(
    const void* offsets, const void* positions, const void* oligos,
    const void* valid, void* scratch, void* qstart, void* qend, void* diag,
    void* seg_valid, void* nhits, void* nsegs, int B, int Q, int k, int H,
    int S, int threshold, int64_t noffsets, int64_t npositions, int ws,
    void* stream) {
  const int Sout = S < H ? S : H;
  if (Q < 1 || Q > 65536 || H < 1 || (H & (H - 1)) || Sout < 1 ||
      Sout > 65536 || noffsets < 2 || npositions < 1)
    return (int)cudaErrorInvalidValue;
  if (H > kRegHits &&
      (scratch == nullptr ||
       (int64_t)ws < 8ll * H + 12ll * pow2_at_least(Sout)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = smem_layout(Q, H, S).bytes;
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  seed_segments_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)offsets, (const uint32_t*)positions,
      (const int32_t*)oligos, (const uint8_t*)valid, (uint8_t*)scratch,
      (int32_t*)qstart, (int32_t*)qend, (int64_t*)diag, (uint8_t*)seg_valid,
      (int32_t*)nhits, (int32_t*)nsegs, Q, k, H, S, threshold, noffsets,
      npositions, ws);
  return (int)cudaGetLastError();
}

// CTAs of K9 an SM holds at the launch gmap_seed_segments makes for these
// sizes (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int gmap_seed_segments_occupancy(int Q, int H, int S) {
  const int smem = smem_layout(Q, H, S).bytes;
  if (smem + kStaticSmem > 48 * 1024 &&
      cudaFuncSetAttribute(seed_segments_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, seed_segments_kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}
