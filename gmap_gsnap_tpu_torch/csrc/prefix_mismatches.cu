// Kernel K3: mismatch matrices and their prefix sums per placement.
//
// Replaces gmap_gsnap_tpu/ops/genome.py fetch_span_words (:112, with
// _rows_window :91) and gmap_gsnap_tpu/ops/mismatch.py mismatch_words
// (:122) / mismatch_matrix (:186), as gsnap_gapped._prefix_mm (:89) and
// gsnap_se._verify (:400) use them.  For each (read, diagonal) placement
// it writes mm bool[L] (a mismatch at each query position) and pref
// int32[L + 1] (the mismatches below each position):
//   * the genome code and N-flag words around each 16-base query word
//     are shifted into place, the optional cmet/atoi conversion applied
//     to genome and query alike, XORed against the packed query, and the
//     N rules applied (mismatch.py:157-158); with an alt (SNP) genome a
//     position must mismatch both genomes;
//   * positions past the read's length are cleared; an unplaceable
//     diagonal (INVALID, or running past the genome end) is a mismatch
//     at every position inside the read.
//
// Bound: bytes, and nearly all of them the stores: L bytes of mm and
// 4 (L + 1) of pref a placement (504 B at L = 100) against ~70 B of
// genome words, query words and diagonal read.  The design this one
// replaces (a warp a placement) kept 25 of its 32 lanes idle through the
// fetch at L = 100, scanned 7 word counts with 5 shuffle rounds and
// wrote a placement in ~8 narrow stores (1-byte mm, 4-byte pref, rows
// not 16-byte aligned): 0.0695 ms against a bound of 0.0225 at 4096 x 32
// placements on the H100 (700 W).
//
// Design: a CTA owns a tile of kTile consecutive placements (a multiple
// of 16), whose mm span (kTile L bytes) and pref span (kTile (L + 1)
// ints) are contiguous and start on 16-byte boundaries.
//   0. A thread per row: its read, start (or unplaceable) and in-read
//      length into shared memory.
//   1. A thread per (row, 16-base query word), over the whole tile and
//      looping, so any read length is taken: the mismatch word, its even
//      bits compacted to 16, into the tile's rows of bits in shared
//      memory (a row: its query words paired into 32-bit words, and one
//      word past them, 0).
//   2. A thread per row: the mismatches below each of its words.
//   3. Every thread writes 16 consecutive bytes of the tile's flat mm
//      span (16 bits funnel-shifted out of one or two rows, spread to
//      bytes by a multiply) and 4 consecutive ints of its flat pref span
//      (pref[s] = below[s >> 5] + popc(word & bits below s)), each with
//      one 16-byte store; only the last, partial tile ends in scalar
//      stores.
// 0.0352 ms at 4096 x 32 placements (64% of the bound; 0.1094-0.1108 at
// 4096 x 128, 81-82%) on the H100 (700 W), by tools/time_kernels.py.
// Other tiles (32 to 128 placements, 128 to 512 threads) and fast paths
// for chunks inside one row and one word (fewer instructions) timed no
// faster in exploratory builds.  The query words are read as the int64
// the port carries them in: converting them to int32 first added ~0.011
// ms of small torch ops to a call.
// Shared memory: 8 bytes a row word, kTile rows: 2.5 KB at L = 100,
// 16.5 KB at L = 1024 (above 48 KB, from L ~ 3000 on, it is opted in).
#include "common.cuh"

namespace {

constexpr uint32_t kLaneLo = 0x55555555u;
constexpr int kTile = 64;       // placements a CTA: a multiple of 16
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory

__device__ __forceinline__ uint32_t convert_word(uint32_t w, int conv) {
  const uint32_t lo = w & kLaneLo, hi = (w >> 1) & kLaneLo;
  switch (conv) {
    case 1: return w | ((lo & ~hi) << 1);            // ct: C -> T
    case 2: return w & ~((hi & ~lo) << 1);           // ga: G -> A
    case 3: return w | ((~hi & ~lo & kLaneLo) << 1); // ag: A -> G
    case 4: return w & ~((hi & lo) << 1);            // tc: T -> C
    default: return w;
  }
}

// 16 flag bits -> 2-bit lanes (bit i -> bits 2i, 2i+1)
__device__ __forceinline__ uint32_t expand2(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x | (x << 1);
}

// the even bits of x, packed: bit 2i -> bit i
__device__ __forceinline__ uint32_t compact_even(uint32_t x) {
  x &= kLaneLo;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// bits 0 .. n - 1 (n clamped to [0, 32])
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << n) - 1u;
}

// 4 bits -> 4 bytes of 0 / 1 (bit i -> byte i)
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t mismatch_word(
    const uint32_t* __restrict__ ref, const uint32_t* __restrict__ flag,
    int64_t nwords, int64_t left, int j, uint32_t q, uint32_t qn, int conv,
    int qunk, int gunk) {
  const int64_t w0 = (left >> 4) + j;
  const int sh = (int)(left & 15);
  const int64_t i0 = w0 < nwords ? w0 : nwords - 1;
  const int64_t i1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
  const uint32_t c0 = ref[i0], c1 = ref[i1], f0 = flag[i0], f1 = flag[i1];
  uint32_t c = sh ? (c0 >> (2 * sh)) | (c1 << (32 - 2 * sh)) : c0;
  const uint32_t f = (sh ? (f0 >> sh) | (f1 << (16 - sh)) : f0) & 0xFFFFu;
  c = convert_word(c, conv);
  const uint32_t diff = c ^ q;
  const uint32_t neq = (diff | (diff >> 1)) & kLaneLo;
  const uint32_t gn = expand2(f) & kLaneLo;
  const uint32_t m = gunk ? (neq | gn) : (neq & ~gn);
  return qunk ? (m | qn) : (m & ~qn);
}

// 32-bit words of a row of bits: NW 16-bit query words paired, and one
// past them (0), so that every position s <= L lies in a word with a
// word after it
__host__ __device__ inline int row_words(int NW) { return (NW + 1) / 2 + 1; }

__global__ void __launch_bounds__(kThreads) prefix_mismatches_kernel(
    const uint32_t* __restrict__ ref, const uint32_t* __restrict__ flag,
    const uint32_t* __restrict__ alt_ref, const uint32_t* __restrict__ alt_flag,
    const int64_t* __restrict__ qcodes, const int64_t* __restrict__ qnflags,
    const int64_t* __restrict__ diags, const int32_t* __restrict__ lengths,
    uint8_t* __restrict__ mm, int32_t* __restrict__ pref, int64_t nwords,
    int64_t glen, int64_t total, int NC, int L, int NW, int conv, int qunk,
    int gunk) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int64_t s_left[kTile];  // a row's start, -1 where unplaceable
  __shared__ int32_t s_read[kTile];  // its read
  __shared__ int32_t s_lim[kTile];   // its in-read positions, min(len, L)
  const int wpr = row_words(NW);
  uint32_t* words = smem;                               // [kTile][wpr]
  int32_t* below = (int32_t*)(smem + kTile * wpr);      // [kTile][wpr]
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int nt = (int)(total - p0 < kTile ? total - p0 : kTile);

  // 0. each row's placement (rows past nt: no position in the read)
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    int64_t left = -1;
    int b = 0, lim = 0;
    if (r < nt) {
      b = (int)((p0 + r) / NC);
      const int64_t d = diags[p0 + r];
      const int len = lengths[b];
      lim = min(len, L);
      if (d != GSNAP_INVALID_DIAG && d + len <= glen) left = d;
    }
    s_left[r] = left;
    s_read[r] = b;
    s_lim[r] = lim;
  }
  __syncthreads();

  // 1. the mismatch bits, 16 query positions an item: row t % kTile,
  // query word t / kTile (half-words past NW: 0)
  uint16_t* halves = (uint16_t*)words;
  const int hpr = 2 * wpr;
  for (int t = threadIdx.x; t < kTile * hpr; t += blockDim.x) {
    const int r = t % kTile, j = t / kTile;
    uint32_t bits = 0;
    if (j < NW) {
      const int lim = s_lim[r] - 16 * j;  // in-read positions here
      const uint32_t inread =
          lim >= 16 ? kLaneLo
                    : (lim <= 0 ? 0u : kLaneLo & ((1u << (2 * lim)) - 1u));
      const int64_t left = s_left[r];
      uint32_t word = inread;  // an unplaceable diagonal mismatches here
      if (inread && left >= 0) {
        const int64_t qw = (int64_t)s_read[r] * NW + j;
        const uint32_t q = convert_word((uint32_t)qcodes[qw], conv);
        const uint32_t qn = expand2((uint32_t)qnflags[qw]) & kLaneLo;
        uint32_t m = mismatch_word(ref, flag, nwords, left, j, q, qn, conv,
                                   qunk, gunk);
        if (alt_ref != nullptr)
          m &= mismatch_word(alt_ref, alt_flag, nwords, left, j, q, qn, conv,
                             qunk, gunk);
        word = m & inread;
      }
      bits = compact_even(word);
    }
    halves[r * hpr + j] = (uint16_t)bits;
  }
  __syncthreads();

  // 2. the mismatches below each word of a row
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    int run = 0;
    for (int w = 0; w < wpr; ++w) {
      below[r * wpr + w] = run;
      run += __popc(words[r * wpr + w]);
    }
  }
  __syncthreads();

  // 3a. mm: 16 consecutive bytes of the tile's span a thread; a chunk may
  // run on into the next row (into several when L < 16).  (r, pos) of a
  // thread's chunk advance by the stride's rows and remainder
  uint8_t* mdst = mm + p0 * L;
  const int mbytes = nt * L;
  {
    const int step = 16 * blockDim.x, dr = step / L, dpos = step % L;
    int r0 = 16 * threadIdx.x / L, pos0 = 16 * threadIdx.x % L;
    for (int i = threadIdx.x; 16 * i < mbytes; i += blockDim.x) {
      uint32_t bits = 0;
      for (int k = 0, r = r0, pos = pos0; k < 16; ++r, pos = 0) {
        const int n = min(16 - k, L - pos);
        const uint32_t* w = words + r * wpr + (pos >> 5);
        bits |= (__funnelshift_r(w[0], w[1], pos & 31) & low_bits(n)) << k;
        k += n;
      }
      if (16 * i + 16 <= mbytes) {
        uint4 v;
        v.x = nibble_bytes(bits);
        v.y = nibble_bytes(bits >> 4);
        v.z = nibble_bytes(bits >> 8);
        v.w = nibble_bytes(bits >> 12);
        *(uint4*)(mdst + 16 * i) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (16 * i + e < mbytes) mdst[16 * i + e] = (uint8_t)((bits >> e) & 1u);
      }
      r0 += dr;
      pos0 += dpos;
      if (pos0 >= L) {
        pos0 -= L;
        ++r0;
      }
    }
  }

  // 3b. pref: 4 consecutive ints of the tile's span a thread
  int32_t* pdst = pref + p0 * (L + 1);
  const int pints = nt * (L + 1);
  {
    const int step = 4 * blockDim.x, dr = step / (L + 1),
              ds = step % (L + 1);
    int r0 = 4 * threadIdx.x / (L + 1), s0 = 4 * threadIdx.x % (L + 1);
    for (int i = threadIdx.x; 4 * i < pints; i += blockDim.x) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0, r = r0, s = s0; e < 4; ++e) {
        const int w = r * wpr + (s >> 5);
        v[e] = (uint32_t)(below[w] + __popc(words[w] & low_bits(s & 31)));
        if (++s > L) {
          s = 0;
          ++r;
        }
      }
      if (4 * i + 4 <= pints) {
        uint4 x;
        x.x = v[0];
        x.y = v[1];
        x.z = v[2];
        x.w = v[3];
        *(uint4*)(pdst + 4 * i) = x;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * i + e < pints) pdst[4 * i + e] = (int32_t)v[e];
      }
      r0 += dr;
      s0 += ds;
      if (s0 > L) {
        s0 -= L + 1;
        ++r0;
      }
    }
  }
}

}  // namespace

extern "C" int gsnap_prefix_mismatches(
    const void* ref, const void* flag, const void* alt_ref,
    const void* alt_flag, const void* qcodes, const void* qnflags,
    const void* diags, const void* lengths, void* mm, void* pref,
    int64_t nwords, int64_t glen, int B, int NC, int L, int NW, int conv,
    int qunk, int gunk, void* stream) {
  // the tiles' 16-byte stores need 16-byte aligned outputs
  if (L < 1 || NW < 1 || NW * 16 < L || conv < 0 || conv > 4 ||
      ((uintptr_t)mm & 15) || ((uintptr_t)pref & 15))
    return (int)cudaErrorInvalidValue;
  // the rows' words and counts, beside the static s_left, s_read, s_lim
  const size_t smem = (size_t)2 * kTile * row_words(NW) * 4;
  constexpr size_t kStatic = (size_t)kTile * (8 + 4 + 4);
  if (smem + kStatic > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * NC;
  if (total == 0) return 0;
  if (smem + kStatic > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefix_mismatches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prefix_mismatches_kernel<<<(unsigned)((total + kTile - 1) / kTile), kThreads,
                             smem, (cudaStream_t)stream>>>(
      (const uint32_t*)ref, (const uint32_t*)flag, (const uint32_t*)alt_ref,
      (const uint32_t*)alt_flag, (const int64_t*)qcodes,
      (const int64_t*)qnflags, (const int64_t*)diags,
      (const int32_t*)lengths, (uint8_t*)mm, (int32_t*)pref, nwords, glen,
      total, NC, L, NW, conv, qunk, gunk);
  return (int)cudaGetLastError();
}
