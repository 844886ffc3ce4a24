// Kernel K17: pack a read batch and its per-read reverse complement.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _pack_device (:547) and
// _revcomp_batch (:565), which the cascade calls together at the head of
// align_batch and gather_candidates: from codes uint8 [B, L], nflags bool
// [B, L] and lengths int32 [B] it writes
//   * queries_fwd: codes16 / nflags16 int64 [B, W], W = ceil(L / 16), 16
//     bases a word, 2-bit codes LSB-first (uint32 values).  The N flag is
//     set at positions >= the read's length; their code stays as given.
//     The pad bases up to W * 16 carry code 0 and flag 1;
//   * codes_rc / nflags_rc [B, L]: position i takes source len - 1 - i
//     (L - 1 - i with `uniform`, a flip), code ^ 3; positions whose
//     source is < 0 get code 0 and flag 1; the source is clipped to
//     [0, L - 1], as take_along_axis clips it;
//   * queries_rev: the packed form of codes_rc / nflags_rc (the N flag
//     again set at positions >= the read's length).
//
// Bound: bytes — 2 x B x L bytes in, 2 x B x L bytes and 4 x 8 x B x W
// bytes out: 0.00038 ms at B = 2,048, L = 100, below the cost of any
// launch, so the kernel is judged against an empty kernel on the same
// grid (gsnap_pack_queries_floor).
//
// Design: R lanes a read (4 a 16-base word: R = 4, 8, 16 or 32, as W
// needs; a warp a read from W = 5 on, and past 512 bases a warp each
// 512 bases of it), eight warps a CTA, so B = 2,048 reads of 100 bases
// fill 256 CTAs.  A lane takes 4 bases of a chunk of 4 R: their codes
// and flags in one 4-byte load each (from the aligned words that hold
// them, joined by __byte_perm where the row is not aligned: rows start
// at b * L bytes), and the 4 reverse-complement bases from the 4 source
// bytes that end at len - 1 - i, loaded the same way and reversed by the
// same __byte_perm, complemented 4 at a time (^ 0x03030303).  The row's
// bytes stay in L1 between the two loads, so no shared memory is used
// and no read length is refused.  (Taking a row of one chunk's reverse
// bytes from the lanes' forward words by shuffles instead of the second
// load measured slower on the H100: 0.0023 against 0.0022 ms at 2,048
// reads.)  Each 16-base word is ORed together from its 4 lanes by two
// shuffles; codes_rc / nflags_rc go out as one 4-byte store a lane where
// the row is aligned.  Groups that touch the row's end, the read's
// length (a source below 0) or a source past L - 1 (clipped) take a byte
// path in the same loop.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // warps a CTA
constexpr int kChunksPerWarp = 4;  // a warp's chunks of 128 bases at most

// lanes a read: 4 a 16-base word, a warp at most (its chunk loop then
// covers up to kChunksPerWarp x 128 bases of the row)
__host__ __device__ inline int lanes_per_read(int W) {
  return W <= 1 ? 4 : W <= 2 ? 8 : W <= 4 ? 16 : 32;
}

// warps a read: one up to 512 bases, past that one a segment of
// kChunksPerWarp chunks (8 words each), so that long reads spread over
// the card too
__host__ __device__ inline int segments_per_read(int W) {
  const int seg_words = 8 * kChunksPerWarp;
  return (W + seg_words - 1) / seg_words;
}

// The 4 bytes at p, any alignment, from the aligned words that hold them
// (the second one read only where p is not aligned, so nothing past
// p[3]'s word is read).  kReverse: byte 0 of the result is p[3].
template <bool kReverse>
__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const unsigned o = (unsigned)(a & 3);
  const uint32_t* w = (const uint32_t*)(a - o);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = o ? __ldg(w + 1) : 0u;
  return __byte_perm(lo, hi, (kReverse ? 0x0123u : 0x3210u) + 0x1111u * o);
}

// 4 code bytes (2-bit codes) -> 8 bits, byte j at bits 2j
__device__ __forceinline__ uint32_t pack_codes(uint32_t x) {
  x &= 0x03030303u;
  x |= x >> 6;
  x |= x >> 12;
  return x & 0xFFu;
}

// 4 flag bytes (0 / 1) -> 4 bits, byte j at bit j
__device__ __forceinline__ uint32_t pack_flags(uint32_t x) {
  x &= 0x01010101u;
  x |= x >> 7;
  x |= x >> 14;
  return x & 0xFu;
}

__global__ void __launch_bounds__(32 * kWarps)
    pack_queries_kernel(const uint8_t* __restrict__ codes,
                        const uint8_t* __restrict__ nflags,
                        const int32_t* __restrict__ lengths,
                        int64_t* __restrict__ fwd_codes16,
                        int64_t* __restrict__ fwd_nflags16,
                        uint8_t* __restrict__ codes_rc,
                        uint8_t* __restrict__ nflags_rc,
                        int64_t* __restrict__ rev_codes16,
                        int64_t* __restrict__ rev_nflags16, int B, int L,
                        int W, int uniform) {
  const int R = lanes_per_read(W), segs = segments_per_read(W);
  const int64_t thread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t unit = thread / R, units = (int64_t)B * segs;
  // a warp whose first (read, segment) is past the batch has nothing to
  // do; in the others every lane takes part in the shuffles
  if ((thread & ~(int64_t)31) / R >= units) return;
  const bool active = unit < units;
  const int64_t b = unit / segs;
  const int seg0 = (int)(unit % segs) * 128 * kChunksPerWarp;
  const int seg_end = min(W * 16, seg0 + 128 * kChunksPerWarp);
  const int t = (int)(thread & (R - 1));   // the lane's place in its read
  const int q = t & 3;                     // its quarter of a 16-base word
  const int len = active ? lengths[b] : 0;
  const int src_end = (uniform ? L : len) - 1;   // base i's source + i
  const uint8_t* c = codes + b * L;
  const uint8_t* f = nflags + b * L;
  uint8_t* oc = codes_rc + b * L;
  uint8_t* of = nflags_rc + b * L;
  const bool aligned = (((uintptr_t)oc | (uintptr_t)of) & 3) == 0;
  for (int i0 = seg0; i0 < seg_end; i0 += 4 * R) {
    const int i = i0 + 4 * t;   // the lane's first base
    // pad bases (i >= L): code 0, flag 1
    uint32_t fc = 0, ff = 0xFu, rc = 0, rf = 0xFu;
    if (active && i < L) {
      // bases i .. i + 3 at or past the read's length
      const uint32_t past_len = (0xFu << min(max(len - i, 0), 4)) & 0xFu;
      const int s0 = src_end - i;   // base i + j takes source s0 - j
      uint32_t xc, xf, yc, yf;      // forward and reverse-complement bytes
      if (i + 4 <= L) {
        xc = load4<false>(c + i);
        xf = load4<false>(f + i);
      } else {
        xc = 0;
        xf = 0;
        for (int j = 0; j < 4; ++j) {
          if (i + j < L) {
            xc |= (uint32_t)c[i + j] << (8 * j);
            xf |= (uint32_t)f[i + j] << (8 * j);
          } else {
            xf |= 1u << (8 * j);
          }
        }
      }
      if (i + 4 <= L && s0 >= 3 && s0 <= L - 1) {
        yc = load4<true>(c + s0 - 3) ^ 0x03030303u;
        yf = load4<true>(f + s0 - 3);
      } else {
        yc = 0;
        yf = 0;
        for (int j = 0; j < 4; ++j) {
          uint32_t cj = 0, fj = 1;
          const int s = s0 - j;
          if (i + j < L && s >= 0) {
            const int k = min(s, L - 1);
            cj = c[k] ^ 3u;
            fj = f[k];
          }
          yc |= cj << (8 * j);
          yf |= fj << (8 * j);
        }
      }
      if (i + 4 <= L && aligned) {
        *(uint32_t*)(oc + i) = yc;
        *(uint32_t*)(of + i) = yf;
      } else {
        for (int j = 0; j < 4 && i + j < L; ++j) {
          oc[i + j] = (uint8_t)(yc >> (8 * j));
          of[i + j] = (uint8_t)(yf >> (8 * j));
        }
      }
      fc = pack_codes(xc);
      ff = pack_flags(xf) | past_len;
      rc = pack_codes(yc);
      rf = pack_flags(yf) | past_len;
    }
    // a 16-base word from its 4 lanes: codes at 8 q, the forward flags at
    // 4 q and the reverse ones at 16 + 4 q
    uint32_t wc = fc << (8 * q), wr = rc << (8 * q);
    uint32_t wf = (ff << (4 * q)) | (rf << (16 + 4 * q));
    for (int m = 1; m <= 2; m <<= 1) {
      wc |= __shfl_xor_sync(GSNAP_FULL_MASK, wc, m);
      wr |= __shfl_xor_sync(GSNAP_FULL_MASK, wr, m);
      wf |= __shfl_xor_sync(GSNAP_FULL_MASK, wf, m);
    }
    const int w = i0 / 16 + t / 4;
    if (active && q == 0 && w < W) {
      const int64_t o = b * W + w;
      fwd_codes16[o] = (int64_t)wc;
      fwd_nflags16[o] = (int64_t)(wf & 0xFFFFu);
      rev_codes16[o] = (int64_t)wr;
      rev_nflags16[o] = (int64_t)(wf >> 16);
    }
  }
}

// The launch floor: an empty kernel on K17's grid.
__global__ void pack_queries_floor_kernel() {}

inline int pack_blocks(int B, int W) {
  return gsnap_blocks((int64_t)B * segments_per_read(W),
                      kWarps * 32 / lanes_per_read(W));
}

}  // namespace

extern "C" int gsnap_pack_queries(const void* codes, const void* nflags,
                                  const void* lengths, void* fwd_codes16,
                                  void* fwd_nflags16, void* codes_rc,
                                  void* nflags_rc, void* rev_codes16,
                                  void* rev_nflags16, int B, int L, int W,
                                  int uniform, void* stream) {
  if (B < 0 || L < 0 || W != (L + 15) / 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  pack_queries_kernel<<<pack_blocks(B, W), 32 * kWarps, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)nflags, (const int32_t*)lengths,
      (int64_t*)fwd_codes16, (int64_t*)fwd_nflags16, (uint8_t*)codes_rc,
      (uint8_t*)nflags_rc, (int64_t*)rev_codes16, (int64_t*)rev_nflags16, B,
      L, W, uniform);
  return (int)cudaGetLastError();
}

extern "C" int gsnap_pack_queries_floor(int B, int L, void* stream) {
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  pack_queries_floor_kernel<<<pack_blocks(B, (L + 15) / 16), 32 * kWarps, 0,
                              (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
