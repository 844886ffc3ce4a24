// Kernel K13: end trims, lane features and the bit-packed mismatch mask.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py _trim_ends_device (:119),
// _lane_features (:170) and _bitpack_mask (:1072).  Per candidate row of
// the [R, K, L] mismatch matrix (R = reads x strands) it computes
//   - the zero-clamped Kadane end trims t5 / t3 of trim_left_end /
//     trim_right_end (substring.c) with the '>=' tie rule: with v[j] =
//     score at an active mismatch, 1 at an active match, 0 past the
//     read, P = cat(0, cumsum(v)), T the suffix max of P and Cm its
//     prefix min, a mismatch j scores max(T[j+2] - P[j+1], 0) for t5
//     (first maximum) and max(P[j] - Cm[j-1], 0) for t3 (last maximum);
//     the trim is 0 where the untrimmed end scores at least as much
//     (max(T[1], 0) and max(P[L] - Cm[L-1], 0));
//   - the mismatch counts below the lane positions (the prefix counts of
//     the mask over the padded width L, as the JAX package clamps them);
//   - the first and last clean k-mer windows at sampled starts and at
//     lastpos;
//   - the mismatches over the trimmed spans;
//   - the little-endian bit-packed mask, uint8[R, K, ceil(L/8)].
//
// Bound: bytes — the mask read once (R K L bytes), 13 int32/bool
// features and ceil(L/8) packed bytes written per candidate (0.0063 ms
// at 4096 rows x 32 candidates, L = 100).  The design this one replaces
// (a warp a row: three 5-round shuffle scans per 32 positions, a second
// pass through shared memory, lane 0 alone storing the features) took
// 0.1675 ms there on the H100 (700 W): several hundred warp instructions
// for a row of 100 bytes.
//
// Design: a thread per candidate row, on its bits.
//   1. A warp stages its 32 consecutive rows' mask bytes (contiguous,
//      32 L) in shared memory with 16-byte loads.
//   2. Each thread packs its row into ceil(L/32) words (8 bytes at a time:
//      a multiply gathers their low bits), kept in shared memory with the
//      mismatch count below each word; every count below a position is
//      then one popcount.  The words' bytes are the packed mask, which the
//      warp writes out through the staging area, coalesced.
//   3. The trims walk the row's active bits once forward (P, its prefix
//      min, t3's last maximum) and once backward (P from its end, its
//      suffix max, t5's first maximum), 8 unrolled positions a step, on
//      registers; a mismatch's score and position are one key, so that a
//      position costs about 8 instructions and no branch.
//   4. A sampled start is clean when no bit lies in its window: the OR of
//      the word's k shifts (log k steps of a 64-bit window) against the
//      block's word of sampled starts; the first and last by __ffs / __clz.
//   5. Each thread stores its 13 features: 32 consecutive values an array
//      a warp.
// Reads longer than kNarrowL = 1024 bases (kWide): the keys are 64-bit,
// position in 20 bits, and a warp stages its rows kNarrowL bytes of each
// at a time, so that the staging area stays 32 KB whatever L; the packed
// mask is then stored a row a thread.  Reads up to kNarrowL take the
// 32-bit keys and the whole-row staging above, unchanged.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory
constexpr int kBigPos = 1 << 30;
constexpr int kNarrowL = 1024;    // the longest read of 32-bit trim keys

__host__ __device__ inline int row_words(int L) { return (L + 31) / 32; }
// the words of sampled starts, a 16-byte multiple
__host__ __device__ inline int samp_words(int L) {
  return (row_words(L) + 1 + 3) / 4 * 4;
}
// bytes of a row a warp stages at a time: all of it, or kNarrowL bytes
// of a longer read
__host__ __device__ inline int stage_row(int L) {
  return L > kNarrowL ? kNarrowL : L;
}
// bytes of a warp's staging area: its rows' 32 stage_row(L) mask bytes,
// and 48 past them that the packing's unaligned word reads may touch
// (masked off)
__host__ __device__ inline int stage_bytes(int L) {
  return (32 * stage_row(L) + 15) / 16 * 16 + 48;
}
// 32-bit words of a warp's shared memory: the staging area, then for
// each word of a row and one past its last (0) the 32 rows' mask words
// and their mismatch counts below the word
__host__ __device__ inline int warp_words(int L) {
  return stage_bytes(L) / 4 + 2 * 32 * (row_words(L) + 1);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// bits 0 .. n - 1 (n clamped to [0, 32])
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << n) - 1u;
}

// the trims' keys: score and position in one integer (see step 3)
template <bool kWide>
struct TrimKey {
  using T = int;
  static constexpr int kShift = 10;  // positions below 1024
};
template <>
struct TrimKey<true> {
  using T = long long;
  static constexpr int kShift = 20;  // positions below 2^20
};

template <bool kWide>
__global__ void lane_features_kernel(
    const uint8_t* __restrict__ mm, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ o_npos, int32_t* __restrict__ o_t5,
    int32_t* __restrict__ o_t3, int32_t* __restrict__ o_lowc,
    int32_t* __restrict__ o_lbc, int32_t* __restrict__ o_cle,
    int32_t* __restrict__ o_clt, int32_t* __restrict__ o_pfirst,
    int32_t* __restrict__ o_plast, uint8_t* __restrict__ o_present,
    int32_t* __restrict__ o_nmm_tt, int32_t* __restrict__ o_nmm_0t3,
    int32_t* __restrict__ o_nmm_t50, uint8_t* __restrict__ o_packed,
    int64_t total, int K, int L, int k, int interval, int score) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = row_words(L);
  const int smax = max(1, floor_div(L - k, interval) + 1);
  // the sampled starts s * interval, s < smax, as words (block-wide)
  uint32_t* samp = smem;
  for (int w = threadIdx.x; w <= nw; w += blockDim.x) {
    uint32_t m = 0;
    int r = (32 * w) % interval, q = (32 * w) / interval;  // p = q i + r
    for (int b = 0; b < 32; ++b) {
      if (r == 0 && q < smax) m |= 1u << b;
      if (++r == interval) {
        r = 0;
        ++q;
      }
    }
    samp[w] = m;
  }
  __syncthreads();
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = ((int64_t)blockIdx.x * (blockDim.x >> 5) + wib) * 32;
  if (row0 >= total) return;  // warp-uniform exit
  const int nrows = (int)min((int64_t)32, total - row0);
  uint8_t* stage =
      (uint8_t*)(smem + samp_words(L) + (int64_t)wib * warp_words(L));
  uint32_t* words = (uint32_t*)(stage + stage_bytes(L));  // [nw + 1][32]
  int32_t* cnt = (int32_t*)(words + 32 * (nw + 1));       // [nw + 1][32]

  // 1. stage the rows' mask bytes (kWide: kNarrowL of each row at a time,
  // each row's piece at lane * kNarrowL)
  const uint8_t* src = mm + row0 * L;
  const bool has = lane < nrows;
  const int64_t row = row0 + lane;
  const int La = has ? lengths[row / K] : 0;
  for (int c0 = 0; c0 < (kWide ? L : 1); c0 += kNarrowL) {
  if (!kWide) {
    const int nbytes = nrows * L;
    int done = 0;
    if (((uintptr_t)src & 15) == 0) {
      done = nbytes & ~15;
      for (int i = lane; i < (nbytes >> 4); i += 32)
        ((uint4*)stage)[i] = __ldg((const uint4*)src + i);
    }
    for (int i = done + lane; i < nbytes; i += 32) stage[i] = src[i];
  } else if ((L & 15) == 0 && ((uintptr_t)src & 15) == 0) {
    for (int i = lane; i < nrows * (kNarrowL / 16); i += 32) {
      const int r = i / (kNarrowL / 16), j = 16 * (i % (kNarrowL / 16));
      if (c0 + j < L)
        ((uint4*)stage)[i] =
            __ldg((const uint4*)(src + (int64_t)r * L + c0 + j));
    }
  } else {
    for (int i = lane; i < nrows * kNarrowL; i += 32) {
      const int r = i / kNarrowL, j = i % kNarrowL;
      if (c0 + j < L) stage[i] = src[(int64_t)r * L + c0 + j];
    }
  }
  __syncwarp();

  // 2. pack the lane's row (bool bytes: bit 0), bits past L cleared
  const int wend = min(nw, (c0 + kNarrowL) / 32);
  for (int w = c0 / 32; w < wend; ++w) {
    uint32_t word = 0;
    if (has) {
      const int o = kWide ? lane * kNarrowL + 32 * w - c0 : lane * L + 32 * w;
      const uint32_t* sw = (const uint32_t*)stage + (o >> 2);
      const uint32_t r = 8u * (uint32_t)(o & 3);
      uint32_t x[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) x[i] = sw[i];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint64_t y =
            ((uint64_t)__funnelshift_r(x[2 * h + 1], x[2 * h + 2], r) << 32 |
             __funnelshift_r(x[2 * h], x[2 * h + 1], r)) &
            0x0101010101010101ull;
        word |= (uint32_t)((y * 0x0102040810204080ull) >> 56) << (8 * h);
      }
      word &= low_bits(L - 32 * w);
    }
    words[w * 32 + lane] = word;
  }
  __syncwarp();
  }
  words[nw * 32 + lane] = 0u;
  __syncwarp();
  const int nby = (L + 7) / 8;
  if (!kWide) {
    // the packed bytes, written out through the staging area
    if (has)
      for (int i = 0; i < nby; ++i)
        stage[lane * nby + i] =
            (uint8_t)(words[(i >> 2) * 32 + lane] >> (8 * (i & 3)));
    __syncwarp();
    uint8_t* dst = o_packed + row0 * nby;
    const int pbytes = nrows * nby;
    int done = 0;
    if (((uintptr_t)dst & 3) == 0) {
      done = pbytes & ~3;
      for (int i = lane; i < (pbytes >> 2); i += 32)
        ((uint32_t*)dst)[i] = ((const uint32_t*)stage)[i];
    }
    for (int i = done + lane; i < pbytes; i += 32) dst[i] = stage[i];
  } else if (has) {
    // a row a thread: its words, where the row starts on 4 bytes
    uint8_t* dst = o_packed + row * nby;
    int i = 0;
    if (((uintptr_t)dst & 3) == 0)
      for (; i + 4 <= nby; i += 4)
        ((uint32_t*)dst)[i >> 2] = words[(i >> 2) * 32 + lane];
    for (; i < nby; ++i)
      dst[i] = (uint8_t)(words[(i >> 2) * 32 + lane] >> (8 * (i & 3)));
  }

  // mismatches below each word, and below any position
  int npos = 0;
  for (int w = 0; w <= nw; ++w) {
    cnt[w * 32 + lane] = npos;
    npos += __popc(words[w * 32 + lane]);
  }
  auto below = [&](int idx) {
    idx = min(max(idx, 0), L);
    const int w = (idx >> 5) * 32 + lane;
    return cnt[w] + __popc(words[w] & low_bits(idx & 31));
  };

  // 3. the trims over the active positions j < Lx, 8 a step.  P and its
  // running min / max are kept times 2^s (s = kShift: 10, or 20 for
  // kWide), so that a mismatch's score and position make one key, score *
  // 2^s + j (t3: the last maximum) or + 2^s - 1 - j (t5: the first), and
  // a step is one max without a branch (the C entry keeps |score| <= L +
  // 1, so |P| <= (L + 1) L: |P| * 2^10 < 2^31 for L <= 1024 in 32 bits,
  // |P| * 2^20 < 2^63 for L < 2^20 in 64).  The forward walk's last step may pass Lx: those positions
  // count as matches, which raises neither the prefix min nor a key, and
  // are taken off P after.  The backward walk's steps end at Lx and its
  // last may pass 0: positions below 0 count as matches too, which adds
  // nothing to max(T[1], 0).
  const int Lx = min(max(La, 0), L);
  const int nst = (Lx + 7) >> 3;
  using Key = typename TrimKey<kWide>::T;
  constexpr int kShift = TrimKey<kWide>::kShift;
  constexpr Key kMask = ((Key)1 << kShift) - 1;
  const Key up = (Key)1 << kShift;     // a match's
  const Key down = (Key)score << kShift;  // and a mismatch's
  Key P = 0, Cm = 0, key3 = -1;        // (Cm[-1]: any value >= 0)
  for (int g = 0; g < nst; ++g) {
    const uint32_t bits = (words[(g >> 2) * 32 + lane] >> (8 * (g & 3))) &
                          low_bits(Lx - 8 * g);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool m = bits & (1u << b);
      const Key key = max(P - Cm, (Key)0) + 8 * g + b;
      key3 = max(key3, m ? key : (Key)-1);
      Cm = min(Cm, P);
      P += m ? down : up;
    }
  }
  P -= up * (8 * nst - Lx);                    // P[Lx] = P[L]
  const Key sfin3 = max(P - Cm, (Key)0) >> kShift;  // max(P[L] - Cm[L-1], 0)
  Key Pn = P, M = P;  // P[j + 1] and max(P[j + 2 ..]) (Tpad[L+1]: P[L])
  Key key5 = -1;
  for (int g = 0; g < nst; ++g) {
    const int p = Lx - 8 * (g + 1);            // the step's lowest position
    const uint32_t bits =
        p >= 0 ? __funnelshift_r(words[(p >> 5) * 32 + lane],
                                 words[((p >> 5) + 1) * 32 + lane], p & 31)
               : words[lane] << -p;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      const bool m = bits & (1u << b);
      const Key key = max(M - Pn, (Key)0) + kMask - p - b;
      key5 = max(key5, m ? key : (Key)-1);
      M = max(M, Pn);
      Pn -= m ? down : up;
    }
  }
  const Key sfin5 = max(M, (Key)0) >> kShift;  // max(T[1], 0)
  const int t5 = key5 < 0 || sfin5 >= (key5 >> kShift)
                     ? 0 : (int)(kMask - (key5 & kMask)) + 1;
  const int t3 = key3 < 0 || sfin3 >= (key3 >> kShift)
                     ? 0 : La - (int)(key3 & kMask);

  // 4. clean k-mer windows at sampled starts sp <= lastpos
  const int lastpos = La - k;
  int pf = kBigPos, pl = -1;
  for (int w = 0; w < nw && 32 * w <= lastpos; ++w) {
    const uint64_t x =
        (uint64_t)words[(w + 1) * 32 + lane] << 32 | words[w * 32 + lane];
    // OR of x >> i, i < k: bit b set where [32 w + b, + k) has a mismatch
    uint64_t t = x, dirty = 0;
    int off = 0;
    for (int e = 1; e <= 32; e <<= 1) {
      if (k & e) {
        dirty |= t >> off;
        off += e;
      }
      t |= t >> e;
    }
    const uint32_t z =
        ~(uint32_t)dirty & samp[w] & low_bits(lastpos - 32 * w + 1);
    if (z) {
      if (pf == kBigPos) pf = 32 * w + __ffs(z) - 1;
      pl = 32 * w + 31 - __clz(z);
    }
  }
  if (lastpos > 0 && below(lastpos + k) - below(lastpos) == 0) {
    pf = min(pf, lastpos);
    pl = max(pl, lastpos);
  }

  // 5. the features
  if (has) {
    const int spansize = ((k + interval - 1) / interval) * interval;
    const int firstbound = interval + (interval - 1) + k;
    const int lastbound = lastpos - interval - 1;
    const int mtl = min(floor_div(La, 2), spansize + interval - 1);
    const int nmm_0t3 = below(La - t3);
    const int cb_t5 = below(t5);
    o_npos[row] = npos;
    o_t5[row] = t5;
    o_t3[row] = t3;
    o_lowc[row] = below(firstbound + 1);
    o_lbc[row] = below(max(lastbound, 0));
    o_cle[row] = below(mtl + 1);
    o_clt[row] = below(La - mtl);
    o_pfirst[row] = pf;
    o_plast[row] = pl;
    o_present[row] = pf < kBigPos;
    o_nmm_tt[row] = nmm_0t3 - cb_t5;
    o_nmm_0t3[row] = nmm_0t3;
    o_nmm_t50[row] = npos - cb_t5;
  }
}

}  // namespace

extern "C" int gsnap_lane_features(
    const void* mm, const void* lengths, void* npos, void* t5, void* t3,
    void* lowc, void* lbc, void* cle, void* clt, void* pfirst, void* plast,
    void* present, void* nmm_tt, void* nmm_0t3, void* nmm_t50, void* packed,
    int R, int K, int L, int k, int interval, int score, void* stream) {
  // the clean-window test ORs k shifts of a 64-bit window: k <= 32; the
  // wide trims' keys hold a position in 20 bits
  if (L < 1 || L >= (1 << 20) || k < 1 || k > 32 || interval < 1)
    return (int)cudaErrorInvalidValue;
  // Every trim compares sums m + score c over spans of the row (m matches,
  // c mismatches, both <= L), with each other or with 0.  Beyond |score| >
  // L such a comparison is decided by c first and m second, whatever the
  // magnitude, so any score beyond L + 1 gives the trims of L + 1 (signed),
  // which keeps |P| <= (L + 1) L for the keys (step 3)
  score = score < -(L + 1) ? -(L + 1) : score > L + 1 ? L + 1 : score;
  // as many warps a CTA as fit (one at the least)
  const int64_t per_warp = (int64_t)warp_words(L) * 4;
  const int64_t fixed = (int64_t)samp_words(L) * 4;
  const int64_t fit = (kSmemMax - fixed) / per_warp;
  const int warps = (int)(fit < kMaxWarps ? fit : kMaxWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)R * K;
  if (total == 0) return 0;
  const size_t smem = (size_t)(fixed + warps * per_warp);
  const auto kernel = L > kNarrowL ? lane_features_kernel<true>
                                   : lane_features_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (total + 32 * warps - 1) / (32 * warps);
  kernel<<<(unsigned)blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mm, (const int32_t*)lengths, (int32_t*)npos,
      (int32_t*)t5, (int32_t*)t3, (int32_t*)lowc, (int32_t*)lbc,
      (int32_t*)cle, (int32_t*)clt, (int32_t*)pfirst, (int32_t*)plast,
      (uint8_t*)present, (int32_t*)nmm_tt, (int32_t*)nmm_0t3,
      (int32_t*)nmm_t50, (uint8_t*)packed, total, K, L, k, interval, score);
  return (int)cudaGetLastError();
}
