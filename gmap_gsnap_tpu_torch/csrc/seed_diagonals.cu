// Kernel K1: seed diagonals on the compact seed grid.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _extract_oligos (:178),
// _seed_rank_map (:203) and _seed_diagonals (:289).  One warp per read,
// up to eight reads a CTA, and no block barrier:
//   1. the warp loads the read's codes (2-bit, 0..3) and N flags with
//      coalesced byte loads and packs them into shared memory, the codes
//      16 to a word MSB-first (shuffles) and the N flags 32 to a word (a
//      ballot);
//   2. lane j takes k-mers j, j+32, ...: each k-mer is two shifts of two
//      packed words, its N test two more, then its two reads of the
//      4^k+1-entry offsets table; usable = count in (0, threshold].
//      Ballots of the in-threshold k-mers give the pigeonhole inputs:
//      lane p < q counts phase p with one popcount a 32-k-mer chunk, for
//      the whole read and its two halves;
//   3. the usable counts are scanned in registers: lane j sums a run of R
//      consecutive k-mers (R = ceil(S/32), odd, so the runs start on
//      distinct shared-memory banks), one warp scan by shuffles gives its
//      first slot: k-mer o owns slots [cum[o-1], cum[o]) of the read's W;
//   4. the slots are filled 128 at a time: each lane marks, in the warp's
//      shared memory, the usable k-mers of its run that start in the
//      window (their first slot is known: no search), an OR of the
//      lanes' start bits gives each slot its owner (the highest start at
//      or below it, else the window before's last), every lane reads its
//      four slots' positions together, and diag / qpos are stored
//      coalesced.  diag = position - o, INVALID below genome start.
// Slots past the read's total stay INVALID and carry the last usable
// oligo as qpos, exactly as the JAX scatter + running max leaves them.
//
// Shard bounds (parallel/shard.py, JAX's sharded_seed_diagonals
// :147): `positions` may be one shard of the array, holding global
// elements [pos_lo, pos_lo + pos_len).  A filled slot whose global
// element g (before any clamp) lies outside them is INVALID; else its
// position is positions[g - pos_lo].  The offsets are replicated, so
// qpos, trunc and the phase floors are the same from every shard, and
// the MIN over the shards is the whole array's diag (a valid diag is
// below INVALID: pos - qpos < pos <= 0xFFFFFFFF).  The defaults, 0 and
// N, leave every slot's element inside: a compare and a base offset.
//
// Bound: the outputs (12 bytes a slot: 18.9 MB at 4,096 reads of W=384)
// dominate the bytes; then two entries a k-mer in the offsets table
// (random: 4.3 GB at k=15, a sector and a likely TLB miss each) and a
// positions read a slot (runs of consecutive addresses).  One warp a read
// and ~1.8 KB of shared memory a warp at 100 bases fit 4,096 reads in one
// wave on 132 SMs, with no barrier between a warp's rounds of loads.
// What takes the card longest is the random offsets reads of all the
// reads at once, about as long whether the table's entries are in L2 or
// not, at k=12 as at k=15, read as one 16-byte load or two 4-byte ones,
// through L1 or around it, in fewer warps an SM (two or four waves) or
// in the block-a-read design this one replaced; a warp's chunks' reads
// issued one chunk at a time took a little less than four chunks' at
// once (tools/probe_seed_gotoh.py).
// Shared memory grows with the read (8 bytes a k-mer: its start and
// usable count), opted in above 48 KB: fewer warps a CTA for long reads,
// one warp for a read of up to ~28,000 k-mers (kernels/limits.py
// seed_diagonals_bytes mirrors warp_words).
//
// SEED_STAMP(i): lane 0's end of phase i of a read (0 its start, 1 the
// codes packed, 2 the k-mers and offset reads, 3 the scan, 4 the filled
// slots, 5 the empty ones), defined by a probe build
// (tools/probe_seed_gotoh.py) and empty in the default one.
#include <climits>

#include "common.cuh"

#ifndef SEED_STAMP
#define SEED_STAMP(i)
#endif

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxQ = 32;      // sampling interval
constexpr int kMaxK = 16;      // a k-mer in 32 bits
constexpr int kSmemMax = 232448;  // a CTA's opt-in shared memory
constexpr int kWindow = 128;   // slots filled at once: four a lane

// Packed code words and N-flag words of a read of S k-mers (at most
// S + kMaxK - 1 bases), each with a word of padding.
__host__ __device__ inline int code_words(int S) {
  return (S + kMaxK - 1 + 15) / 16 + 1;
}
__host__ __device__ inline int nflag_words(int S) {
  return (S + kMaxK - 1 + 31) / 32 + 1;
}

// 4-byte words of a warp's shared memory: each k-mer's start and usable
// count, the packed codes and N flags, a window's owners and starts;
// rounded to 16 bytes.
__host__ __device__ inline int warp_words(int S) {
  return (2 * S + code_words(S) + nflag_words(S) + 2 * kWindow + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kMaxWarps * 32) seed_diagonals_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ nflags,
    const int32_t* __restrict__ lengths, const uint32_t* __restrict__ offsets,
    const uint32_t* __restrict__ positions, int64_t* __restrict__ diag,
    int32_t* __restrict__ qpos, uint8_t* __restrict__ trunc,
    int32_t* __restrict__ nphase_min, int32_t* __restrict__ nph_half, int B,
    int L, int k, int q, int size_threshold, int W, int half,
    int64_t noffsets, int64_t npositions, int64_t pos_lo, int64_t pos_len) {
  extern __shared__ __align__(16) uint32_t s_dyn[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave; no block barrier follows
  const int S = L - k + 1;
  uint32_t* s_start = s_dyn + (threadIdx.x >> 5) * warp_words(S);
  int32_t* s_cnt = (int32_t*)(s_start + S);
  uint32_t* s_code = (uint32_t*)(s_cnt + S);
  uint32_t* s_nmask = s_code + code_words(S);
  int32_t* s_own = (int32_t*)(s_nmask + nflag_words(S));  // [kWindow]
  uint32_t* s_wstart = (uint32_t*)(s_own + kWindow);      // [kWindow]
  const int len = lengths[row];
  const int half_len = len / 2;
  SEED_STAMP(0);

  // 1. the read packed: base 16w + i at bits 31 - 2i of code word w, base
  // 32w + i at bit i of N-flag word w; zeros past the read
  const uint8_t* c = codes + (int64_t)row * L;
  const uint8_t* nf = nflags + (int64_t)row * L;
  const int cw = code_words(S), nw = nflag_words(S);
  const int nchunk = max((cw + 1) / 2, nw);
  for (int ch = 0; ch < nchunk; ++ch) {
    const int pos = ch * 32 + lane;
    const bool in = pos < L;
    uint32_t v = in ? (uint32_t)(c[pos] & 3) << (30 - 2 * (lane & 15)) : 0;
    const unsigned n = __ballot_sync(GSNAP_FULL_MASK, in && nf[pos]);
    for (int off = 1; off < 16; off <<= 1)
      v |= __shfl_xor_sync(GSNAP_FULL_MASK, v, off);
    const int w = 2 * ch + (lane >> 4);
    if ((lane & 15) == 0 && w < cw) s_code[w] = v;
    if (lane == 0 && ch < nw) s_nmask[ch] = n;
  }
  __syncwarp();
  SEED_STAMP(1);

  // 2. k-mers o = 32 j + lane: value, N test, offsets; phase ballots
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1;
  const uint32_t nmask = (1u << k) - 1;
  uint32_t phase0 = 0;  // bits b of a chunk with b % q == 0
  for (int b = 0; b < 32; b += q) phase0 |= 1u << b;
  // chunk j's bits of phase `lane` are phase0 << rot, rot = (lane - 32 j)
  // mod q: one division here, then a step of -(32 mod q) a chunk
  const int step = 32 % q;
  int rot = lane % q;
  int cnt[3] = {0, 0, 0}, tot[3] = {0, 0, 0};
  int olast = -1;
  const int nch = (S + 31) / 32;
  for (int j = 0; j < nch; ++j) {
    const int o = j * 32 + lane;
    uint32_t st = 0, en = 0;
    bool valid = false;
    if (o < S) {
      const int w = o >> 4, sh = o & 15;
      const uint64_t x = (uint64_t)s_code[w] << 32 | s_code[w + 1];
      const uint32_t oligo = (uint32_t)(x >> (64 - 2 * sh - 2 * k)) & kmask;
      const int v = o >> 5;
      const uint64_t y = (uint64_t)s_nmask[v + 1] << 32 | s_nmask[v];
      valid = ((uint32_t)(y >> (o & 31)) & nmask) == 0 && o + k <= len;
      if (valid) {
        const int64_t nxt =
            (int64_t)oligo + 1 < noffsets ? (int64_t)oligo + 1 : noffsets - 1;
        st = __ldg(offsets + oligo);
        en = __ldg(offsets + nxt);
      }
    }
    const int count = (int)(en - st);
    const bool inthr = valid && count <= size_threshold;
    const bool usable = inthr && count > 0;
    if (o < S) {
      s_start[o] = st;
      s_cnt[o] = usable ? count : 0;
    }
    if (usable) olast = o;
    const unsigned m[3] = {
        __ballot_sync(GSNAP_FULL_MASK, inthr),
        __ballot_sync(GSNAP_FULL_MASK, inthr && half && o + k <= half_len),
        __ballot_sync(GSNAP_FULL_MASK, inthr && half && o >= half_len)};
    // this chunk's bits of phase `lane`: b with (32 j + b) % q == lane
    const uint32_t pm = lane < q ? phase0 << rot : 0;
    rot = rot >= step ? rot - step : rot - step + q;
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      cnt[h] += __popc(m[h] & pm);
      tot[h] += __popc(m[h]);
    }
  }
  __syncwarp();
  SEED_STAMP(2);

  // 3. lane j's run of R k-mers, its sum, and one warp scan
  const int R = ((S + 31) / 32) | 1;
  const int lo = min(lane * R, S), hi = min(lo + R, S);
  int sum = 0;
  for (int o = lo; o < hi; ++o) sum += s_cnt[o];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(GSNAP_FULL_MASK, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(GSNAP_FULL_MASK, incl, 31);
  int run = incl - sum;  // the first slot of the lane's next k-mer
  const int nfilled = total < W ? total : W;
  const int olast_read = max(__reduce_max_sync(GSNAP_FULL_MASK, olast), 0);
  int mn[3];  // the least phase count, capped at the total
#pragma unroll
  for (int h = 0; h < 3; ++h)
    mn[h] = min(__reduce_min_sync(GSNAP_FULL_MASK, lane < q ? cnt[h] : INT_MAX),
                tot[h]);
  if (lane == 0) {
    trunc[row] = total > W;
    nphase_min[row] = mn[0];
    nph_half[row] = half ? min(mn[1], mn[2]) : 0;
  }
  SEED_STAMP(3);

  // 4. the filled slots, a window of kWindow at a time
  int64_t* drow = diag + (int64_t)row * W;
  int32_t* qrow = qpos + (int64_t)row * W;
  const uint32_t below = lane == 31 ? 0xFFFFFFFFu : (2u << lane) - 1;
  int ptr = lo;
  int own_c = 0, first_c = 0;  // the owner of the window before's last slot
  uint32_t start_c = 0;
  for (int t0 = 0; t0 < nfilled; t0 += kWindow) {
    uint32_t mk[4] = {0, 0, 0, 0};
    while (ptr < hi && run < t0 + kWindow) {  // starts before t0: done
      const int n = s_cnt[ptr];
      if (n > 0) {
        const int at = run - t0;
        s_own[at] = ptr;
        s_wstart[at] = s_start[ptr];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if ((at >> 5) == u) mk[u] |= 1u << (at & 31);
      }
      run += n;
      ++ptr;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) mk[u] = __reduce_or_sync(GSNAP_FULL_MASK, mk[u]);
    __syncwarp();
    int own[4], prev = -1;
    int64_t gi[4];
    bool held[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t m = mk[u] & below;
      const int at = m ? 32 * u + 31 - __clz(m) : prev;
      if (mk[u]) prev = 32 * u + 31 - __clz(mk[u]);
      const int t = t0 + 32 * u + lane;
      const int o = at >= 0 ? s_own[at] : own_c;
      const uint32_t st = at >= 0 ? s_wstart[at] : start_c;
      const int first = at >= 0 ? t0 + at : first_c;
      int64_t g = (int64_t)st + (t - first);
      held[u] = g >= pos_lo && g < pos_lo + pos_len;
      g -= pos_lo;
      g = g < 0 ? 0 : (g > npositions - 1 ? npositions - 1 : g);
      own[u] = o;
      gi[u] = g;
    }
    if (prev >= 0) {
      own_c = s_own[prev];
      start_c = s_wstart[prev];
      first_c = t0 + prev;
    }
    __syncwarp();  // the window's marks read before the next one's
    uint32_t p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + 32 * u + lane;
      p[u] = t < nfilled && held[u] ? __ldg(positions + gi[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + 32 * u + lane;
      if (t < W) {
        const bool f = t < nfilled && held[u];
        drow[t] = f && p[u] >= (uint32_t)own[u]
                      ? (int64_t)(p[u] - (uint32_t)own[u])
                      : GSNAP_INVALID_DIAG;
        qrow[t] = t < nfilled ? own[u] : olast_read;
      }
    }
  }
  SEED_STAMP(4);
  const int tail = (nfilled + kWindow - 1) / kWindow * kWindow;
  for (int t = tail + lane; t < W; t += 32) {
    drow[t] = GSNAP_INVALID_DIAG;
    qrow[t] = olast_read;
  }
  SEED_STAMP(5);
}

}  // namespace

extern "C" int gsnap_seed_diagonals(
    const void* codes, const void* nflags, const void* lengths,
    const void* offsets, const void* positions, void* diag, void* qpos,
    void* trunc, void* nphase_min, void* nph_half, int B, int L, int k, int q,
    int size_threshold, int W, int half, int64_t noffsets, int64_t npositions,
    int64_t pos_lo, int64_t pos_len, void* stream) {
  const int S = L - k + 1;
  if (S < 1 || k < 1 || k > kMaxK || q < 1 || q > kMaxQ || W < 0 ||
      pos_lo < 0 || pos_len < 0)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)4 * warp_words(S);
  if (per_warp > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t fit = kSmemMax / per_warp;  // warps a CTA, one read each
  const int warps = fit < kMaxWarps ? (int)fit : kMaxWarps;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_diagonals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seed_diagonals_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)nflags, (const int32_t*)lengths,
      (const uint32_t*)offsets, (const uint32_t*)positions, (int64_t*)diag,
      (int32_t*)qpos, (uint8_t*)trunc, (int32_t*)nphase_min,
      (int32_t*)nph_half, B, L, k, q, size_threshold, W, half, noffsets,
      npositions, pos_lo, pos_len);
  return (int)cudaGetLastError();
}

extern "C" const char* gsnap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
