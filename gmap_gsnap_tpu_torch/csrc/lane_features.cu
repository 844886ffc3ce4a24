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
//     the mask, clamped to the padded width L as the JAX package does);
//   - the first and last clean k-mer windows at sampled starts and at
//     lastpos;
//   - the mismatches over the trimmed spans;
//   - the little-endian bit-packed mask, uint8[R, K, ceil(L/8)].
//
// Design: one warp per (row, candidate).  The warp reads the row's mask
// once, 32 positions a step: inclusive warp scans (shfl_up) give P and
// the mismatch counts C, which stay in shared memory, and the running
// prefix min of P; a second pass over P from the right end (shfl_down)
// gives the suffix max.  The first / last maxima are warp reductions of
// (value, index) keys; a ballot gives four packed bytes per step.
//
// Bound: bytes — the mask read once (R K L bytes), 13 int32/bool
// features and ceil(L/8) packed bytes written per candidate.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kNeg = -(1 << 30);
constexpr int kBigPos = 1 << 30;

__device__ __forceinline__ int64_t warp_max64(int64_t v) {
  for (int o = 16; o > 0; o >>= 1)
    v = gmap_max64(v, (int64_t)__shfl_xor_sync(GSNAP_FULL_MASK, (long long)v, o));
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void lane_features_kernel(
    const uint8_t* __restrict__ mm, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ o_npos, int32_t* __restrict__ o_t5,
    int32_t* __restrict__ o_t3, int32_t* __restrict__ o_lowc,
    int32_t* __restrict__ o_lbc, int32_t* __restrict__ o_cle,
    int32_t* __restrict__ o_clt, int32_t* __restrict__ o_pfirst,
    int32_t* __restrict__ o_plast, uint8_t* __restrict__ o_present,
    int32_t* __restrict__ o_nmm_tt, int32_t* __restrict__ o_nmm_0t3,
    int32_t* __restrict__ o_nmm_t50, uint8_t* __restrict__ o_packed, int R,
    int K, int L, int k, int interval, int score) {
  extern __shared__ int32_t smem[];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + wib;
  if (row >= (int64_t)R * K) return;  // warp-uniform exit
  int32_t* P = smem + wib * 2 * (L + 1);  // P[0..L]
  int32_t* C = P + (L + 1);               // mismatches in [0, j)
  const int La = lengths[row / K];
  const uint8_t* m = mm + row * L;
  const int nby = (L + 7) / 8;
  uint8_t* packed = o_packed + row * nby;

  // forward pass: P, C, the prefix min of P, t3's last maximum, packing
  if (lane == 0) {
    P[0] = 0;
    C[0] = 0;
  }
  int carry_p = 0, carry_c = 0, carry_min = kBigPos;
  int64_t best3 = INT64_MIN;
  for (int base = 0; base < L; base += 32) {
    const int j = base + lane;
    const bool in = j < L;
    const int mj = in ? (m[j] != 0) : 0;
    const bool act = j < La;
    const int v = act ? (mj ? score : 1) : 0;
    int s = v, c = mj;
    for (int o = 1; o < 32; o <<= 1) {
      const int ys = __shfl_up_sync(GSNAP_FULL_MASK, s, o);
      const int yc = __shfl_up_sync(GSNAP_FULL_MASK, c, o);
      if (lane >= o) {
        s += ys;
        c += yc;
      }
    }
    s += carry_p;
    c += carry_c;
    const int pj = s - v;  // P[j]
    if (in) {
      P[j + 1] = s;
      C[j + 1] = c;
    }
    int im = in ? pj : kBigPos;  // inclusive prefix min of P in the step
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(GSNAP_FULL_MASK, im, o);
      if (lane >= o) im = min(im, y);
    }
    int ex = __shfl_up_sync(GSNAP_FULL_MASK, im, 1);
    if (lane == 0) ex = kBigPos;
    ex = min(ex, carry_min);  // Cm[j - 1] (2^30 at j = 0)
    if (in && act && mj) {
      const int sig3 = max(pj - ex, 0);
      best3 = gmap_max64(best3, (int64_t)sig3 * 4294967296ll + (int64_t)j);
    }
    const unsigned bal = __ballot_sync(GSNAP_FULL_MASK, mj);
    if (lane < 4 && base / 8 + lane < nby)
      packed[base / 8 + lane] = (uint8_t)((bal >> (8 * lane)) & 0xFFu);
    carry_p = __shfl_sync(GSNAP_FULL_MASK, s, 31);
    carry_c = __shfl_sync(GSNAP_FULL_MASK, c, 31);
    carry_min = min(carry_min, __shfl_sync(GSNAP_FULL_MASK, im, 31));
  }
  const int sfin3 = max(carry_p - carry_min, 0);  // P[L] - Cm[L-1]
  __syncwarp();

  // backward pass: suffix max of P, t5's first maximum
  int carry_t = kNeg;  // max of P beyond the step (Tpad[L+1] = NEG)
  int64_t best5 = INT64_MIN;
  for (int base = ((L + 31) / 32 - 1) * 32; base >= 0; base -= 32) {
    const int j = base + lane;
    const bool in = j < L;
    const int u = in ? P[j + 1] : kNeg;
    int rmax = u;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(GSNAP_FULL_MASK, rmax, o);
      if (lane + o < 32) rmax = max(rmax, y);
    }
    rmax = max(rmax, carry_t);
    int a = __shfl_down_sync(GSNAP_FULL_MASK, rmax, 1);
    if (lane == 31) a = carry_t;  // max(P[j+2..L])
    if (in && j < La && C[j + 1] != C[j]) {
      const int sig5 = max(a - u, 0);
      best5 = gmap_max64(best5, (int64_t)sig5 * 4294967296ll +
                                    (int64_t)(0xFFFFFFFFu - (uint32_t)j));
    }
    carry_t = __shfl_sync(GSNAP_FULL_MASK, rmax, 0);
  }
  const int sfin5 = max(carry_t, 0);  // max(T[1], 0)
  best5 = warp_max64(best5);
  best3 = warp_max64(best3);
  int t5 = 0, t3 = 0;
  if (best5 != INT64_MIN && !(sfin5 >= gmap_key_value(best5)))
    t5 = gmap_key_index(best5) + 1;
  if (best3 != INT64_MIN) {
    const int64_t low = best3 & 0xFFFFFFFFll;
    const int val = (int)((best3 - low) / 4294967296ll);
    if (!(sfin3 >= val)) t3 = La - (int)low;
  }

  // lane features from the mismatch counts
  const int spansize = ((k + interval - 1) / interval) * interval;
  const int firstbound = interval + (interval - 1) + k;
  const int lastpos = La - k;
  const int lastbound = lastpos - interval - 1;
  const int mtl = min(floor_div(La, 2), spansize + interval - 1);
  auto below = [&](int idx) { return C[min(max(idx, 0), L)]; };
  const int smax = max(1, floor_div(L - k, interval) + 1);
  int pf = kBigPos, pl = -1;
  for (int s = lane; s < smax; s += 32) {
    const int sp = s * interval;
    if (C[min(sp + k, L)] - C[sp] == 0 && sp <= lastpos) {
      pf = min(pf, sp);
      pl = max(pl, sp);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    pf = min(pf, __shfl_xor_sync(GSNAP_FULL_MASK, pf, o));
    pl = max(pl, __shfl_xor_sync(GSNAP_FULL_MASK, pl, o));
  }
  if (lane == 0) {
    if (below(lastpos + k) - below(lastpos) == 0 && lastpos > 0) {
      pf = min(pf, lastpos);
      pl = max(pl, lastpos);
    }
    const int npos = C[L];
    const int nmm_0t3 = below(La - t3);
    const int cb_t5 = below(t5);
    o_npos[row] = npos;
    o_t5[row] = t5;
    o_t3[row] = t3;
    o_lowc[row] = C[min(firstbound + 1, L)];
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
  if (L < 1 || k < 1 || interval < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)R * K == 0) return 0;
  const size_t smem = (size_t)kWarps * 2 * (L + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_features_kernel<<<gsnap_blocks((int64_t)R * K, kWarps), kWarps * 32,
                         smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mm, (const int32_t*)lengths, (int32_t*)npos,
      (int32_t*)t5, (int32_t*)t3, (int32_t*)lowc, (int32_t*)lbc,
      (int32_t*)cle, (int32_t*)clt, (int32_t*)pfirst, (int32_t*)plast,
      (uint8_t*)present, (int32_t*)nmm_tt, (int32_t*)nmm_0t3,
      (int32_t*)nmm_t50, (uint8_t*)packed, R, K, L, k, interval, score);
  return (int)cudaGetLastError();
}
