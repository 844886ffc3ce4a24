// Kernel K14: hit ranking, with the single-end gates as an epilogue.
//
// Replaces gmap_gsnap_tpu/align/gsnap_gapped.py rank_hits (:1165) and,
// behind flags, the SE candidate-budget overflow gate (:1259-1305) and
// _lane_noop_device (:253).  Per read, over its n candidates:
//   - dup[i]: some j < i has equal (kind, split, split2, mid, right,
//     plusp, left) — the entries the chain of stable argsorts marks; a
//     duplicate's score (when below BIG) becomes BIG;
//   - the optimal filter (apply_optimal): scores above the row's best +
//     subopt become BIG;
//   - the order (score, left, !plusp, index) of the stable sorts; the
//     first nout = min(maxout, n) ranks are kept.
// It writes, for those ranks, every field of the hit table (the field
// at the ranked candidate; 0 in the zeroed fields where the score is not
// below BIG), the score (BIG where not below BIG) and npaths.  The SE
// epilogue reads the ranked top and the unranked candidates' lane
// features: the overflow gate clears a row's flag when its done level
// sits below every lane gate or the dropped diagonals provably cannot
// reach it; the lane gate flags the candidates the host end-indel and
// terminal lanes must examine and whether the row is a no-op for them.
//
// Bound: bytes — the eight key fields of n candidates read once, every
// field of nout ranks read and written once (and with the epilogue 14
// features of the 2 NC candidates read, 2 flags each written).  At 2048
// reads x 144 candidates, nout 100, that is ~0.01 ms on the H100 (700
// W); the design this one replaces (one CTA a read, O(n^2) duplicate and
// rank counts over shared memory, then ~25 torch gathers and wheres)
// took 0.1818 ms there.
//
// Design: a CTA per read, N = n rounded up to a power of two (at least
// 32; n <= 512): one warp up to N = 256 (the main lanes, n = 144: no
// barrier at all), four warps at N = 512 (the wide lane, n = 336), where
// a single warp's 16 keys a lane made its serial rounds of loads and
// stores the long pole.  Loads go with neighbouring
// threads on neighbouring candidates, one field at a time (all of a
// thread's loads of a field issued together): the seven dedup fields
// into a 64-bit hash per candidate, score, left and !plusp into shared
// memory.  The n candidates are then sorted twice by row_sort's register
// bitonic network, N / (32 NW) keys a thread, where only the stages
// across warps go through shared memory:
//   1. dedup: the 32-bit key (23 bits of the hash) << 9 | index groups
//      equal tuples (and hash collisions) in runs ordered by index; a
//      candidate below BIG is a duplicate iff an earlier entry of its run
//      has the same seven fields, compared in full, so collisions cost
//      only compares (at BIG a duplicate changes nothing, and is not
//      looked for).  The best score is a row minimum.
//   2. rank: one 64-bit key, score << 42 | left << 10 | !plusp << 9 |
//      index.  The widths come from the candidates gather_candidates
//      builds: a score is a candidate's nmm plus penalties, or BIG_NMM =
//      10^6 < 2^20, and gets 22 bits; left is a uint32 held in an int64
//      (32 bits); the index is below 512 (9 bits).  A score outside [0,
//      2^22) or a left outside [0, 2^32) is never clamped: the kernel
//      stops with a trap, and the launch fails (as PyTorch's own
//      device-side asserts do); the wrapper refuses n > 512.
// The sorted keys go to shared memory, and thread t writes ranks t,
// t + 32 NW, ... field by field (coalesced stores).  The hit table
// is passed as a table of (source, destination, strides, element size,
// mode), so the fields are gathered in this launch and no field is
// converted or copied first.
#include "row_sort.cuh"

namespace {

constexpr int kMaxCand = 512;
constexpr int kBig = GSNAP_BIG_SCORE;
constexpr int kKindSub = 0;
constexpr int kMaxFields = 24;

// One column of the hit table: element [b, i] of the source is at src +
// (b * s0 + i * s1) * esize; the destination is a contiguous [B, nout]
// tensor of the same type.  mode: 0 copy, 1 copy or 0 where the ranked
// score is not below BIG, 2 the ranked score (BIG where not below BIG).
struct FieldDesc {
  int64_t src, dst, s0, s1, esize, mode;
};

// The dedup and ranking keys, in this order.
enum { kKind, kSplit, kSplit2, kMid, kRight, kPlus, kLeft, kScore, kNKeys };

struct Keys {
  FieldDesc f[kNKeys];
};

struct Fields {
  FieldDesc f[kMaxFields];
  int n;
};

struct LaneArgs {
  const int32_t *cand_nmm, *npos, *t5, *t3, *lowc, *lbc, *cle, *clt, *pfirst,
      *plast;
  const uint8_t* present;
  const int32_t *nmm_tt, *nmm_0t3, *nmm_t50;
};

struct SeArgs {
  const int32_t* lengths;
  const uint8_t *ovf_in, *ovf_trunc;
  const int32_t *ovf_bound, *hbound;
  uint8_t* ovf_o;
  LaneArgs la;
  uint8_t *noop_o, *ind_o, *term_o;
  int gate, lane_gate, max_mismatches, noop, nc2, k, interval,
      indel_penalty_end, terminal_threshold;
};

__device__ __forceinline__ const char* at(const FieldDesc& d, int64_t b,
                                          int i) {
  return (const char*)d.src + (b * d.s0 + (int64_t)i * d.s1) * d.esize;
}

// An integer or bool field's value (bools and uint8 as 0..255).
__device__ __forceinline__ int64_t load(const FieldDesc& d, int64_t b, int i) {
  const char* p = at(d, b, i);
  switch (d.esize) {
    case 1:
      return *(const uint8_t*)p;
    case 4:
      return *(const int32_t*)p;
    default:
      return *(const int64_t*)p;
  }
}

// Field d of candidates t + T r (r < KPL; 0 past n) for thread t of a
// row of T threads, the loads of one field issued together.
template <typename E, int KPL, int T>
__device__ __forceinline__ void load_typed(const FieldDesc& d, int64_t b,
                                           int t, int n, int64_t (&x)[KPL]) {
  const E* src = (const E*)d.src + b * d.s0;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = t + T * r;
    x[r] = i < n ? (int64_t)src[i * d.s1] : 0;
  }
}

template <int KPL, int T>
__device__ __forceinline__ void load_strided(const FieldDesc& d, int64_t b,
                                             int t, int n,
                                             int64_t (&x)[KPL]) {
  switch (d.esize) {
    case 1:
      load_typed<uint8_t, KPL, T>(d, b, t, n, x);
      break;
    case 4:
      load_typed<int32_t, KPL, T>(d, b, t, n, x);
      break;
    default:
      load_typed<int64_t, KPL, T>(d, b, t, n, x);
  }
}

// Ranks t + T j (j < KPL) of field d: the candidate's value, 0 where
// mode 1 and no hit, the ranked score where mode 2; the loads issued
// together, the stores coalesced.
template <typename E, int KPL, int T>
__device__ __forceinline__ void gather_typed(const FieldDesc& d, int64_t b,
                                             int t, int nout,
                                             const int (&idx)[KPL],
                                             const int (&sc)[KPL]) {
  const E* src = (const E*)d.src + b * d.s0;
  E* dst = (E*)d.dst + b * nout;
  E val[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    val[j] = t + T * j < nout && d.mode != 2 ? src[idx[j] * d.s1] : E(0);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int r = t + T * j;
    if (r >= nout) continue;
    const bool ok = sc[j] < kBig;
    dst[r] = d.mode == 2 ? (E)(ok ? sc[j] : kBig)
             : d.mode == 1 && !ok ? E(0)
                                  : val[j];
  }
}

__device__ __forceinline__ uint64_t mix(uint64_t h, int64_t x) {
  h = (h ^ (uint64_t)x) * 0xFF51AFD7ED558CCDull;
  return h ^ (h >> 31);
}

__device__ __forceinline__ bool same_tuple(const Keys& K, int64_t b, int i,
                                           int j) {
  bool same = true;
#pragma unroll
  for (int f = 0; f < kScore; ++f)
    same = same && load(K.f[f], b, i) == load(K.f[f], b, j);
  return same;
}

__device__ __forceinline__ bool accept(int64_t La, int minlength, int t5v,
                                       int t3v, int nmm_trim, int cn, int d) {
  const int64_t span = La - t5v - t3v;
  bool ok = span > minlength;
  ok = ok && (span - nmm_trim) - 3 * (int64_t)nmm_trim >= 0;
  ok = ok && nmm_trim <= d;
  ok = ok && !(t5v == 0 && t3v == 0 && cn <= d);
  return ok;
}

// The SE gates of read b (its row of NW warps; red: the row's scratch):
// top is the ranked best score (BIG where none), np the read's npaths,
// kind0 the kind of rank 0.
template <int NW>
__device__ void se_epilogue(const SeArgs& se, int64_t b, int top, int np,
                            int kind0, int subopt, int* red) {
  const int t = row_thread<NW>();
  const int La = se.lengths[b];
  const int spansize = ((se.k + se.interval - 1) / se.interval) * se.interval;
  const int auto_budget = max((La + se.interval - 1) / spansize - 2, 0);
  if (se.gate && t == 0) {
    const int budget =
        se.max_mismatches >= 0 ? se.max_mismatches : auto_budget;
    const int done = min(budget, np > 0 ? top : kBig);
    const bool safe = ((done + subopt < se.lane_gate) ||
                       (np > 0 && se.hbound[b] > done + subopt)) &&
                      se.ovf_bound[b] > done + subopt && !se.ovf_trunc[b];
    se.ovf_o[b] = se.ovf_in[b] && !safe;
  }
  if (!se.noop) {
    if (t == 0) se.noop_o[b] = 0;
    return;
  }
  const LaneArgs& la = se.la;
  const int done = min(auto_budget, np > 0 ? top : kBig);
  const int lastpos = La - se.k;
  const int minlength = min(La / 3, 40);
  int any = 0;
  for (int c = t; c < se.nc2; c += 32 * NW) {
    const int64_t x = b * se.nc2 + c;
    const int cn = la.cand_nmm[x];
    const bool valid = cn < kBig;
    const int d = done;
    const int mmi = d - se.indel_penalty_end;
    const int npos = la.npos[x], lowc = la.lowc[x], lbc = la.lbc[x];
    const bool ind_entry =
        npos > 0 && ((lowc >= 1 && npos - lowc <= mmi) ||
                     (npos - lbc >= 1 && lbc <= mmi));
    const bool ind = done >= se.indel_penalty_end && valid && ind_entry;
    const int t5 = la.t5[x], t3 = la.t3[x];
    const int pfirst = la.pfirst[x], plast = la.plast[x];
    const bool longb = la.present[x] && plast - pfirst > se.k;
    const bool st = pfirst >= se.interval;
    const bool et = plast < lastpos - se.interval;
    const int lt5 = st ? t5 : 0, lt3 = et ? t3 : 0;
    const int nmm_long = st && et ? la.nmm_tt[x]
                         : st     ? la.nmm_t50[x]
                         : et     ? la.nmm_0t3[x]
                                  : npos;
    const bool v_long =
        longb && accept(La, minlength, lt5, lt3, nmm_long, cn, d);
    const bool c1 = npos <= d || la.cle[x] <= d;
    const bool c2 = npos <= d || la.clt[x] >= npos - d;
    const bool v1 =
        !longb && c1 && accept(La, minlength, 0, t3, la.nmm_0t3[x], cn, d);
    const bool v2 =
        !longb && c2 && accept(La, minlength, t5, 0, la.nmm_t50[x], cn, d);
    const bool term =
        done >= se.terminal_threshold && valid && (v_long || v1 || v2);
    se.ind_o[x] = ind;
    se.term_o[x] = term;
    any |= ind || term;
  }
  any = row_sum<NW>(any, red);
  if (t == 0) se.noop_o[b] = np == 1 && kind0 == kKindSub && !any;
}

template <int KPL, int NW>
__global__ void __launch_bounds__(32 * NW) rank_hits_kernel(
    Keys K, Fields F, int32_t* __restrict__ npaths_o, SeArgs se, int use_se,
    int n, int nout, int subopt, int apply_optimal) {
  constexpr int T = 32 * NW;  // threads of the row
  constexpr int N = T * KPL;
  __shared__ uint64_t sk[N];
  __shared__ int32_t s_score[N];
  __shared__ uint32_t s_left[N];
  __shared__ uint8_t s_minus[N];
  __shared__ int red[32];
  uint32_t* sk32 = (uint32_t*)sk;
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;

  // 1. read the key fields (candidate t + T r in slot r) into the tuple
  // hash, and score, left and !plusp into shared memory
  uint64_t h[KPL];
  int64_t x[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) h[r] = 0x9E3779B97F4A7C15ull;
#pragma unroll 1
  for (int f = 0; f <= kScore; ++f) {
    load_strided<KPL, T>(K.f[f], b, t, n, x);
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = t + T * r;
      if (f < kScore) h[r] = mix(h[r], x[r]);
      if (i >= n) continue;
      if (f == kPlus) s_minus[i] = x[r] == 0;
      if (f == kLeft) {
        if (x[r] < 0 || x[r] > 0xFFFFFFFFll) __trap();
        s_left[i] = (uint32_t)x[r];
      }
      if (f == kScore) {
        if (x[r] < 0 || x[r] >= (1 << 22)) __trap();
        s_score[i] = (int32_t)x[r];
      }
    }
  }

  // 2. dedup: the key (23 bits of the hash) << 9 | index groups equal
  // tuples, and hash collisions, in runs ordered by index
  uint32_t d[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = t + T * r;
    d[r] = i < n ? (uint32_t)(h[r] >> 41) << 9 | (uint32_t)i : 0xFFFFFFFFu;
  }
  row_sort<uint32_t, KPL, NW>(d, sk32);
#pragma unroll
  for (int r = 0; r < KPL; ++r) sk32[t * KPL + r] = d[r];
  row_sync<NW>();  // also orders score, left and !plusp before their reads
  int sc[KPL];
  uint32_t best = 0xFFFFFFFFu;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int p = t * KPL + r;
    sc[r] = kBig;
    if (p >= n) continue;
    const int i = (int)(d[r] & 511);
    const int s = s_score[i];
    // a duplicate matters only below BIG (the many empty candidates of a
    // row, all alike and all at BIG, are not compared)
    bool dup = false;
    const uint32_t hh = d[r] >> 9;
    for (int q = p - 1; s < kBig && q >= 0 && !dup && (sk32[q] >> 9) == hh;
         --q)
      dup = same_tuple(K, b, (int)(sk32[q] & 511), i);
    sc[r] = dup ? kBig : s;
    best = min(best, (uint32_t)sc[r]);
  }
  best = row_extreme<NW>(best, false, red);

  // 3. the optimal filter and the ranking key
  uint64_t v[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int p = t * KPL + r;
    if (p >= n) {
      v[r] = ~0ull;
      continue;
    }
    const int i = (int)(d[r] & 511);
    int s = sc[r];
    if (apply_optimal && (int64_t)s > (int64_t)best + subopt) s = kBig;
    v[r] = (uint64_t)s << 42 | (uint64_t)s_left[i] << 10 |
           (uint64_t)s_minus[i] << 9 | (uint64_t)i;
  }
  row_sync<NW>();  // every thread is done with the dedup keys
  row_sort<uint64_t, KPL, NW>(v, sk);
#pragma unroll
  for (int r = 0; r < KPL; ++r) sk[t * KPL + r] = v[r];
  row_sync<NW>();

  // 4. the ranked fields: rank t + T j in slot j, field by field
  int idx[KPL], rsc[KPL];
  int np = 0;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int r = t + T * j;
    const uint64_t key = r < nout ? sk[r] : ~0ull;
    idx[j] = (int)(key & 511);
    rsc[j] = r < nout ? (int)(key >> 42) : kBig;
    np += r < nout && rsc[j] < kBig;
  }
#pragma unroll 1
  for (int f = 0; f < F.n; ++f) {
    const FieldDesc& fd = F.f[f];
    switch (fd.esize) {
      case 1:
        gather_typed<uint8_t, KPL, T>(fd, b, t, nout, idx, rsc);
        break;
      case 4:
        gather_typed<uint32_t, KPL, T>(fd, b, t, nout, idx, rsc);
        break;
      default:
        gather_typed<uint64_t, KPL, T>(fd, b, t, nout, idx, rsc);
    }
  }
  np = row_sum<NW>(np, red);
  if (t == 0) npaths_o[b] = np;
  if (!use_se) return;
  const uint64_t k0 = sk[0];
  const int top = min((int)(k0 >> 42), kBig);
  const int kind0 = (int)load(K.f[kKind], b, (int)(k0 & 511));
  se_epilogue<NW>(se, b, top, np, kind0, subopt, red);
}

template <int KPL, int NW>
void launch_rank(const Keys& K, const Fields& F, int32_t* npaths,
                 const SeArgs& se, int use_se, int B, int n, int nout,
                 int subopt, int apply_optimal, cudaStream_t stream) {
  rank_hits_kernel<KPL, NW><<<B, 32 * NW, 0, stream>>>(
      K, F, npaths, se, use_se, n, nout, subopt, apply_optimal);
}

bool read_desc(const int64_t* src, FieldDesc* d) {
  *d = FieldDesc{src[0], src[1], src[2], src[3], src[4], src[5]};
  return d->src != 0 && (d->esize == 1 || d->esize == 4 || d->esize == 8);
}

}  // namespace

// keys: kNKeys descriptors of 6 int64 (source, 0, s0, s1, esize, 0) in
// the order kind, split, split2, mid, right, plusp, left, score; fields:
// nf descriptors (source, destination, s0, s1, esize, mode).
extern "C" int gsnap_rank_hits(
    const int64_t* keys, const int64_t* fields, int nf, void* npaths,
    const void* lengths, const void* ovf_in, const void* ovf_trunc,
    const void* ovf_bound, const void* hbound, void* ovf_o,
    const void* cand_nmm, const void* npos, const void* t5, const void* t3,
    const void* lowc, const void* lbc, const void* cle, const void* clt,
    const void* pfirst, const void* plast, const void* present,
    const void* nmm_tt, const void* nmm_0t3, const void* nmm_t50,
    void* noop_o, void* ind_o, void* term_o, int B, int n, int nout,
    int subopt, int apply_optimal, int use_se, int gate, int lane_gate,
    int max_mismatches, int noop, int nc2, int k, int interval,
    int indel_penalty_end, int terminal_threshold, void* stream) {
  if (n < 1 || n > kMaxCand || nout < 1 || nout > n || nf < 0 ||
      nf > kMaxFields || npaths == nullptr)
    return (int)cudaErrorInvalidValue;
  Keys K;
  Fields F;
  for (int f = 0; f < kNKeys; ++f)
    if (!read_desc(keys + 6 * f, &K.f[f])) return (int)cudaErrorInvalidValue;
  F.n = nf;
  for (int f = 0; f < nf; ++f)
    if (!read_desc(fields + 6 * f, &F.f[f]) || F.f[f].dst == 0 ||
        F.f[f].mode < 0 || F.f[f].mode > 2)
      return (int)cudaErrorInvalidValue;
  if (use_se && (lengths == nullptr || k < 1 || interval < 1 ||
                 noop_o == nullptr))
    return (int)cudaErrorInvalidValue;
  if (use_se && gate && (ovf_in == nullptr || ovf_o == nullptr))
    return (int)cudaErrorInvalidValue;
  if (use_se && noop && (present == nullptr || ind_o == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  SeArgs se{(const int32_t*)lengths,
            (const uint8_t*)ovf_in,
            (const uint8_t*)ovf_trunc,
            (const int32_t*)ovf_bound,
            (const int32_t*)hbound,
            (uint8_t*)ovf_o,
            LaneArgs{(const int32_t*)cand_nmm, (const int32_t*)npos,
                     (const int32_t*)t5, (const int32_t*)t3,
                     (const int32_t*)lowc, (const int32_t*)lbc,
                     (const int32_t*)cle, (const int32_t*)clt,
                     (const int32_t*)pfirst, (const int32_t*)plast,
                     (const uint8_t*)present, (const int32_t*)nmm_tt,
                     (const int32_t*)nmm_0t3, (const int32_t*)nmm_t50},
            (uint8_t*)noop_o,
            (uint8_t*)ind_o,
            (uint8_t*)term_o,
            gate,
            lane_gate,
            max_mismatches,
            noop,
            nc2,
            k,
            interval,
            indel_penalty_end,
            terminal_threshold};
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* np = (int32_t*)npaths;
  // N = n rounded up to a power of two (>= 32): one warp up to N = 256,
  // four at N = 512
  if (n <= 32)
    launch_rank<1, 1>(K, F, np, se, use_se, B, n, nout, subopt,
                      apply_optimal, s);
  else if (n <= 64)
    launch_rank<2, 1>(K, F, np, se, use_se, B, n, nout, subopt,
                      apply_optimal, s);
  else if (n <= 128)
    launch_rank<4, 1>(K, F, np, se, use_se, B, n, nout, subopt,
                      apply_optimal, s);
  else if (n <= 256)
    launch_rank<8, 1>(K, F, np, se, use_se, B, n, nout, subopt,
                      apply_optimal, s);
  else
    launch_rank<4, 4>(K, F, np, se, use_se, B, n, nout, subopt,
                      apply_optimal, s);
  return (int)cudaGetLastError();
}
