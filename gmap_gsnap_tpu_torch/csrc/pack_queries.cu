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
//     (lmax - 1 - i with `uniform`, a flip), code ^ 3; positions whose
//     source is < 0 get code 0 and flag 1; the source is clipped to
//     [0, L - 1], as take_along_axis clips it;
//   * queries_rev: the packed form of codes_rc / nflags_rc.
//
// Design: one thread per (read, output word): it reads the 16 bases of
// its forward word and the 16 source bases of its reverse word, writes
// both words and the 16 reverse-complement bases.  A memory-bound pass.
// Bound: bytes — 2 x B x L bytes in, 2 x B x L bytes and 4 x 8 x B x W
// bytes out.
#include "common.cuh"

namespace {

__global__ void pack_queries_kernel(const uint8_t* __restrict__ codes,
                                    const bool* __restrict__ nflags,
                                    const int32_t* __restrict__ lengths,
                                    int64_t* __restrict__ fwd_codes16,
                                    int64_t* __restrict__ fwd_nflags16,
                                    uint8_t* __restrict__ codes_rc,
                                    bool* __restrict__ nflags_rc,
                                    int64_t* __restrict__ rev_codes16,
                                    int64_t* __restrict__ rev_nflags16,
                                    int B, int L, int W, int uniform) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * W) return;
  const int64_t b = t / W;
  const int w = (int)(t % W);
  const int len = lengths[b];
  const uint8_t* c = codes + b * L;
  const bool* f = nflags + b * L;
  uint32_t fc = 0, ff = 0, rc = 0, rf = 0;
  for (int s = 0; s < 16; ++s) {
    const int i = w * 16 + s;
    uint32_t code_f = 0, flag_f = 1, code_r = 0, flag_r = 1;
    if (i < L) {
      code_f = c[i];
      flag_f = (f[i] || i >= len) ? 1u : 0u;
      const int src = uniform ? L - 1 - i : len - 1 - i;
      const int clip = min(max(src, 0), L - 1);
      uint8_t out_c = 0;
      bool out_f = true;
      if (src >= 0) {
        out_c = (uint8_t)(c[clip] ^ 3);
        out_f = f[clip];
      }
      codes_rc[b * L + i] = out_c;
      nflags_rc[b * L + i] = out_f;
      code_r = out_c;
      flag_r = (out_f || i >= len) ? 1u : 0u;
    }
    fc |= code_f << (2 * s);
    ff |= flag_f << s;
    rc |= code_r << (2 * s);
    rf |= flag_r << s;
  }
  fwd_codes16[t] = (int64_t)fc;
  fwd_nflags16[t] = (int64_t)ff;
  rev_codes16[t] = (int64_t)rc;
  rev_nflags16[t] = (int64_t)rf;
}

}  // namespace

extern "C" int gsnap_pack_queries(const void* codes, const void* nflags,
                                  const void* lengths, void* fwd_codes16,
                                  void* fwd_nflags16, void* codes_rc,
                                  void* nflags_rc, void* rev_codes16,
                                  void* rev_nflags16, int B, int L, int W,
                                  int uniform, void* stream) {
  if (L < 1 || W != (L + 15) / 16) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  constexpr int kThreads = 256;
  pack_queries_kernel<<<gsnap_blocks((int64_t)B * W, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const bool*)nflags, (const int32_t*)lengths,
      (int64_t*)fwd_codes16, (int64_t*)fwd_nflags16, (uint8_t*)codes_rc,
      (bool*)nflags_rc, (int64_t*)rev_codes16, (int64_t*)rev_nflags16, B, L,
      W, uniform);
  return (int)cudaGetLastError();
}
