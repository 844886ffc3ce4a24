// Kernel K15: first and last seed query position per selected diagonal.
//
// Replaces gmap_gsnap_tpu/align/gsnap_se.py _qpos_ranges (:385), the
// reference's Segment querypos5 / querypos3 (stage1hr.c:9000): for each
// read b and selected diagonal d_sel[b, p], the min and max qpos over the
// seed slots w of the unsorted [B, W] seed grid whose diagonal equals it
// (2^30 and -1 where none does).  Empty seed slots carry the last usable
// oligo's qpos and d_sel may be INVALID_DIAG; the plain compare matches
// such slots exactly as this one does.
//
// Design: one warp per (read, selected diagonal), lanes stride over the W
// slots (coalesced), then a warp min / max reduction.  Bound: bytes — the
// grid's diagonals and qpos are read once per selected diagonal from L2;
// counted once (12 B per slot) they bound it far below the time taken.
#include "common.cuh"

namespace {

__global__ void qpos_ranges_kernel(const int64_t* __restrict__ diag,
                                   const int32_t* __restrict__ qpos,
                                   const int64_t* __restrict__ d_sel,
                                   int32_t* __restrict__ qp5,
                                   int32_t* __restrict__ qp3, int B, int W,
                                   int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * P) return;  // warp-uniform exit
  const int64_t b = warp / P;
  const int64_t d = d_sel[warp];
  const int64_t* dg = diag + b * W;
  const int32_t* qg = qpos + b * W;
  int lo = 1 << 30, hi = -1;
  for (int w = lane; w < W; w += 32) {
    if (dg[w] == d) {
      const int q = qg[w];
      lo = min(lo, q);
      hi = max(hi, q);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(GSNAP_FULL_MASK, lo, o));
    hi = max(hi, __shfl_xor_sync(GSNAP_FULL_MASK, hi, o));
  }
  if (lane == 0) {
    qp5[warp] = lo;
    qp3[warp] = hi;
  }
}

}  // namespace

extern "C" int gsnap_qpos_ranges(const void* diag, const void* qpos,
                                 const void* d_sel, void* qp5, void* qp3,
                                 int B, int W, int P, void* stream) {
  if ((int64_t)B * P == 0) return 0;
  constexpr int kThreads = 256;
  qpos_ranges_kernel<<<gsnap_blocks((int64_t)B * P * 32, kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(
      (const int64_t*)diag, (const int32_t*)qpos, (const int64_t*)d_sel,
      (int32_t*)qp5, (int32_t*)qp3, B, W, P);
  return (int)cudaGetLastError();
}
