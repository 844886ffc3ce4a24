// Kernel K18: candidate lists from a sharded positions array.
//
// Replaces gmap_gsnap_tpu/parallel/shard.py shard_index_lookup (:83), the
// JAX package's blueprint for genomes whose positions array outgrows one
// device: shard s owns global elements [s * shard_len, (s + 1) *
// shard_len), and read r's list is the cap elements from starts[r], read
// within the owner shard (owner = floor(starts[r] / shard_len) clipped to
// [0, nshards - 1], the element index clipped to the shard's last), with
// 0xFFFFFFFF past counts[r].
//
// A launch holds shards [row0, row0 + nrows) (`rows`, nrows x shard_len
// uint32): an entry whose owner shard it does not hold writes 0xFFFFFFFF,
// so the MIN over ranks that each hold their own shard is exact (one
// shard owns each element; parallel/shard.py all_reduce_min).
//
// One thread per output entry (r, j), j fastest: a warp's int64 stores
// are one run of consecutive addresses, and its reads of a list are
// consecutive words of one shard; starts / counts are read once a warp
// per read and served by L1 to the rest.  Bound: bytes, the outputs' 8
// bytes an entry dominating (a gather with an owner test: no arithmetic
// to speak of).
#include "common.cuh"

namespace {

__global__ void shard_index_lookup_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, int64_t* __restrict__ out, int R,
    int cap, int64_t shard_len, int nshards, int row0, int nrows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)R * cap) return;
  const int r = (int)(i / cap), j = (int)(i - (int64_t)r * cap);
  const int64_t s = __ldg(starts + r);
  // floor division: a negative start belongs to shard 0 after the clip,
  // at its remainder, as JAX's // and % give
  int64_t owner = s >= 0 ? s / shard_len : -((-s + shard_len - 1) / shard_len);
  const int64_t local = s - owner * shard_len;
  owner = owner < 0 ? 0 : (owner > nshards - 1 ? nshards - 1 : owner);
  int64_t v = GSNAP_INVALID_DIAG;
  if (j < __ldg(counts + r) && owner >= row0 && owner < row0 + nrows) {
    int64_t idx = local + j;
    idx = idx > shard_len - 1 ? shard_len - 1 : idx;
    v = __ldg(rows + (owner - row0) * shard_len + idx);
  }
  out[i] = v;
}

}  // namespace

extern "C" int gsnap_shard_index_lookup(const void* rows, const void* starts,
                                        const void* counts, void* out, int R,
                                        int cap, int64_t shard_len,
                                        int nshards, int row0, int nrows,
                                        void* stream) {
  if (R < 0 || cap < 0 || shard_len < 1 || nshards < 1 || row0 < 0 ||
      nrows < 1 || row0 + nrows > nshards)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)R * cap;
  if (n == 0) return 0;
  const int threads = 256;
  shard_index_lookup_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)starts, (const int32_t*)counts,
      (int64_t*)out, R, cap, shard_len, nshards, row0, nrows);
  return (int)cudaGetLastError();
}
