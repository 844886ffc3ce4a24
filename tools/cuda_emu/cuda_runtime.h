// CPU emulation of the CUDA subset that the port's kernels use, for
// rehearsing a kernel's logic with g++ where there is no nvcc or card:
// one std::thread per CUDA thread, blocks run one after another, a
// std::barrier for __syncthreads and a per-warp exchange buffer and
// barrier for the warp collectives.  See tools/cuda_emu/emu_build.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) alignas(n)

struct uint4 {
  unsigned x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t buf[32];
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
};
inline EmuBlock* emu_block = nullptr;
inline std::vector<unsigned char> emu_dyn;
inline std::mutex emu_mu;

inline int emu_lane() { return threadIdx.x & 31; }
inline EmuWarp& emu_warp() { return *emu_block->warps[threadIdx.x >> 5]; }

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp().bar.arrive_and_wait(); }
inline void __trap() { std::fprintf(stderr, "emu: __trap\n"); std::abort(); }

template <class T> inline uint64_t emu_bits(T v) { uint64_t b = 0; std::memcpy(&b, &v, sizeof(T)); return b; }
template <class T> inline T emu_from(uint64_t b) { T v; std::memcpy(&v, &b, sizeof(T)); return v; }

template <class T> inline T emu_shfl(T v, int src) {
  EmuWarp& w = emu_warp();
  w.buf[emu_lane()] = emu_bits(v);
  w.bar.arrive_and_wait();
  T r = (src >= 0 && src < 32) ? emu_from<T>(w.buf[src]) : v;
  w.bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_shfl(v, emu_lane() ^ m); }
template <class T> inline T __shfl_sync(unsigned, T v, int s) { return emu_shfl(v, s); }
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
  int s = emu_lane() - d; return emu_shfl(v, s < 0 ? emu_lane() : s); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int d) {
  int s = emu_lane() + d; return emu_shfl(v, s > 31 ? emu_lane() : s); }

template <class T, class F> inline T emu_reduce(T v, F f) {
  EmuWarp& w = emu_warp();
  w.buf[emu_lane()] = emu_bits(v);
  w.bar.arrive_and_wait();
  T r = emu_from<T>(w.buf[0]);
  for (int i = 1; i < 32; ++i) r = f(r, emu_from<T>(w.buf[i]));
  w.bar.arrive_and_wait();
  return r;
}
template <class T> inline T __reduce_add_sync(unsigned, T v) { return emu_reduce(v, [](T a, T b) { return (T)(a + b); }); }
template <class T> inline T __reduce_min_sync(unsigned, T v) { return emu_reduce(v, [](T a, T b) { return a < b ? a : b; }); }
template <class T> inline T __reduce_max_sync(unsigned, T v) { return emu_reduce(v, [](T a, T b) { return a < b ? b : a; }); }
inline unsigned __reduce_or_sync(unsigned, unsigned v) { return emu_reduce(v, [](unsigned a, unsigned b) { return a | b; }); }
inline unsigned __ballot_sync(unsigned, int p) {
  EmuWarp& w = emu_warp();
  w.buf[emu_lane()] = p != 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)w.buf[i] << i;
  w.bar.arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) { return __ballot_sync(m, p) == 0xFFFFFFFFu; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  sh &= 31; return sh ? (lo >> sh) | (hi << (32 - sh)) : lo; }
template <class T> inline T __ldg(const T* p) { return *p; }
// byte n of the result: byte (s >> 4n) & 7 of y:x (x bytes 0-3, y 4-7);
// with bit 3 of the nibble set, that byte's sign bit replicated
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) {
    const unsigned sel = (s >> (4 * n)) & 0xF;
    unsigned byte = (unsigned)(v >> (8 * (sel & 7))) & 0xFF;
    if (sel & 8) byte = (byte & 0x80) ? 0xFF : 0;
    r |= byte << (8 * n);
  }
  return r;
}
// float32 with one rounding each (emu_build.py compiles with
// -ffp-contract=off, so no product is fused into a sum)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// int <-> float32 to nearest even; the conversion back saturates
inline float __int2float_rn(int x) { return (float)x; }
inline int __float2int_rn(float f) {
  if (f != f) return 0;
  const float r = std::nearbyint(f);
  return r >= 2147483648.0f ? INT_MAX : r <= -2147483648.0f ? INT_MIN : (int)r;
}
template <class T> inline T atomicAdd(T* p, T v) { std::lock_guard<std::mutex> g(emu_mu); T o = *p; *p = o + v; return o; }
template <class T> inline T atomicMin(T* p, T v) { std::lock_guard<std::mutex> g(emu_mu); T o = *p; if (v < o) *p = v; return o; }
template <class T> inline T atomicMax(T* p, T v) { std::lock_guard<std::mutex> g(emu_mu); T o = *p; if (v > o) *p = v; return o; }
using std::max;
using std::min;
inline long long min(long long a, int b) { return a < b ? a : b; }

template <class F>
inline void emu_launch(dim3 grid, dim3 block, size_t smem, F body) {
  gridDim = grid;
  blockDim = block;
  emu_dyn.assign(smem + 64, 0xCD);
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(block.x);
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w) blk.warps.push_back(std::make_unique<EmuWarp>());
    emu_block = &blk;
    std::vector<std::thread> th;
    for (unsigned tx = 0; tx < block.x; ++tx)
      th.emplace_back([&, tx, bx] { threadIdx = dim3(tx); blockIdx = dim3(bx); body(); });
    for (auto& t : th) t.join();
  }
}
