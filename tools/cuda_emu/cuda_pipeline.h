// CPU emulation of <cuda_pipeline.h>'s asynchronous copies (see
// cuda_runtime.h): a copy is done at once, so commit and wait do nothing.
#pragma once
#include <cstddef>
#include <cstring>

// n bytes to dst, of which the last zfill are zeros and not read
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, n - zfill);
  std::memset(static_cast<char*>(dst) + (n - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
