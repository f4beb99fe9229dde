// Shared helpers of the SharedDB Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C launcher that takes device
// pointers, sizes and the CUDA stream, enqueues the kernel on that
// stream, never synchronises and never allocates, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// Bitmask words are 32-bit patterns (int32 on the PyTorch side): bit b of
// word w is query 32*w + b.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace shareddb {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// Conjunctive inclusive range predicate of one (row, query) pair:
// lo[c, q] <= cols[c, row] <= hi[c, q] for every predicated column c.
__device__ __forceinline__ bool range_match(const int32_t* __restrict__ cols,
                                            int64_t col_stride, int64_t row,
                                            const int32_t* __restrict__ lo,
                                            const int32_t* __restrict__ hi,
                                            int q_stride, int q, int C) {
  bool ok = true;
  for (int c = 0; c < C; ++c) {
    const int32_t x = cols[c * col_stride + row];
    ok = ok && x >= lo[c * q_stride + q] && x <= hi[c * q_stride + q];
  }
  return ok;
}

// The last index in [0, n) of an ascending array whose value is <= key,
// clipped to [0, n-1]: searchsorted(side="right") - 1 then clip.
__device__ __forceinline__ int route_bucket(const int32_t* __restrict__ bounds,
                                            int n, int32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bounds[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), n - 1);
}

// One warp: the max row of bucket b (B entries) whose key equals `key`
// and whose row id is live (>= 0), or -1.  All lanes get the result.
__device__ __forceinline__ int probe_bucket(const int32_t* __restrict__ bkeys,
                                            const int32_t* __restrict__ brows,
                                            int64_t b, int B, int32_t key,
                                            int lane) {
  const int32_t* k = bkeys + b * B;
  const int32_t* r = brows + b * B;
  int best = -1;
  for (int j = lane; j < B; j += kWarp) {
    const int32_t row = r[j];
    if (k[j] == key && row >= 0) best = max(best, row);
  }
  return __reduce_max_sync(kFullMask, best);
}

}  // namespace shareddb
