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

// Lanes as rows: the word (32 query bits) of one row for the queries
// [q0, q0 + 32) of a predicate matrix held as (lo, hi) pairs in shared
// memory, pairs[c * q_stride + q].  Each lane compares its own row's
// column values; all lanes read the same pair at once (a broadcast), so
// no shuffle or ballot is needed to pack the word.  A row that is not
// ``live`` (past the table or invalid) gives 0.
__device__ __forceinline__ uint32_t row_word(const int32_t* __restrict__ cols,
                                             int64_t col_stride, int64_t row,
                                             bool live, const int2* pairs,
                                             int q_stride, int q0, int C) {
  if (!live) return 0u;
  uint32_t bad = 0u;
  for (int c = 0; c < C; ++c) {
    const int32_t x = cols[c * col_stride + row];
    const int2* p = pairs + c * q_stride + q0;
#pragma unroll
    for (int b = 0; b < kWarp; ++b) {
      const int2 r = p[b];
      bad |= (x < r.x || x > r.y) ? (1u << b) : 0u;
    }
  }
  return ~bad;
}

// The first index in [0, n) of a non-decreasing array whose value is
// >= v (n if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ a,
                                           int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
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

// One lane: the max row of bucket b (B entries) whose key equals `key`
// and whose row id is live (>= 0), or -1 — probe_bucket's answer by a
// binary search, for buckets laid out as storage.build_key_partitions
// lays them out: live rows first, sorted by key with row ids ascending
// among equal keys, then invalid rows and padding (row -1).  The
// predicate "row >= 0 && key <= k" then holds on a prefix of the bucket,
// and the last entry of that prefix is the max live row of key k when its
// key is k.  log2(B) + 1 steps of two independent loads each.
__device__ __forceinline__ int search_bucket(const int32_t* __restrict__ bkeys,
                                             const int32_t* __restrict__ brows,
                                             int64_t b, int B, int32_t key) {
  const int32_t* k = bkeys + b * B;
  const int32_t* r = brows + b * B;
  int lo = 0, hi = B;        // the predicate holds on [0, lo), not on [hi, B)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t row = __ldg(r + mid), kk = __ldg(k + mid);
    if (row >= 0 && kk <= key) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return -1;
  return __ldg(k + lo - 1) == key ? __ldg(r + lo - 1) : -1;
}

}  // namespace shareddb
