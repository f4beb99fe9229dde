// Shared group-by, phase 1, for Hopper: per group g and query q, the
// count of rows of group g whose bit q is set and the sum of their value.
//
// Replaces repro/kernels/shared_groupby.py::shared_groupby_pallas (body
// _kernel), which computes onehot(group)^T @ unpack(mask) on the MXU and
// so does G times the useful work.  Here each (row, word) pair is one
// thread that walks the SET bits of its word (__ffs) and atomically adds
// into count[g, q] / sum[g, q] in device memory: the work is the number
// of set bits, not G*T*Q.  Rows with an empty word or a group code
// outside [0, G) add nothing.
//
// What bounds it: bytes — the G*Q float outputs (12 048 x 64 x 2 x 4 B =
// 6.2 MB on TPC-W) are zeroed and written, far more than the T*(W+2)
// inputs read.  The outputs live in global memory (too large for shared
// memory); the atomics hit L2.
//
// Exactness: counts are sums of 1.0f, exact below 2^24.  Sums are float
// adds in an order that changes from run to run; TPC-W's aggregated
// value (ol_qty, 1..9) keeps every partial sum an integer below 2^24, so
// they are exact too.  Other data gets float rounding in atomic order.
#include <algorithm>

#include "common.cuh"

namespace shareddb {
namespace {

__global__ void __launch_bounds__(256)
groupby_kernel(const int32_t* __restrict__ codes,
               const int32_t* __restrict__ vals,
               const int32_t* __restrict__ mask, float* __restrict__ count,
               float* __restrict__ sum, int T, int W, int G) {
  const int64_t Q = int64_t(W) * kWarp;
  const int64_t n = int64_t(T) * W;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    uint32_t m = uint32_t(mask[i]);
    if (m == 0) continue;
    const int64_t row = i / W;
    const int w = int(i % W);
    const int g = codes[row];
    if (g < 0 || g >= G) continue;
    const float v = float(vals[row]);
    float* c = count + g * Q + w * kWarp;
    float* s = sum + g * Q + w * kWarp;
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      atomicAdd(c + b, 1.0f);
      atomicAdd(s + b, v);
    }
  }
}

}  // namespace
}  // namespace shareddb

// count/sum must be zeroed by the caller.
extern "C" int shareddb_groupby(const int32_t* codes, const int32_t* vals,
                                const int32_t* mask, float* count, float* sum,
                                int T, int W, int G, cudaStream_t stream) {
  using namespace shareddb;
  const int64_t n = int64_t(T) * W;
  if (n == 0) return int(cudaGetLastError());
  const int blocks = int(std::min<int64_t>((n + 255) / 256, 132 * 32));
  groupby_kernel<<<blocks, 256, 0, stream>>>(codes, vals, mask, count, sum, T,
                                             W, G);
  return int(cudaGetLastError());
}
