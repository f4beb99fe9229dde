// ClockScan shared scan for Hopper: every query's conjunctive range
// predicate against every row, bit-packed 32 queries to a word.
//
// Replaces repro/kernels/clockscan.py::clockscan_pallas (body _kernel).
// out[t, w] bit b = valid[t] && AND_c lo[c, 32w+b] <= cols[c, t] <= hi[c, 32w+b].
//
// What bounds it: bytes.  It reads C*T column values and writes T*Q/32
// words, and does C*T*Q compares; at TPC-W shapes (Q <= 416, C <= 3) the
// word stores dominate.  Design: the block keeps the whole lo/hi matrix
// (2*C*Q int32, a few KB) in shared memory; one warp owns one row at a
// time and its 32 lanes are the 32 query bits of a word, so
// __ballot_sync packs a word in one instruction.  Lane w%32 keeps word w
// in a register and the warp stores up to 32 consecutive words at once, a
// coalesced row segment.  Invalid rows give zero words.
#include <algorithm>

#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
clockscan_kernel(const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ out, int C, int T, int Q) {
  extern __shared__ int32_t smem[];
  int32_t* s_lo = smem;
  int32_t* s_hi = smem + C * Q;
  for (int i = threadIdx.x; i < C * Q; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int W = Q / kWarp;
  for (int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       row < T; row += int64_t(gridDim.x) * kWarpsPerBlock) {
    const bool v = valid[row] != 0;
    uint32_t mine = 0;
    for (int w = 0; w < W; ++w) {
      const bool ok =
          v && range_match(cols, T, row, s_lo, s_hi, Q, w * kWarp + lane, C);
      const uint32_t word = __ballot_sync(kFullMask, ok);
      if (w % kWarp == lane) mine = word;
      if (w % kWarp == kWarp - 1 || w == W - 1) {
        const int base = w - w % kWarp;
        if (base + lane <= w) out[row * W + base + lane] = int32_t(mine);
      }
    }
  }
}

}  // namespace
}  // namespace shareddb

extern "C" const char* shareddb_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

extern "C" int shareddb_clockscan(const int32_t* cols, const int32_t* lo,
                                  const int32_t* hi, const uint8_t* valid,
                                  int32_t* out, int C, int T, int Q,
                                  cudaStream_t stream) {
  using namespace shareddb;
  if (T == 0) return int(cudaGetLastError());
  const int blocks =
      std::min((T + kWarpsPerBlock - 1) / kWarpsPerBlock, 132 * 32);
  const size_t smem = size_t(2) * C * Q * sizeof(int32_t);
  clockscan_kernel<<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      cols, lo, hi, valid, out, C, T, Q);
  return int(cudaGetLastError());
}
