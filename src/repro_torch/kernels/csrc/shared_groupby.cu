// Shared group-by, phase 1, for Hopper: per group g and query q, the
// count of rows of group g whose bit q is set and the sum of their value.
//
// Replaces repro/kernels/shared_groupby.py:66, shared_groupby_pallas
// (body _kernel), which computes onehot(group)^T @ unpack(mask) on the
// MXU and so does G times the useful work.  Here the work is the number
// of set bits: each (row, word) pair walks the SET bits of its word
// (__ffs) and adds atomically into count[g, q] / sum[g, q].  Rows with an
// empty word or a group code outside [0, G) add nothing.
//
// What bounds it: bytes — the one write of the [2, G, Q] float outputs
// and the one read of the T x (W + 2) int32 inputs (TPC-W's steady beat:
// 12 048 x 96 x 2 x 4 B = 9.25 MB out, 16 384 x 5 x 4 B = 0.33 MB in).
//
// What the design does about that: the outputs are written once, by the
// kernel itself, with no separate fills.  One persistent cooperative
// launch (one block of 512 threads a streaming multiprocessor: the
// barrier waits on the fewest blocks, and at a quarter of the co-resident
// blocks two launches in flight on two streams are both resident) runs
// two phases.  Each thread first reads its first (row, word) —
// mask word, group, value — so those loads overlap the stores; every
// block zeroes its own stripe of the packed buffer in 16-byte stores (a
// stripe is whole 128-byte lines; the last one is ragged and some blocks
// may get none); one grid barrier (cooperative_groups, whose workspace
// belongs to the launch, so two launches on two streams, or replays of a
// captured graph, never share it); then the set-bit walk as a
// grid-stride loop whose adds (atomicAdd with the result unused: RED, not
// ATOM) land on lines that the first phase has just left in L2.
//
// Exactness: counts are sums of 1.0f, exact below 2^24.  Sums are float
// adds in an order that changes from run to run; TPC-W's aggregated
// value (ol_qty, 1..9) keeps every partial sum an integer below 2^24, so
// they are exact too.  Other data gets float rounding in atomic order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kThreads = 512;   // shared_groupby.THREADS

// One (row, word) pair: its mask word, and the row's group and value
// where the word has set bits and the group is in [0, G) (else m = 0).
struct Item {
  uint32_t m;
  int g, w;
  float v;
};

__device__ __forceinline__ Item load_item(const int32_t* __restrict__ codes,
                                          const int32_t* __restrict__ vals,
                                          const int32_t* __restrict__ mask,
                                          int64_t i, int W, int G) {
  Item it{uint32_t(mask[i]), 0, 0, 0.f};
  if (it.m == 0) return it;
  const int64_t row = i / W;
  it.g = codes[row];
  if (it.g < 0 || it.g >= G) {
    it.m = 0;
    return it;
  }
  it.w = int(i - row * W);
  it.v = float(vals[row]);
  return it;
}

__global__ void __launch_bounds__(kThreads)
groupby_kernel(const int32_t* __restrict__ codes,
               const int32_t* __restrict__ vals,
               const int32_t* __restrict__ mask, float* __restrict__ out,
               int T, int W, int G, int64_t stripe) {
  const int64_t Q = int64_t(W) * kWarp;
  const int64_t GQ = int64_t(G) * Q;
  const int64_t n = int64_t(T) * W;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  Item it = i < n ? load_item(codes, vals, mask, i, W, G) : Item{};
  // phase 1: this block's stripe of the 2 G Q floats, 4 a store (Q is a
  // multiple of 32, so 2 G Q is a multiple of 4)
  const int64_t units = 2 * GQ / 4;
  const int64_t begin = int64_t(blockIdx.x) * stripe;
  const int64_t end = begin + stripe < units ? begin + stripe : units;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t u = begin + threadIdx.x; u < end; u += kThreads)
    out4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  cooperative_groups::this_grid().sync();
  // phase 2: the set bits of every (row, word)
  while (i < n) {
    if (it.m) {
      float* c = out + it.g * Q + it.w * kWarp;
      float* s = c + GQ;
      for (uint32_t m = it.m; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        atomicAdd(c + b, 1.0f);
        atomicAdd(s + b, it.v);
      }
    }
    i += stride;
    if (i < n) it = load_item(codes, vals, mask, i, W, G);
  }
}

}  // namespace
}  // namespace shareddb

// Blocks of groupby_kernel that one streaming multiprocessor holds at
// once (the cooperative grid's co-residency limit a SM); the wrapper asks
// once per process.
extern "C" int shareddb_groupby_blocks_per_sm(int* blocks) {
  using namespace shareddb;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, groupby_kernel, kThreads, 0));
}

// out: the packed [2, G, W*32] float buffer (counts, then sums), which the
// kernel zeroes itself; blocks and stripe from shared_groupby.launch_geometry.
extern "C" int shareddb_groupby(const int32_t* codes, const int32_t* vals,
                                const int32_t* mask, float* out, int T, int W,
                                int G, int blocks, int64_t stripe,
                                cudaStream_t stream) {
  using namespace shareddb;
  void* args[] = {&codes, &vals, &mask, &out, &T, &W, &G, &stripe};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(groupby_kernel), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return int(launched != cudaSuccess ? launched : last);
}
