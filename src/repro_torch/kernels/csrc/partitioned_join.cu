// Partitioned shared join for Hopper: route, probe and intersect in one
// kernel.
//
// Replaces repro/kernels/partitioned_join.py::partitioned_join_pallas
// (body _kernel).  The reference gathers a [Tl, B] candidate pane per
// left row in XLA before its kernel; here nothing is materialised.  One
// warp owns one left row:
//   1. route: binary search of the row's key over the P bucket bounds
//      (the last bucket whose bound <= key, clipped);
//   2. probe: the warp scans that ONE bucket's B (key, row) pairs, 32 at
//      a time, and reduces the max row with an equal key (-1 if none;
//      duplicates resolve to the max row id, as in the reference);
//   3. intersect: the lanes write mask_l[i, w] & mask_r[rid, w] (0 when
//      unmatched) for the row's W words.
// What bounds it: bytes — the left keys and masks read, the right masks
// gathered and the rids and masks written.  The bucket arrays (P*B*8 B,
// ~100 KB on TPC-W) stay in L1/L2 across rows.
#include <algorithm>

#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
partitioned_join_kernel(const int32_t* __restrict__ keys_l,
                        const int32_t* __restrict__ mask_l,
                        const int32_t* __restrict__ bkeys,
                        const int32_t* __restrict__ brows,
                        const int32_t* __restrict__ bounds,
                        const int32_t* __restrict__ mask_r,
                        int32_t* __restrict__ rid_out,
                        int32_t* __restrict__ mask_out, int Tl, int W, int P,
                        int B, int Tr) {
  const int lane = threadIdx.x % kWarp;
  for (int64_t i = int64_t(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       i < Tl; i += int64_t(gridDim.x) * kWarpsPerBlock) {
    const int32_t key = keys_l[i];
    const int b = route_bucket(bounds, P, key);
    const int rid = probe_bucket(bkeys, brows, b, B, key, lane);
    if (lane == 0) rid_out[i] = rid;
    const int64_t r = min(max(rid, 0), Tr - 1);
    for (int w = lane; w < W; w += kWarp) {
      mask_out[i * W + w] = rid >= 0 ? (mask_l[i * W + w] & mask_r[r * W + w])
                                     : 0;
    }
  }
}

}  // namespace
}  // namespace shareddb

extern "C" int shareddb_partitioned_join(
    const int32_t* keys_l, const int32_t* mask_l, const int32_t* bkeys,
    const int32_t* brows, const int32_t* bounds, const int32_t* mask_r,
    int32_t* rid_out, int32_t* mask_out, int Tl, int W, int P, int B, int Tr,
    cudaStream_t stream) {
  using namespace shareddb;
  if (Tl == 0) return int(cudaGetLastError());
  const int blocks =
      std::min((Tl + kWarpsPerBlock - 1) / kWarpsPerBlock, 132 * 32);
  partitioned_join_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      keys_l, mask_l, bkeys, brows, bounds, mask_r, rid_out, mask_out, Tl, W,
      P, B, Tr);
  return int(cudaGetLastError());
}
