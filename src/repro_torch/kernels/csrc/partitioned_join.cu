// Partitioned shared join for Hopper: route, probe and intersect in one
// kernel.
//
// Replaces repro/kernels/partitioned_join.py::partitioned_join_pallas
// (body _kernel).  The reference gathers a [Tl, B] candidate pane per
// left row in XLA before its kernel; here nothing is materialised.
//
// Precondition: the buckets are laid out as storage.build_key_partitions
// lays them out (its only source on the path): in each bucket the live
// rows come first, sorted by key with row ids ascending among equal keys,
// then invalid rows and padding with row -1; `bounds` holds each bucket's
// first key, ascending.  The kernel does not check it.
//
// A warp owns 32 consecutive left rows, on a persistent grid (at most
// kernels.BLOCKS_PER_SM blocks an SM, partitioned_join.py::grid_blocks)
// that walks the rows' chunks a grid stride apart:
//   1. route: each LANE binary-searches its own row's key over the P
//      bucket bounds (common.cuh route_bucket: the last bucket whose
//      bound <= key, clipped);
//   2. probe: each lane binary-searches that bucket for the last entry
//      with row >= 0 and key <= k (common.cuh search_bucket, log2 B + 1
//      steps); its row is the answer when its key is k, else -1
//      (duplicates resolve to the max row id, as in the reference);
//   3. intersect: the chunk's 32 rows x W words of mask_l and of the
//      output are one contiguous range, which the lanes walk together,
//      kBatch words a lane at a time with every load of a batch issued
//      before its first use (the first batch's left words before the
//      searches); each word takes its row's rid from the owning lane by
//      shuffle and is mask_l & mask_r[rid] (0 when unmatched), so every
//      load and store of the left side is coalesced.
// What bounds it: bytes — the left keys and masks read, the right masks
// gathered and the rids and masks written (~13 MB a call on TPC-W's
// order_line).  The previous design gave a warp to each row and scanned
// the whole bucket (~150 warp instructions a row); this one spends ~20
// lane steps a row on the searches, whose loads (bounds, bucket keys and
// rows: ~300 KB at most on TPC-W) hit the read-only cache and L2, and
// keeps every lane busy in the intersect.  At TPC-W's sizes every warp
// holds about one chunk, so a call takes about one chain of dependent
// loads (key, route, search, gather) beyond the launch: it stays ~3x its
// byte bound on an H100 (PERF.md section 6).
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 8;        // intersect words a lane has in flight

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
  const int64_t chunks = (int64_t(Tl) + kWarp - 1) / kWarp;
  for (int64_t c = int64_t(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       c < chunks; c += int64_t(gridDim.x) * kWarpsPerBlock) {
    const int64_t r0 = c * kWarp;
    const int n = int(min(int64_t(kWarp), Tl - r0));   // rows of the chunk
    const int64_t base = r0 * W;
    const int nw = n * W;
    // the first batch of left words needs no rid: in flight during the
    // searches
    int32_t left[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = u * kWarp + lane;
      left[u] = e < nw ? mask_l[base + e] : 0;
    }
    int rid = -1;
    if (lane < n) {
      const int32_t key = keys_l[r0 + lane];
      rid = search_bucket(bkeys, brows, route_bucket(bounds, P, key), B,
                          key);
      rid_out[r0 + lane] = rid;
    }
    // the chunk's n x W words, kBatch words a lane at a time (warp-uniform
    // trips), each taking its row's rid from the owning lane
    for (int e0 = 0; e0 < nw; e0 += kBatch * kWarp) {
      if (e0 > 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kWarp + lane;
          left[u] = e < nw ? mask_l[base + e] : 0;
        }
      }
      int32_t right[kBatch];       // 0 for an unmatched row: its words are 0
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kWarp + lane;
        const int lr = min(int(unsigned(e) / unsigned(W)), n - 1);
        const int src = __shfl_sync(kFullMask, rid, lr);
        right[u] = e < nw && src >= 0
            ? mask_r[int64_t(min(src, Tr - 1)) * W + (e - lr * W)] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kWarp + lane;
        if (e < nw) mask_out[base + e] = left[u] & right[u];
      }
    }
  }
}

}  // namespace
}  // namespace shareddb

// `blocks` comes from kernels/partitioned_join.py::grid_blocks.
extern "C" int shareddb_partitioned_join(
    const int32_t* keys_l, const int32_t* mask_l, const int32_t* bkeys,
    const int32_t* brows, const int32_t* bounds, const int32_t* mask_r,
    int32_t* rid_out, int32_t* mask_out, int Tl, int W, int P, int B, int Tr,
    int blocks, cudaStream_t stream) {
  using namespace shareddb;
  if (Tl == 0) return int(cudaGetLastError());
  partitioned_join_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      keys_l, mask_l, bkeys, brows, bounds, mask_r, rid_out, mask_out, Tl, W,
      P, B, Tr);
  return int(cudaGetLastError());
}
