// Block shared join for Hopper: key-equality match against a small
// index-less PK side, fused with the query-set intersection.
//
// Replaces repro/kernels/bitmask_join.py::bitmask_join_pallas (body
// _kernel).  The TPU body sums eq @ mask_r over 256x256 tiles across a
// sequential grid; that sum equals the one matching row's mask only
// because right keys are unique among valid rows.  Hopper blocks run in
// no order, so nothing is carried between them: each block owns a tile
// of left rows and computes, per row,
//   rid  = the largest valid right row with an equal key (-1 if none),
//   out  = mask_l & mask_r[rid]  (0 when unmatched),
// the contract of kernels/ref.py::bitmask_join_ref.  Invalid right rows
// that repeat a valid key (a delete followed by a re-insert) never match.
//
//   1. the block stages the right keys and valid flags through shared
//      memory in chunks of kChunk rows (any Tr), and each thread keeps
//      the last match of its left row (rows ascend, so the last is the
//      largest);
//   2. the block writes its tile's [rows, W] words with consecutive
//      threads on consecutive words: mask_l read and out written
//      coalesced, the one mask_r row of each left row gathered (the
//      right side is small and stays in L1/L2).
//
// What bounds it: bytes — keys_l and mask_l read, rid and out written
// (mask_r, keys_r and valid_r are read once per block from L2); the
// Tl*Tr compares are cheap beside them at the path's Tr = 128.
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kThreads = 256;   // left rows per block
constexpr int kChunk = 2048;    // right rows staged per pass

__global__ void __launch_bounds__(kThreads)
bitmask_join_kernel(const int32_t* __restrict__ keys_l,
                    const int32_t* __restrict__ mask_l,
                    const int32_t* __restrict__ keys_r,
                    const int32_t* __restrict__ mask_r,
                    const uint8_t* __restrict__ valid_r,
                    int32_t* __restrict__ rid_out,
                    int32_t* __restrict__ mask_out, int Tl, int W, int Tr) {
  __shared__ int32_t s_key[kChunk];
  __shared__ uint8_t s_valid[kChunk];
  __shared__ int32_t s_rid[kThreads];
  const int64_t row0 = int64_t(blockIdx.x) * kThreads;
  const int64_t i = row0 + threadIdx.x;
  const int32_t key = i < Tl ? keys_l[i] : 0;
  int best = -1;
  for (int base = 0; base < Tr; base += kChunk) {
    const int n = min(kChunk, Tr - base);
    __syncthreads();                       // the previous chunk is read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      s_key[j] = keys_r[base + j];
      s_valid[j] = valid_r[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (s_valid[j] && s_key[j] == key) best = base + j;
    }
  }
  s_rid[threadIdx.x] = best;
  if (i < Tl) rid_out[i] = best;
  __syncthreads();
  const int rows = int(min(int64_t(kThreads), int64_t(Tl) - row0));
  for (int e = threadIdx.x; e < rows * W; e += kThreads) {
    const int r = e / W;
    const int w = e - r * W;
    const int rid = s_rid[r];
    const int64_t at = (row0 + r) * W + w;
    mask_out[at] = rid >= 0 ? (mask_l[at] & mask_r[int64_t(rid) * W + w]) : 0;
  }
}

}  // namespace
}  // namespace shareddb

extern "C" int shareddb_bitmask_join(const int32_t* keys_l,
                                     const int32_t* mask_l,
                                     const int32_t* keys_r,
                                     const int32_t* mask_r,
                                     const uint8_t* valid_r, int32_t* rid_out,
                                     int32_t* mask_out, int Tl, int W, int Tr,
                                     cudaStream_t stream) {
  using namespace shareddb;
  if (Tl == 0) return int(cudaGetLastError());
  const int blocks = (Tl + kThreads - 1) / kThreads;
  bitmask_join_kernel<<<blocks, kThreads, 0, stream>>>(
      keys_l, mask_l, keys_r, mask_r, valid_r, rid_out, mask_out, Tl, W, Tr);
  return int(cudaGetLastError());
}
