// Block shared join for Hopper: key-equality match against a small
// index-less PK side, fused with the query-set intersection.
//
// Replaces repro/kernels/bitmask_join.py::bitmask_join_pallas (body
// _kernel).  The TPU body sums eq @ mask_r over 256x256 tiles across a
// sequential grid; that sum equals the one matching row's mask only
// because right keys are unique among valid rows.  Hopper blocks run in
// no order, so nothing is carried between them: each left row gets
//   rid  = the largest valid right row with an equal key (-1 if none),
//   out  = mask_l & mask_r[rid]  (0 when unmatched),
// the contract of kernels/ref.py::bitmask_join_ref.  Invalid right rows
// that repeat a valid key (a delete followed by a re-insert) never match.
//
// What bounds it: bytes.  keys_l and mask_l are read and rid and out
// written once: ~6.2 MB on the fold path's address x country call (Tl
// 51 392, W 14, Tr 128), 1.8 us at 3.35 TB/s; the right side is 7 KB.
// At that size the card must hold ~2 MB of loads in flight (3.35 TB/s x
// ~0.7 us of latency) — a third of the whole call — so the design is
// about issuing the left side's loads early and wide:
//
//   * a persistent grid (kernels/bitmask_join.py grid_blocks: at most
//     kernels.BLOCKS_PER_SM blocks an SM, a multiple of the SM count once
//     there are more chunks than SMs, so every SM gets the same share);
//     a warp owns a chunk of 32 consecutive left rows at a time, chunks
//     dealt warp-major (chunk c -> block c % blocks), so consecutive
//     chunks land on different SMs;
//   * a chunk's rows x W words are one contiguous range of mask_l and of
//     out: the lanes stream it in 16-byte pieces, kBatch pieces a lane in
//     flight, the first batch (with the lane's own left key) issued before
//     the block stages the right side and before the rid search;
//   * each word's row is found without a division: floor(e / W) by the
//     launch's reciprocal ceil(2^32 / W) (exact for e * W < 2^32: e <
//     32 W and W <= kernels/bitmask_join.py MAX_WORDS), then walked one
//     word at a time; its rid comes from the owning lane by shuffle.
//
// Finding rids, staged path (the right side fits: its bytes <=
// STAGE_BYTES, two blocks an SM): each block stages the whole right side
// once in dynamic shared memory — mask_r as Tr x W words, and each right
// row as one 64-bit composite (invalid, key, row) whose order is
// build_key_partitions' (live rows first, by key, rows ascending among
// equal keys).  When the staged order is that sorted order — the PK
// table holds its live rows in key order ahead of its free rows, as
// TPC-W's country does (keys 0..91 in rows 0..91, rows 92..127 free);
// one pass and a block vote check it — each lane (a left row) binary-
// searches the composites for the last live entry with key <= its key
// (log2 Tr + 1 steps): its row is the answer when its key is equal.  Any
// other order takes the chunked path's scan for the rid (Tr compares a
// lane, the right keys through L1); mask_r[rid] is still read from
// shared memory.  No input of the main path takes that scan: on the fold
// shape with its right rows shuffled it costs ~1.4x what a sort of the
// staged rows in every block did, and ~2x the sorted path (PERF.md
// section 6), so no sort is kept.
//
// Chunked path (a right side that does not fit, any Tr): the warp reads
// the right keys 32 at a time, a lane each, and broadcasts them by
// shuffle; mask_r[rid] is read from global memory (L2).  Both paths live
// in this one kernel, a template instance each (so that no per-word
// branch picks where mask_r is read); the launch picks by `smem` (0:
// chunked).
//
// Unaligned bases: when mask_l or out is not 16-byte aligned the pieces
// are read and written a word at a time (same walk); the ragged end of a
// chunk (rows x W not a multiple of 4) likewise.
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * kWarp;
constexpr int kBatch = 4;        // 16-byte pieces a lane has in flight

// floor(e / W) for 0 <= e, e * W < 2^32, by recip = ceil(2^32 / W).
__device__ __forceinline__ int row_of(int e, unsigned long long recip) {
  return int((static_cast<unsigned long long>(unsigned(e)) * recip) >> 32);
}

// Pieces p0 + u * 32 + lane (u < kBatch) of a chunk's nw words at src:
// 16-byte loads where the piece is whole and `vec`, else word by word;
// words past nw read 0.
__device__ __forceinline__ void load_pieces(int4 (&v)[kBatch],
                                            const int32_t* __restrict__ src,
                                            int nw, int p0, bool vec,
                                            int lane) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int e = 4 * (p0 + u * kWarp + lane);
    if (vec && e + 4 <= nw) {
      v[u] = __ldg(reinterpret_cast<const int4*>(src + e));
    } else {
      v[u].x = e < nw ? __ldg(src + e) : 0;
      v[u].y = e + 1 < nw ? __ldg(src + e + 1) : 0;
      v[u].z = e + 2 < nw ? __ldg(src + e + 2) : 0;
      v[u].w = e + 3 < nw ? __ldg(src + e + 3) : 0;
    }
  }
}

__device__ __forceinline__ void store_pieces(const int4 (&v)[kBatch],
                                             int32_t* __restrict__ dst,
                                             int nw, int p0, bool vec,
                                             int lane) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int e = 4 * (p0 + u * kWarp + lane);
    if (vec && e + 4 <= nw) {
      *reinterpret_cast<int4*>(dst + e) = v[u];
    } else {
      if (e < nw) dst[e] = v[u].x;
      if (e + 1 < nw) dst[e + 1] = v[u].y;
      if (e + 2 < nw) dst[e + 2] = v[u].z;
      if (e + 3 < nw) dst[e + 3] = v[u].w;
    }
  }
}

// A right row as one 64-bit word whose unsigned order is
// build_key_partitions' bucket order: invalid rows after every live one,
// then the key (sign bit flipped), then the row.
__device__ __forceinline__ unsigned long long composite(int32_t key,
                                                        bool valid,
                                                        int row) {
  return (static_cast<unsigned long long>(!valid) << 63)
         | (static_cast<unsigned long long>(unsigned(key) ^ 0x80000000u)
            << 31)
         | unsigned(row);
}

// Staged: the largest live row whose key equals `key` (-1 if none), by a
// binary search of Tr sorted composites: the live entries with a key <=
// `key` are exactly those below `lim`, a prefix; the last of them holds
// the answer when its key is `key`.
__device__ __forceinline__ int search_sorted(const unsigned long long* c,
                                             int Tr, int32_t key) {
  const unsigned long long k = unsigned(key) ^ 0x80000000u;
  const unsigned long long lim = (k + 1) << 31;
  int lo = 0, hi = Tr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] < lim) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return -1;
  const unsigned long long x = c[lo - 1];
  return (x >> 31) == k ? int(x & 0x7fffffff) : -1;
}

// Chunked: the same answer from global memory, the right keys 32 at a
// time (a lane each) broadcast by shuffle.  The whole warp calls it.
__device__ __forceinline__ int scan_chunked(
    const int32_t* __restrict__ keys_r, const uint8_t* __restrict__ valid_r,
    int Tr, int32_t key, int lane) {
  int best = -1;
  for (int j0 = 0; j0 < Tr; j0 += kWarp) {
    const int j = j0 + lane;
    int32_t k = 0;
    int r = -1;
    if (j < Tr) {
      k = __ldg(keys_r + j);
      r = __ldg(valid_r + j) ? j : -1;
    }
    const int m = min(kWarp, Tr - j0);
    // not unrolled: unrolled, it spills in the staged instance (ptxas
    // holds that one to 64 registers)
#pragma unroll 1
    for (int t = 0; t < m; ++t) {
      const int32_t kt = __shfl_sync(kFullMask, k, t);
      const int rt = __shfl_sync(kFullMask, r, t);
      if (kt == key) best = max(best, rt);
    }
  }
  return best;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
bitmask_join_kernel(const int32_t* __restrict__ keys_l,
                    const int32_t* __restrict__ mask_l,
                    const int32_t* __restrict__ keys_r,
                    const int32_t* __restrict__ mask_r,
                    const uint8_t* __restrict__ valid_r,
                    int32_t* __restrict__ rid_out,
                    int32_t* __restrict__ mask_out, int Tl, int W, int Tr,
                    unsigned long long recip, int vec) {
  // staged: mask_r [Tr * W] words (rounded up to 4), then the Tr
  // composites as staged
  extern __shared__ int4 smem[];
  int32_t* s_mask = reinterpret_cast<int32_t*>(smem);
  unsigned long long* s_comp = reinterpret_cast<unsigned long long*>(
      s_mask + (kStaged ? (Tr * W + 3) & ~3 : 0));
  const int lane = threadIdx.x % kWarp;
  const int64_t chunks = (int64_t(Tl) + kWarp - 1) / kWarp;
  const int64_t stride = int64_t(gridDim.x) * kWarpsPerBlock;
  int64_t c = blockIdx.x + int64_t(threadIdx.x / kWarp) * gridDim.x;

  // the first chunk's left key and first batch: in flight while the
  // block stages the right side
  int32_t key = 0;
  int4 left[kBatch];
  if (c < chunks) {
    const int64_t r0 = c * kWarp;
    const int n = int(min(int64_t(kWarp), Tl - r0));
    key = lane < n ? __ldg(keys_l + r0 + lane) : 0;
    load_pieces(left, mask_l + r0 * W, n * W, 0, vec, lane);
  }
  bool search = false;     // block-uniform: the staged order is sorted
  if (kStaged) {
    // every load of the right side issued before its first store: mask_r
    // in 16-byte pieces when aligned
    const int nr = Tr * W;
    const int n4 = (reinterpret_cast<uintptr_t>(mask_r) & 15) ? 0 : nr / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads)
      smem[i] = __ldg(reinterpret_cast<const int4*>(mask_r) + i);
    for (int i = 4 * n4 + threadIdx.x; i < nr; i += kThreads)
      s_mask[i] = __ldg(mask_r + i);
    for (int j = threadIdx.x; j < Tr; j += kThreads)
      s_comp[j] = composite(__ldg(keys_r + j), __ldg(valid_r + j) != 0, j);
    __syncthreads();
    bool in_order = true;
    for (int j = threadIdx.x; j + 1 < Tr; j += kThreads)
      in_order = in_order && s_comp[j] < s_comp[j + 1];
    search = __syncthreads_and(in_order);
  }

  for (bool first = true; c < chunks; c += stride, first = false) {
    const int64_t r0 = c * kWarp;
    const int n = int(min(int64_t(kWarp), Tl - r0));   // rows of the chunk
    const int32_t* src = mask_l + r0 * W;
    int32_t* dst = mask_out + r0 * W;
    const int nw = n * W;
    if (!first) {
      key = lane < n ? __ldg(keys_l + r0 + lane) : 0;
      load_pieces(left, src, nw, 0, vec, lane);
    }
    const int rid = search ? search_sorted(s_comp, Tr, key)
                           : scan_chunked(keys_r, valid_r, Tr, key, lane);
    if (lane < n) rid_out[r0 + lane] = rid;
    // the chunk's nw words, kBatch pieces a lane at a time (warp-uniform
    // trips); a word's row from the reciprocal, then walked
    for (int p0 = 0; 4 * p0 < nw; p0 += kBatch * kWarp) {
      if (p0 > 0) load_pieces(left, src, nw, p0, vec, lane);
      int4 out[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = 4 * (p0 + u * kWarp + lane);
        int lr = row_of(e, recip);
        int w = e - lr * W;
        int32_t* o = &out[u].x;
        const int32_t* l = &left[u].x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src_rid = __shfl_sync(kFullMask, rid, min(lr, n - 1));
          int32_t right = 0;               // 0 for an unmatched row
          if (e + i < nw && src_rid >= 0) {
            right = kStaged ? s_mask[src_rid * W + w]
                            : __ldg(mask_r + int64_t(src_rid) * W + w);
          }
          o[i] = l[i] & right;
          if (++w == W) {
            w = 0;
            ++lr;
          }
        }
      }
      store_pieces(out, dst, nw, p0, vec, lane);
    }
  }
}

}  // namespace
}  // namespace shareddb

// `blocks`, `smem` (0: the chunked path) and `recip` come from
// kernels/bitmask_join.py (grid_blocks, stage_bytes, reciprocal).
extern "C" int shareddb_bitmask_join(const int32_t* keys_l,
                                     const int32_t* mask_l,
                                     const int32_t* keys_r,
                                     const int32_t* mask_r,
                                     const uint8_t* valid_r, int32_t* rid_out,
                                     int32_t* mask_out, int Tl, int W, int Tr,
                                     int blocks, int smem,
                                     unsigned long long recip,
                                     cudaStream_t stream) {
  using namespace shareddb;
  if (Tl == 0) return int(cudaGetLastError());
  const auto kernel =
      smem > 0 ? bitmask_join_kernel<true> : bitmask_join_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const int vec = ((reinterpret_cast<uintptr_t>(mask_l)
                    | reinterpret_cast<uintptr_t>(mask_out)) & 15) == 0;
  kernel<<<blocks, kThreads, smem, stream>>>(
      keys_l, mask_l, keys_r, mask_r, valid_r, rid_out, mask_out, Tl, W, Tr,
      recip, vec);
  return int(cudaGetLastError());
}
