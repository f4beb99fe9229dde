// ClockScan shared scan for Hopper: every query's conjunctive range
// predicate against every row, bit-packed 32 queries to a word.
//
// Replaces repro/kernels/clockscan.py::clockscan_pallas (body _kernel).
// out[t, w] bit b = valid[t] && AND_c lo[c, 32w+b] <= cols[c, t] <= hi[c, 32w+b].
//
// What bounds it: bytes and compares alike at TPC-W's shapes.  It reads
// C*T column values, writes T*Q/32 words and does 2*C*T*Q compares; the
// reseed beat's six calls move ~4.8 MB and do ~89 M compares, ~1.4 us
// either way on an H100 — under the time of a launch.
//
// Design: a persistent grid sized to the card (the wrapper's grid_blocks:
// at most 4 blocks an SM).  Each block stages the whole lo/hi matrix once
// as (lo, hi) pairs in shared memory and walks block tiles of 32*rt rows,
// a grid stride apart.  Warp w of a tile takes the 32 rows of subtile
// w % rt and the words w / rt, w / rt + g, ... (rt * g <= 8 warps, from
// tile_geometry: wide windows split their words over the warps, narrow
// ones give each warp its own rows).  Lanes are rows: each lane loads its
// row's column values (a coalesced 128-byte load per column) and builds
// its row's word bit by bit from broadcast reads of the pairs
// (common.cuh row_word).  The tile's 32*rt*W words are contiguous in
// `out`; they are staged in shared memory and written with 16-byte
// stores.  Rows past T are never stored; invalid rows give zero words.
// lo/hi take at most 48 KB (MAX_PREDICATES); with the staging buffer a
// block can need more, which the launcher opts into.
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * kWarp;

__global__ void __launch_bounds__(kThreads)
clockscan_kernel(const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ out, int C, int T, int Q, int rt,
                 int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = Q / kWarp;
  const int tile_rows = kWarp * rt;
  int32_t* buf = reinterpret_cast<int32_t*>(smem);      // [tile_rows, W]
  int2* pairs =                                          // [C, Q]
      reinterpret_cast<int2*>(smem + sizeof(int32_t) * tile_rows * W);
  for (int i = threadIdx.x; i < C * Q; i += kThreads)
    pairs[i] = make_int2(lo[i], hi[i]);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int sub = warp % rt, phase = warp / rt;
  const int n_tiles = T / tile_rows + (T % tile_rows != 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t r0 = int64_t(tile) * tile_rows;
    const int nrows = min(tile_rows, int(T - r0));
    if (phase < g && sub * kWarp < nrows) {
      const int64_t row = r0 + sub * kWarp + lane;
      const bool live = row < T && valid[row] != 0;
      for (int k = phase; k < W; k += g) {
        const uint32_t word = row_word(cols, T, row, live, pairs, Q,
                                       k * kWarp, C);
        if (row < T) buf[(sub * kWarp + lane) * W + k] = int32_t(word);
      }
    }
    __syncthreads();
    // the tile's words are out[r0 * W, (r0 + nrows) * W): 16-byte aligned
    // (r0 * W * 4 is a multiple of 128), a scalar tail after the last
    // whole int4
    const int n = nrows * W;
    int32_t* dst = out + r0 * W;
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(buf)[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) dst[i] = buf[i];
    __syncthreads();
  }
}

}  // namespace
}  // namespace shareddb

extern "C" const char* shareddb_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

// `blocks`, `rt` and `g` come from kernels/clockscan.py (grid_blocks,
// tile_geometry); `out` must be 16-byte aligned.
extern "C" int shareddb_clockscan(const int32_t* cols, const int32_t* lo,
                                  const int32_t* hi, const uint8_t* valid,
                                  int32_t* out, int C, int T, int Q, int rt,
                                  int g, int blocks, cudaStream_t stream) {
  using namespace shareddb;
  if (T == 0) return int(cudaGetLastError());
  const size_t smem = sizeof(int32_t) * size_t(kWarp) * rt * (Q / kWarp)
                      + sizeof(int2) * size_t(C) * Q;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clockscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  clockscan_kernel<<<blocks, kThreads, smem, stream>>>(cols, lo, hi, valid,
                                                       out, C, T, Q, rt, g);
  return int(cudaGetLastError());
}
