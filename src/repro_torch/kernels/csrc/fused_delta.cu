// Fused delta heartbeat for Hopper: the whole incremental beat in ONE
// launch.
//
// Replaces repro/kernels/fused_delta.py::fused_delta_pallas (body
// _mega_kernel and its XLA epilogue).  The launch walks the work
// descriptor sdesc int32[N, 4] = (kind, owner, idx, gather) that
// repro_torch/kernels/fused_delta.py builds on the device; descriptor row
// i is thread block i:
//
//   PANE  (0): pane tile `idx` (256 rows) of scan stage `owner`: the
//              pane-width predicates (lo_p/hi_p, 32*A queries) against
//              each row, written at word columns [w0, w0+A) of the
//              carried words.  Skipped when span == 0.
//   DIRTY (1): dirty-row slot `idx` of stage `owner`: row `gather` against
//              the FULL window, all w words of the row rewritten.
//              Skipped when dn == 0 or the slot is a pad (row >= T).
//   PROBE (2): dirty-row slot `idx` of carried join `owner`: the spine
//              row's key probes bucket `gather`; the max matching row
//              (-1 if none) is written into the rid output at that row.
//
// The merge happens in the kernel, straight into the carries: PANE and
// DIRTY blocks that touch the same (row, word) compute the same bits from
// the same row and predicate columns, so their order does not matter, and
// each rid slot has one writer.  The scan words are merged in place (the
// reference donates that carry); the wrapper hands the rid outputs as
// fresh copies of the rid carry.
//
// Per-stage and per-join pointers travel in one FusedArgs struct passed
// by value as a __grid_constant__ kernel parameter (the constant bank,
// indexed by the descriptor's owner without a per-thread copy): no table
// is copied to the device per beat.  w0/span/dn are device scalars, read
// here, so the host never learns them.
//
// What bounds it: bytes — each live pane tile reads its rows' columns
// and writes A words per row, each live dirty slot reads C values and Q
// predicate pairs and writes w words, each live probe reads one bucket.
// Steady beats leave most blocks with nothing to do; they exit at once.
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kPane = 0, kDirty = 1, kProbe = 2;
constexpr int kPaneTile = 256;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxStages = 16;
constexpr int kMaxJoins = 16;

struct ScanArgs {
  const int32_t* cols;   // [C, T]
  const int32_t* lo;     // [C, Q] full window
  const int32_t* hi;
  const int32_t* lo_p;   // [C, 32*A] pane slice at w0
  const int32_t* hi_p;
  const uint8_t* valid;  // [T]
  int32_t* carry;        // [T, Q/32], merged in place
  const int32_t* rows;   // [D] dirty rows, sentinel T pads
  const int32_t* scal;   // {w0, span, dn}
  int C, T, Q, A, D, nt;
};

struct JoinArgs {
  const int32_t* keys;   // [Tl] spine fk column
  const int32_t* rows;   // [D] dirty spine rows, sentinel Tl pads
  const int32_t* bkeys;  // [P, B]
  const int32_t* brows;  // [P, B]
  int32_t* rid;          // [Tl] rid output (a copy of the carry)
  const int32_t* dn;     // live dirty count
  int Tl, D, P, B;
};

struct FusedArgs {
  ScanArgs s[kMaxStages];
  JoinArgs j[kMaxJoins];
  int ns, nj;
};

__device__ void pane_block(const ScanArgs& s, int tile) {
  if (s.scal[1] <= 0) return;                        // span == 0: identity
  const int w = s.Q / kWarp;
  const int w0 = min(max(s.scal[0], 0), w - s.A);
  const int lane = threadIdx.x % kWarp;
  const int64_t tile_end = int64_t(tile + 1) * kPaneTile;
  const int64_t end = tile_end < s.T ? tile_end : int64_t(s.T);
  for (int64_t row = int64_t(tile) * kPaneTile + threadIdx.x / kWarp;
       row < end; row += kWarpsPerBlock) {
    const bool v = s.valid[row] != 0;
    for (int a = 0; a < s.A; ++a) {
      const bool ok = v && range_match(s.cols, s.T, row, s.lo_p, s.hi_p,
                                       s.A * kWarp, a * kWarp + lane, s.C);
      const uint32_t word = __ballot_sync(kFullMask, ok);
      if (lane == 0) s.carry[row * w + w0 + a] = int32_t(word);
    }
  }
}

__device__ void dirty_block(const ScanArgs& s, int slot, int row) {
  if (s.scal[2] <= 0) return;                        // dn == 0: identity
  const int32_t target = s.rows[slot];
  if (target < 0 || target >= s.T) return;           // pad slot: dropped
  const int w = s.Q / kWarp;
  const int lane = threadIdx.x % kWarp;
  const bool v = s.valid[row] != 0;
  for (int k = threadIdx.x / kWarp; k < w; k += kWarpsPerBlock) {
    const bool ok = v && range_match(s.cols, s.T, row, s.lo, s.hi, s.Q,
                                     k * kWarp + lane, s.C);
    const uint32_t word = __ballot_sync(kFullMask, ok);
    if (lane == 0) s.carry[int64_t(target) * w + k] = int32_t(word);
  }
}

__device__ void probe_block(const JoinArgs& j, int slot, int bucket) {
  if (*j.dn <= 0) return;                            // dn == 0: identity
  if (threadIdx.x >= kWarp) return;                  // one warp probes
  const int32_t target = j.rows[slot];
  if (target < 0 || target >= j.Tl) return;          // pad slot: dropped
  const int32_t key = j.keys[target];
  const int rid = probe_bucket(j.bkeys, j.brows, bucket, j.B, key,
                               threadIdx.x);
  if (threadIdx.x == 0) j.rid[target] = rid;
}

__global__ void __launch_bounds__(kThreads)
fused_delta_kernel(const int32_t* __restrict__ sdesc,
                   const __grid_constant__ FusedArgs args) {
  const int32_t* d = sdesc + int64_t(blockIdx.x) * 4;
  const int kind = d[0], owner = d[1], idx = d[2], gather = d[3];
  if (kind == kPane) {
    pane_block(args.s[owner], idx);
  } else if (kind == kDirty) {
    dirty_block(args.s[owner], idx, gather);
  } else if (kind == kProbe) {
    probe_block(args.j[owner], idx, gather);
  }
}

static_assert(sizeof(FusedArgs) <= 4096, "kernel parameter limit");

// ---------------------------------------------------------------------------
// The chained delta ops: the DIRTY and PROBE blocks as standalone launches
// ---------------------------------------------------------------------------
//
// delta_scan replaces repro/kernels/fused_delta.py::delta_scan_pallas and
// delta_join replaces ::delta_join_pallas: the backend's scan_delta and
// join_delta, which a backend without fused_delta chains per stage and
// per join.  Unlike the fused blocks they have no live count and write
// no carry: they write ONE output row per slot, pad slots included,
// computed on the slot's row clamped into [0, T-1] (the caller's scatter
// drops the pads), as kernels/ref.py's delta_scan_ref / delta_join_ref
// do.  delta_join routes its key to a bucket inside the kernel (the
// reference routes in XLA before its kernel).
//
// What bounds them: bytes — D gathered rows' predicate columns, the
// [C, Q] predicate matrices and D*Q/32 output words for the scan; D
// bucket panes of B (key, row) pairs for the probe.  Both are a few
// hundred KB at most on the path; launch latency dominates.

// One block per dirty slot: the slot's clamped row against the FULL
// window, one warp per output word at a time (__ballot_sync packs it).
__global__ void __launch_bounds__(kThreads)
delta_scan_kernel(const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ rows,
                  int32_t* __restrict__ out, int C, int T, int Q) {
  const int slot = blockIdx.x;
  const int64_t row = min(max(rows[slot], 0), T - 1);
  const int w = Q / kWarp;
  const int lane = threadIdx.x % kWarp;
  const bool v = valid[row] != 0;
  for (int k = threadIdx.x / kWarp; k < w; k += kWarpsPerBlock) {
    const bool ok = v && range_match(cols, T, row, lo, hi, Q,
                                     k * kWarp + lane, C);
    const uint32_t word = __ballot_sync(kFullMask, ok);
    if (lane == 0) out[int64_t(slot) * w + k] = int32_t(word);
  }
}

// One warp per dirty slot: route the clamped spine row's key to its one
// bucket (searchsorted right, -1, clip), then the max live row of that
// bucket with an equal key (-1 if none).
__global__ void __launch_bounds__(kThreads)
delta_join_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ bkeys,
                  const int32_t* __restrict__ brows,
                  const int32_t* __restrict__ bounds,
                  int32_t* __restrict__ rid_out, int Tl, int D, int P,
                  int B) {
  const int slot = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (slot >= D) return;                             // whole warps exit
  const int lane = threadIdx.x % kWarp;
  const int64_t row = min(max(rows[slot], 0), Tl - 1);
  const int32_t key = keys[row];
  const int b = route_bucket(bounds, P, key);
  const int rid = probe_bucket(bkeys, brows, b, B, key, lane);
  if (lane == 0) rid_out[slot] = rid;
}

}  // namespace
}  // namespace shareddb

// `args` points at a host FusedArgs; it is copied into the launch.
extern "C" int shareddb_fused_delta(const int32_t* sdesc, int N,
                                    const void* args, cudaStream_t stream) {
  using namespace shareddb;
  if (N == 0) return int(cudaGetLastError());
  const FusedArgs& a = *static_cast<const FusedArgs*>(args);
  fused_delta_kernel<<<N, kThreads, 0, stream>>>(sdesc, a);
  return int(cudaGetLastError());
}

extern "C" int shareddb_delta_scan(const int32_t* cols, const int32_t* lo,
                                   const int32_t* hi, const uint8_t* valid,
                                   const int32_t* rows, int32_t* out, int C,
                                   int T, int Q, int D, cudaStream_t stream) {
  using namespace shareddb;
  if (D == 0) return int(cudaGetLastError());
  delta_scan_kernel<<<D, kThreads, 0, stream>>>(cols, lo, hi, valid, rows,
                                                out, C, T, Q);
  return int(cudaGetLastError());
}

extern "C" int shareddb_delta_join(const int32_t* keys, const int32_t* rows,
                                   const int32_t* bkeys, const int32_t* brows,
                                   const int32_t* bounds, int32_t* rid_out,
                                   int Tl, int D, int P, int B,
                                   cudaStream_t stream) {
  using namespace shareddb;
  if (D == 0) return int(cudaGetLastError());
  const int blocks = (D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  delta_join_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, rows, bkeys, brows, bounds, rid_out, Tl, D, P, B);
  return int(cudaGetLastError());
}
