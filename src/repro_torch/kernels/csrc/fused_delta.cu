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
