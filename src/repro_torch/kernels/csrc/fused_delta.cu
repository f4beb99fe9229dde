// Fused delta heartbeat for Hopper: the whole incremental beat in ONE
// launch, and nothing enqueued around it.
//
// Replaces repro/kernels/fused_delta.py::fused_delta_pallas (body
// _mega_kernel, its XLA prologue and its XLA epilogue).  The launch walks
// a STATIC descriptor desc int32[N, 3] = (kind, owner, idx) that
// repro_torch/kernels/fused_delta.py::launch_schedule builds on the
// device once per geometry: the reference's schedule, reordered, plus the
// rid COPY tiles.  Nothing in it depends on the beat's data: the row of
// a DIRTY slot and the bucket of a PROBE slot are gathered here.
//
//   PANE  (0): pane tile `idx` (256 rows) of scan stage `owner`, a BLOCK
//              item: the pane-width predicates (lo_p/hi_p, 32*A queries)
//              against each row, written at word columns [w0, w0+A) of
//              the carried words.  Skipped when span == 0.
//   DIRTY (1): dirty-row slot `idx` of stage `owner`, a WARP item: row
//              rows[idx] against the FULL window, all w words of the row
//              rewritten.  Skipped when dn == 0 or the slot is a pad
//              (row < 0 or row >= T).
//   PROBE (2): dirty-row slot `idx` of carried join `owner`, a WARP item:
//              the spine row rows[idx]'s key is routed to its bucket over
//              `bounds` (route_bucket) and probes it; the max matching
//              row (-1 if none) is written into the rid output at that
//              row.  Skipped when dn == 0 or the slot is a pad.
//   COPY  (3): rid tile `idx` (1024 rows) of join `owner`, a WARP item:
//              rid[i] = rid_carry[i] for every row of the tile that no
//              live PROBE slot writes.
//
// Every rid element has exactly one writer: a join's dirty rows are
// ascending, distinct and padded with the sentinel Tl (FusedJoinIn), so a
// COPY tile finds the dirty rows that fall in it by binary search
// (lower_bound) and skips them, and when dn == 0 it copies every row.
// PANE and DIRTY items that touch the same (row, word) compute the same
// bits from the same row and predicate columns (lo_p is lo's slice at
// w0), so their order does not matter.  The scan words are merged in
// place (the reference donates that carry); the rid outputs are fresh
// tensors that the wrapper allocates and this kernel fills.
//
// Per-stage and per-join pointers travel in one FusedArgs struct passed
// by value as a __grid_constant__ kernel parameter; w0/span/dn are
// pointers to the stages' and joins' own 0-d device tensors, read once per
// block into shared memory, so the host never learns them and the
// wrapper enqueues nothing but this launch.
//
// Work is sized to the beat, not to the descriptor: a grid of at most 4
// blocks an SM (fused_delta.py::grid_blocks) walks the PANE items a block
// at a time, a grid stride apart, then the warp items a warp at a time,
// warp-major (item i goes to warp (i / blocks) % 8 of block i % blocks),
// so that consecutive items land on different SMs.  An idle item costs
// one descriptor load and a branch.  A live pane tile stages its lo_p/hi_p
// as (lo, hi) pairs in shared memory; its 256 threads are its rows (lanes
// as rows: coalesced column loads, each lane builds its own row's words,
// common.cuh row_word).
//
// What bounds it: bytes — each live pane tile reads its rows' columns
// and writes A words per row, each live dirty slot reads C values and Q
// predicate pairs and writes w words, each live probe reads one bucket,
// and every join's rids are read once and written once (8*Tl bytes).
#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kDirty = 1, kProbe = 2, kCopy = 3;   // kPane = 0
constexpr int kPaneTile = 256;
constexpr int kCopyTile = 1024;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxStages = 16;
constexpr int kMaxJoins = 16;
static_assert(kPaneTile == kThreads, "a pane tile's rows are its threads");

struct ScanArgs {
  const int32_t* cols;   // [C, T]
  const int32_t* lo;     // [C, Q] full window
  const int32_t* hi;
  const int32_t* lo_p;   // [C, 32*A] pane slice at w0
  const int32_t* hi_p;
  const uint8_t* valid;  // [T]
  int32_t* carry;        // [T, Q/32], merged in place
  const int32_t* rows;   // [D] dirty rows, sentinel T pads
  const int32_t* w0;     // 0-d: the pane's first word column
  const int32_t* span;   // 0-d: changed-word span (0 = no pane)
  const int32_t* dn;     // 0-d: live dirty count
  int C, T, Q, A, D;
};

struct JoinArgs {
  const int32_t* keys;       // [Tl] spine fk column
  const int32_t* rows;       // [D] dirty spine rows: ascending, distinct,
                             //     sentinel Tl pads
  const int32_t* bkeys;      // [P, B]
  const int32_t* brows;      // [P, B]
  const int32_t* bounds;     // [P] bucket lower bounds
  const int32_t* rid_carry;  // [Tl] the previous beat's rids
  int32_t* rid;              // [Tl] rid output
  const int32_t* dn;         // 0-d: live dirty count
  int Tl, D, P, B;
};

struct FusedArgs {
  ScanArgs s[kMaxStages];
  JoinArgs j[kMaxJoins];
  int ns, nj;
};

// A block item: the block's 256 threads are the tile's rows.  `pairs` is
// the block's shared staging of the stage's pane predicates.
__device__ void pane_tile(const ScanArgs& s, int w0, int tile, int2* pairs) {
  __syncthreads();                       // the previous tile's pairs are read
  const int np = s.C * s.A * kWarp;
  for (int i = threadIdx.x; i < np; i += kThreads)
    pairs[i] = make_int2(s.lo_p[i], s.hi_p[i]);
  __syncthreads();
  const int64_t row = int64_t(tile) * kPaneTile + threadIdx.x;
  if (row >= s.T) return;
  const int w = s.Q / kWarp;
  const bool live = s.valid[row] != 0;
  for (int a = 0; a < s.A; ++a)
    s.carry[row * w + w0 + a] = int32_t(
        row_word(s.cols, s.T, row, live, pairs, s.A * kWarp, a * kWarp, s.C));
}

// One warp: the Q/32 words of one row against the full window [C, Q]
// into dst[0, Q/32), lanes as queries (__ballot_sync packs each word);
// lane k % 32 keeps word k and the warp stores 32 consecutive words at
// once.  A row that is not valid gives 0 words.
__device__ void full_window_words(const int32_t* __restrict__ cols, int T,
                                  int64_t row, bool v,
                                  const int32_t* __restrict__ lo,
                                  const int32_t* __restrict__ hi, int Q, int C,
                                  int32_t* __restrict__ dst, int lane) {
  const int w = Q / kWarp;
  uint32_t mine = 0;
  for (int k = 0; k < w; ++k) {
    const bool ok = v && range_match(cols, T, row, lo, hi, Q,
                                     k * kWarp + lane, C);
    const uint32_t word = __ballot_sync(kFullMask, ok);
    if (k % kWarp == lane) mine = word;
    if (k % kWarp == kWarp - 1 || k == w - 1) {
      const int base = k - k % kWarp;
      if (base + lane <= k) dst[base + lane] = int32_t(mine);
    }
  }
}

// A warp item: one dirty row against the full window, into its carry row.
__device__ void dirty_warp(const ScanArgs& s, int slot, int lane) {
  const int32_t target = s.rows[slot];
  if (target < 0 || target >= s.T) return;           // pad slot: dropped
  full_window_words(s.cols, s.T, target, s.valid[target] != 0, s.lo, s.hi,
                    s.Q, s.C, s.carry + int64_t(target) * (s.Q / kWarp),
                    lane);
}

// A warp item: route the dirty spine row's key to its one bucket, then the
// max live row of that bucket with an equal key (-1 if none).
__device__ void probe_warp(const JoinArgs& j, int slot, int lane) {
  const int32_t target = j.rows[slot];
  if (target < 0 || target >= j.Tl) return;          // pad slot: dropped
  const int32_t key = j.keys[target];
  const int b = route_bucket(j.bounds, j.P, key);
  const int rid = probe_bucket(j.bkeys, j.brows, b, j.B, key, lane);
  if (lane == 0) j.rid[target] = rid;
}

// Is row r one of rows[s0, s1)?  (rows ascending)
__device__ __forceinline__ bool is_dirty(const int32_t* __restrict__ rows,
                                         int s0, int s1, int64_t r) {
  const int at = s0 + lower_bound(rows + s0, s1 - s0, r);
  return at < s1 && rows[at] == r;
}

// A warp item: rid[i] = rid_carry[i] over one tile, 16 bytes a lane, the
// rows that a live PROBE slot writes left out.
__device__ void copy_warp(const JoinArgs& j, int tile, bool live, int lane) {
  const int64_t a = int64_t(tile) * kCopyTile;
  const int64_t b = min(a + kCopyTile, int64_t(j.Tl));
  int s0 = 0, s1 = 0;
  if (live) {
    s0 = lower_bound(j.rows, j.D, a);
    s1 = lower_bound(j.rows, j.D, b);
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(j.rid_carry)
                     | reinterpret_cast<uintptr_t>(j.rid)) & 15) == 0;
  for (int64_t i = a + 4 * lane; i < b; i += 4 * kWarp) {
    if (vec && i + 4 <= b && s0 == s1) {
      *reinterpret_cast<int4*>(j.rid + i) =
          *reinterpret_cast<const int4*>(j.rid_carry + i);
      continue;
    }
    for (int e = 0; e < 4 && i + e < b; ++e)
      if (s0 == s1 || !is_dirty(j.rows, s0, s1, i + e))
        j.rid[i + e] = j.rid_carry[i + e];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_delta_kernel(const int32_t* __restrict__ desc, int n_block,
                   int n_items, const __grid_constant__ FusedArgs args) {
  __shared__ int s_w0[kMaxStages], s_span[kMaxStages], s_sdn[kMaxStages];
  __shared__ int s_jdn[kMaxJoins];
  extern __shared__ int2 pairs[];
  const int tid = threadIdx.x;
  if (tid < args.ns) {
    const ScanArgs& s = args.s[tid];
    s_w0[tid] = min(max(*s.w0, 0), s.Q / kWarp - s.A);
    s_span[tid] = *s.span;
    s_sdn[tid] = *s.dn;
  }
  if (tid < args.nj) s_jdn[tid] = *args.j[tid].dn;
  __syncthreads();
  for (int it = blockIdx.x; it < n_block; it += gridDim.x) {
    const int owner = desc[3 * it + 1];              // desc[3 * it] == kPane
    if (s_span[owner] <= 0) continue;                // block-uniform
    pane_tile(args.s[owner], s_w0[owner], desc[3 * it + 2], pairs);
  }
  const int lane = tid % kWarp;
  for (int it = n_block + (tid / kWarp) * gridDim.x + blockIdx.x;
       it < n_items; it += gridDim.x * kWarpsPerBlock) {
    const int kind = desc[3 * it], owner = desc[3 * it + 1],
              idx = desc[3 * it + 2];
    if (kind == kDirty) {
      if (s_sdn[owner] > 0) dirty_warp(args.s[owner], idx, lane);
    } else if (kind == kProbe) {
      if (s_jdn[owner] > 0) probe_warp(args.j[owner], idx, lane);
    } else if (kind == kCopy) {
      copy_warp(args.j[owner], idx, s_jdn[owner] > 0, lane);
    }
  }
}

static_assert(sizeof(FusedArgs) <= 4096, "kernel parameter limit");

// ---------------------------------------------------------------------------
// The chained delta ops: the DIRTY and PROBE items as standalone launches
// ---------------------------------------------------------------------------
//
// delta_scan replaces repro/kernels/fused_delta.py::delta_scan_pallas and
// delta_join replaces ::delta_join_pallas: the backend's scan_delta and
// join_delta, which a backend without fused_delta chains after the pane
// scans.  Unlike the fused blocks they have no live count and write no
// carry: they write ONE output per slot, pad slots included, computed on
// the slot's row clamped into [0, T-1] (the caller's scatter drops the
// pads), as kernels/ref.py's delta_scan_ref / delta_join_ref do.
// delta_join routes its key to a bucket inside the kernel (the reference
// routes in XLA before its kernel).
//
// Each takes every stage / join of a beat in ONE launch (the reference
// launches once per stage and once per join): the rescans and probes are
// independent, and a launch costs ~2.5 us of device time on an H100
// whatever it does (PERF.md section 6), against ~12 ns of bytes for a
// chained beat's seven stages and ~80 ns for its four probes.  The stages
// (joins) travel in one DeltaScanArgs (DeltaJoinArgs) block passed by
// value (a __grid_constant__ parameter), with the prefix sums of their
// slot counts; each slot of the flat slot range finds its stage (join) in
// that prefix (<= 32 steps).  More than one block holds go in more
// launches (kernels/fused_delta.py delta_scan_groups / delta_join_groups).
//
// delta_scan gives a WARP to a slot: its Q/32 words come from 32 lanes as
// queries (full_window_words).  delta_join gives a LANE to a slot: the
// lane clamps the row, routes the key over `bounds` (route_bucket) and
// binary-searches the bucket (common.cuh search_bucket, log2 B + 1
// steps) instead of a warp scanning all B entries (probe_bucket, which
// fused_delta's PROBE items keep: their block-join pseudo-partitions are
// in row order).  Each lane's answer waits on one chain of dependent
// loads (row, key, ~log2 P route steps, ~log2 B search steps) through
// L1 and L2; copying the bounds into shared memory first, or asking for
// the bounds' and the bucket's lines in L1 ahead of the steps, made the
// chained beat's call slower on an H100 (PERF.md section 6).
//
// delta_join's precondition: the buckets are laid out as
// storage.build_key_partitions lays them out (live rows first, by key,
// row ids ascending among equal keys, then rows -1), the chained path's
// only source of them (lowering._build_post_scan probes block joins with
// storage.locate_rows_by_key); the kernel does not check it
// (kernels/partitioned_join.py buckets_ordered does, in the tests and in
// chip_smoke.py).
//
// What bounds them: bytes — D gathered rows' predicate columns, the
// [C, Q] predicate matrices and D*Q/32 output words for the scan; D keys,
// route and search steps and D rids for the probe.  Both are a few
// hundred KB at most on the path, so a launch's floor and, for
// delta_join, its chain of dependent loads are all of it.

constexpr int kMaxDeltaStages = 32;
constexpr int kMaxDeltaJoins = 32;

struct DeltaStage {
  const int32_t* cols;   // [C, T]
  const int32_t* lo;     // [C, Q]
  const int32_t* hi;
  const uint8_t* valid;  // [T]
  const int32_t* rows;   // [D] dirty rows, pads clamp
  int32_t* out;          // [D, Q/32]
  int C, T, Q;
};

struct DeltaScanArgs {
  DeltaStage s[kMaxDeltaStages];
  int start[kMaxDeltaStages + 1];  // stage i owns slots [start[i], start[i+1])
  int ns;
};

static_assert(sizeof(DeltaScanArgs) <= 4096, "kernel parameter limit");

struct DeltaJoin {
  const int32_t* keys;    // [Tl] spine fk column
  const int32_t* rows;    // [D] dirty spine rows, pads clamp
  const int32_t* bkeys;   // [P, B] build_key_partitions' layout
  const int32_t* brows;   // [P, B]
  const int32_t* bounds;  // [P] bucket lower bounds, ascending
  int32_t* out;           // [D] rids
  int Tl, P, B;
};

struct DeltaJoinArgs {
  DeltaJoin j[kMaxDeltaJoins];
  int start[kMaxDeltaJoins + 1];   // join i owns slots [start[i], start[i+1])
  int nj;
};

static_assert(sizeof(DeltaJoinArgs) <= 4096, "kernel parameter limit");

// A warp per slot of the flat range of every stage's slots: the slot's
// clamped row against its stage's FULL window.
__global__ void __launch_bounds__(kThreads)
delta_scan_kernel(const __grid_constant__ DeltaScanArgs args) {
  const int lane = threadIdx.x % kWarp;
  const int total = args.start[args.ns];
  for (int slot = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
       slot < total; slot += gridDim.x * kWarpsPerBlock) {
    int i = 0;
    while (args.start[i + 1] <= slot) ++i;
    const DeltaStage& st = args.s[i];
    const int k = slot - args.start[i];
    const int64_t row = min(max(st.rows[k], 0), st.T - 1);
    full_window_words(st.cols, st.T, row, st.valid[row] != 0, st.lo, st.hi,
                      st.Q, st.C, st.out + int64_t(k) * (st.Q / kWarp),
                      lane);
  }
}

// A lane per slot of the flat range of every join's slots: route the
// clamped spine row's key to its one bucket (searchsorted right, -1,
// clip), then the max live row of that bucket with an equal key (-1 if
// none) by a binary search of the sorted bucket.
__global__ void __launch_bounds__(kThreads)
delta_join_kernel(const __grid_constant__ DeltaJoinArgs args) {
  const int total = args.start[args.nj];
  for (int slot = blockIdx.x * kThreads + threadIdx.x; slot < total;
       slot += gridDim.x * kThreads) {
    int i = 0;
    while (args.start[i + 1] <= slot) ++i;
    const DeltaJoin& j = args.j[i];
    const int k = slot - args.start[i];
    const int32_t key = __ldg(j.keys + min(max(__ldg(j.rows + k), 0),
                                           j.Tl - 1));
    j.out[k] = search_bucket(j.bkeys, j.brows,
                             route_bucket(j.bounds, j.P, key), j.B, key);
  }
}

}  // namespace
}  // namespace shareddb

// `args` points at a host FusedArgs; it is copied into the launch.
// `blocks` and `pane_smem` (the widest stage's pane pairs) come from
// kernels/fused_delta.py; `pane_smem` <= 48 KB.
extern "C" int shareddb_fused_delta(const int32_t* desc, int n_block,
                                    int n_items, int blocks, int pane_smem,
                                    const void* args, cudaStream_t stream) {
  using namespace shareddb;
  if (n_items == 0) return int(cudaGetLastError());
  const FusedArgs& a = *static_cast<const FusedArgs*>(args);
  fused_delta_kernel<<<blocks, kThreads, pane_smem, stream>>>(
      desc, n_block, n_items, a);
  return int(cudaGetLastError());
}

// `args` points at a host DeltaScanArgs of at most kMaxDeltaStages
// stages and a slot or more; it is copied into the launch.  `blocks` comes
// from kernels/fused_delta.py::delta_scan_blocks.
extern "C" int shareddb_delta_scan(const void* args, int blocks,
                                   cudaStream_t stream) {
  using namespace shareddb;
  delta_scan_kernel<<<blocks, kThreads, 0, stream>>>(
      *static_cast<const DeltaScanArgs*>(args));
  return int(cudaGetLastError());
}

// `args` points at a host DeltaJoinArgs of at most kMaxDeltaJoins joins
// and a slot or more; it is copied into the launch.  `blocks` comes from
// kernels/fused_delta.py::delta_join_blocks.
extern "C" int shareddb_delta_join(const void* args, int blocks,
                                   cudaStream_t stream) {
  using namespace shareddb;
  delta_join_kernel<<<blocks, kThreads, 0, stream>>>(
      *static_cast<const DeltaJoinArgs*>(args));
  return int(cudaGetLastError());
}
