// Flash attention for Hopper: causal, sliding-window or full (an
// encoder's, a cross sublayer's) GQA attention with an online softmax,
// the LM server's prefill attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel).  q [B,Sq,H,D], k/v [B,Sk,KV,D] -> o [B,Sq,H,D] in q's type;
// scale 1/sqrt(D); query i sits at position i + Sk - Sq; head h reads kv
// head h / (H/KV); masked scores are -1e30 and the running max starts at
// -1e30, so a row that sees no key (causal, Sq > Sk) averages v
// uniformly, as the TPU kernel and the plain version do; keys past Sk
// score -inf.  Key tiles wholly outside a query tile's causal or window
// range are skipped (flash_attention.py::key_tile_range is the same rule;
// a tile holding a row that sees no key visits every key tile).  Any Sq /
// Sk: ragged tails are masked, rows past Sq are not stored.
//
// Two kernels; the wrapper (flash_attention.py::route) picks one from the
// dtype and D alone, and never retries on the other:
//
// flash_attention_wgmma_kernel (bf16, D 64 / 128 / 256: every LM config
// the port serves).  What bounds it: at yi-6b's prefill (S 512, H 32, KV
// 4, D 128, causal) bytes and FLOPs nearly tie on the card (9.4 MB of q,
// k, v, o in 2.8 us at 3.35 TB/s; 2.2 GFLOP in 2.2 us at 989 TFLOP/s);
// from S ~ 1k on (gemma3's 2048-token prefill, ~26-34 GFLOP a layer)
// FLOPs bound it.  So both products run on the tensor cores through
// wgmma (S = Q.K^T from shared memory, O += P.V with P from registers),
// the f32 scores and output stay in registers (online softmax reduced
// over the 4 lanes that share a row, no round trip through shared
// memory), and K / V stay bf16 in a 3-stage ring of 128-byte swizzled
// tiles that one producer warp fills with TMA copies, so loads overlap
// the products.  Softmax runs on the CUDA cores, so it is hidden under
// tensor-core work twice: within a warpgroup, key tile n's Q.K^T and tile
// n-1's P.V are in flight while tile n's softmax runs; across the two
// consumer warpgroups, which take turns to issue their products (named
// barriers), one's softmax runs under the other's products.  128-query
// tiles over 64-key tiles; the grid launches the heaviest (last) causal
// query tiles of every head first, so the tail of a wave is light tiles.
// At D 256 (recurrentgemma's 10 heads over 1) a block holds one consumer
// warpgroup and 64-query tiles (WgSmem: registers and shared memory), so
// only the in-warpgroup overlap remains.
//
// flash_attention_simt_kernel (float32 at any D, bf16 at D 16 / 32): the
// multiply-adds on the CUDA cores in float32 (67 TFLOP/s).  float32 stays
// here because its tests hold it at rtol 1e-5, which bf16 or TF32
// products cannot meet.  One block owns one (b*h, 64-query tile) and
// loops over its 64-key tiles.  The block stages the Q tile once and each
// K/V tile in shared memory as float32 (rows padded to D+1 floats:
// conflict-free column reads), then
//   1. scores: 256 threads, each a 4x4 patch of the 64x64 tile (rows
//      ti+16r, keys tj+16c), masked and written to shared memory;
//   2. softmax: 4 threads per row update the row's running max and sum and
//      turn the scores into probabilities;
//   3. values: each thread keeps a 4 x D/16 patch of the accumulator in
//      registers (32 floats at D = 128), rescales it and adds P.V.
// About 116 KB of dynamic shared memory at D = 128, 215 KB at D = 256:
// one block per SM.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace shareddb {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockQ + 2 * kBlockK) * (D + 1) +
          size_t(kBlockQ) * (kBlockK + 1) + 3 * kBlockQ);
}

// [*j_lo, *j_hi): the key tiles (of BK keys) that query tile qt (of BQ
// rows) visits (flash_attention.py::key_tile_range, the same rule).
template <int BQ, int BK>
__device__ __forceinline__ void key_tile_range(int qt, int Sq, int Sk,
                                               int causal, int window,
                                               int* j_lo, int* j_hi) {
  const int off = Sk - Sq;
  const int n_k = (Sk + BK - 1) / BK;
  const int p0 = qt * BQ + off;
  const int p1 = min(qt * BQ + BQ, Sq) - 1 + off;
  if (causal && p0 < 0) {
    *j_lo = 0;
    *j_hi = n_k;
    return;
  }
  const int hi = causal ? min(Sk, p1 + 1) : Sk;
  const int lo = window > 0 ? max(0, p0 - window + 1) : 0;
  *j_lo = lo / BK;
  *j_hi = (hi + BK - 1) / BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int DP = D + 1;           // padded row of Q / K / V
  constexpr int SP = kBlockK + 1;     // padded row of the score tile
  constexpr int DT = D / 16;          // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                           // [kBlockQ][DP]
  float* sK = sQ + kBlockQ * DP;              // [kBlockK][DP]
  float* sV = sK + kBlockK * DP;              // [kBlockK][DP]
  float* sS = sV + kBlockK * DP;              // [kBlockQ][SP]
  float* sM = sS + kBlockQ * SP;              // running max  [kBlockQ]
  float* sL = sM + kBlockQ;                   // running sum  [kBlockQ]
  float* sC = sL + kBlockQ;                   // rescale      [kBlockQ]

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int qt = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  const int off = Sk - Sq;
  const int64_t q_row = int64_t(H) * D;       // q / o stride per position
  const int64_t k_row = int64_t(KV) * D;      // k / v stride per position
  const T* qb = q + int64_t(b) * Sq * q_row + int64_t(h) * D;
  const T* kb = k + int64_t(b) * Sk * k_row + int64_t(kvh) * D;
  const T* vb = v + int64_t(b) * Sk * k_row + int64_t(kvh) * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int i = q0 + r;
    sQ[r * DP + d] = i < Sq ? to_float(qb[i * q_row + d]) : 0.f;
  }
  if (tid < kBlockQ) {
    sM[tid] = kMasked;
    sL[tid] = 0.f;
  }
  float acc[4][DT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[r][c] = 0.f;

  int j_lo, j_hi;
  key_tile_range<kBlockQ, kBlockK>(qt, Sq, Sk, causal, window, &j_lo,
                                   &j_hi);
  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * kBlockK;
    __syncthreads();          // the last tile's K / V / P reads are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int j = k0 + r;
      const bool in = j < Sk;
      sK[r * DP + d] = in ? to_float(kb[j * k_row + d]) : 0.f;
      sV[r * DP + d] = in ? to_float(vb[j * k_row + d]) : 0.f;
    }
    __syncthreads();

    // 1. scores of rows ti + 16r against keys tj + 16c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = sQ[(ti + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) ka[c] = sK[(tj + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ti + 16 * r;
      const int qpos = q0 + row + off;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tj + 16 * c;
        const int kpos = k0 + key;
        float x;
        if (kpos >= Sk) {
          x = -INFINITY;             // no such key: weighs exactly 0
        } else {
          bool ok = !causal || qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          x = ok ? s[r][c] * scale : kMasked;
        }
        sS[row * SP + key] = x;
      }
    }
    __syncthreads();

    // 2. online softmax: 4 lanes per row, keys part, part + 4, ...
    {
      const int row = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < kBlockK; c += 4) mx = fmaxf(mx, sS[row * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kBlockK; c += 4) {
        const float p = expf(sS[row * SP + c] - m_new);
        sS[row * SP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFullMask, sum, 1);
      sum += __shfl_xor_sync(kFullMask, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        sL[row] = sL[row] * corr + sum;
        sM[row] = m_new;
        sC[row] = corr;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P.V on rows ti + 16r, columns tj + 16c
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = sC[ti + 16 * r];
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[r][c] *= corr;
    }
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sS[(ti + 16 * r) * SP + key];
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float x = sV[key * DP + tj + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], x, acc[r][c]);
      }
    }
  }
  __syncthreads();
  T* ob = o + int64_t(b) * Sq * q_row + int64_t(h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ti + 16 * r;
    const int i = q0 + row;
    if (i >= Sq) continue;
    const float l = fmaxf(sL[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < DT; ++c)
      store(&ob[i * q_row + tj + 16 * c], acc[r][c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int n_qtiles, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_simt_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(n_qtiles, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, 1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int D, int causal, int window,
             int n_qtiles, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, n_qtiles, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, n_qtiles, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, n_qtiles, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                    window, n_qtiles, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                    window, n_qtiles, stream);
    default: return int(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D 64, 128 or 256
// (flash_attention_wgmma_kernel).
// ---------------------------------------------------------------------------

constexpr int kWgBlockK = 64;
constexpr int kWgStages = 3;        // K/V ring depth
constexpr int kSwizzleCols = 64;    // bf16 columns in one 128-byte row
constexpr float kLog2e = 1.4426950408889634f;

// The tensor-core kernel's geometry at head dim D: consumer warpgroups of
// 64 query rows each, two at D 64 / 128 (128-query tiles), one at D 256
// (64-query tiles): there a lane's float32 O accumulator alone is 128
// registers, which fits beside the scores and P only in a block of one
// consumer warpgroup and the producer warp (255 registers a thread, where
// two consumers would cap them at 224), and the ring of three 64-key
// stages of K and V (192 KB) leaves room for a 64-row Q tile only.
template <int D>
struct WgSmem {
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;     // query rows a block
  static constexpr int kThreads = kConsumers * 128 + 32;  // + the producer
  static constexpr int kHalves = D / kSwizzleCols;
  static constexpr int kQ = kBlockQ * D * 2;          // bytes of the Q tile
  static constexpr int kKV = kWgBlockK * D * 2;       // bytes of a K or V tile
  static constexpr int kBarOffset = kWgStages * kKV * 2 + kQ;
  // tiles, then 1 + 2 * stages mbarriers; + 1024 to align the base
  static constexpr size_t kBytes = size_t(kBarOffset) + 8 * (1 + 2 * kWgStages)
                                   + 1024;
};

// Named barriers 1 + w (w = 0, 1) order the two consumer warpgroups'
// wgmma issues (D 64 / 128); 0 is __syncthreads'.
__device__ __forceinline__ void wg_turn_wait(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void wg_turn_pass(int w) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + w), "n"(2 * 128) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-d tensor map (d, head, position, batch) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int head, int pos, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head), "r"(pos),
      "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[32] (+)= A (shared, K-major) . B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (registers, 4 x bf16x2) . B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers, 4 x bf16x2) . B (shared, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q.K^T of one key tile (issued, not committed): m64n64k16 x D/16,
// both operands K-major in shared memory (the Q tile's 64-column halves
// of BQ rows each), 16 columns = 32 bytes a step; the first step
// overwrites sc.
template <int D, int BQ>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t kb) {
  constexpr int kRow = kSwizzleCols * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, at = (kk % 4) * 32;
    wgmma_ss_n64(sc, wg_desc(qa + half * BQ * kRow + at, 16, 1024),
                 wg_desc(kb + half * kWgBlockK * kRow + at, 16, 1024),
                 kk > 0);
  }
}

// O += P.V of one key tile (issued, not committed): m64nDk16 x 4, A = P
// from registers, B = V read MN-major; 16 keys = 16 swizzled rows a step,
// LBO steps to the next 64 columns of D.  D 256 takes two m64n128k16 a
// step, on columns 0-127 (acc[0..63]) and 128-255 (acc[64..127]): the
// fragment stays the one of a 256-column accumulator.
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pa,
                                         uint32_t vb) {
  constexpr int kRow = kSwizzleCols * 2;
#pragma unroll
  for (int kk = 0; kk < kWgBlockK / 16; ++kk) {
    const uint64_t db = wg_desc(vb + kk * 16 * kRow, kWgBlockK * kRow, 1024);
    if constexpr (D == 256) {
      wgmma_rs_n128(acc, pa + 4 * kk, db);
      wgmma_rs_n128(acc + 64, pa + 4 * kk,
                    wg_desc(vb + 2 * kWgBlockK * kRow + kk * 16 * kRow,
                            kWgBlockK * kRow, 1024));
    } else if constexpr (D == 128) {
      wgmma_rs_n128(acc, pa + 4 * kk, db);
    } else {
      wgmma_rs_n64(acc, pa + 4 * kk, db);
    }
  }
}

// The online softmax of one 64-key score tile, in place (accumulator
// fragment of a lane: element i is row r0 + 8 * ((i >> 1) & 1), key k0 +
// 8 * (i >> 2) + c0 + (i & 1)).  Scales into the log2 domain and masks:
// keys past Sk weigh 0 (-inf), keys out of the causal or window range
// score -1e30; a tile that every row of the warpgroup (first row q0) sees
// in full skips the masks.  Moves each row's running max m (reduced over
// the 4 lanes that hold the row) to this tile, scales the running sum l
// and sets corr, the factor that moves an accumulator summed under the
// old max, and leaves P = exp2(S - m) in float32 in sc.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* corr, int k0, int q0,
                                             int r0, int c0, int off, int Sk,
                                             int causal, int window,
                                             float scale_log2) {
  const bool whole = k0 + kWgBlockK <= Sk &&
                     (!causal || k0 + kWgBlockK - 1 <= q0 + off) &&
                     (window <= 0 || q0 + 63 + off - k0 < window);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
  if (!whole) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qpos = r0 + 8 * ((i >> 1) & 1) + off;
      const int kpos = k0 + 8 * (i >> 2) + c0 + (i & 1);
      bool ok = !causal || qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      sc[i] = kpos >= Sk ? -INFINITY : (ok ? sc[i] : kMasked);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    corr[r] = exp2f(m[r] - mx);
    m[r] = mx;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
}

// P rounded to bf16 into wgmma's A fragment (register t holds elements 2t
// and 2t+1, row r0 + 8 * (t & 1); k-step kk takes registers 4kk..4kk+3);
// l adds the rounded values, as P.V sums them.
__device__ __forceinline__ void to_a_fragment(const float* sc, uint32_t* pa,
                                              float* l) {
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(sc[2 * t], sc[2 * t + 1]);
    l[t & 1] += __low2float(p) + __high2float(p);
    pa[t] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

// One block: a (b*h, query tile of L::kBlockQ rows); warps 0-7 are two
// consumer warpgroups of 64 query rows each (D 64 / 128; at D 256 warps
// 0-3 are the one consumer warpgroup), the next warp the producer.  The producer
// loads the Q tile once and the K / V tiles of key_tile_range into a ring
// of kWgStages stages (TMA, 128-byte swizzle, one "full" mbarrier per
// stage); each consumer warp frees a stage (its "empty" mbarrier) once its
// P.V product has read it.  A consumer warpgroup, per key tile:
//   S = Q.K^T   wgmma m64n64k16 x D/16, both operands in shared memory
//               (K-major), the f32 scores in registers (issue_qk);
//   softmax     scale folded into log2 e, masks, the running max of each
//               row reduced over the 4 lanes that hold it, P = exp2(S - m)
//               (softmax_tile), rounded to bf16 into wgmma's A-fragment
//               registers, the row sum taken over the rounded values
//               (to_a_fragment);
//   O += P.V    wgmma m64nDk16 x 4, A = P from registers, B = V from shared
//               memory read MN-major (the descriptor's transpose bit;
//               issue_pv).
// P enters the A-fragment registers only after both products of the
// round have completed: a register that a wgmma in flight may read and
// that other instructions write makes ptxas serialise every wgmma.
template <int D>
__global__ void __launch_bounds__(WgSmem<D>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                             int H, int KV, int causal, int window,
                             float scale_log2) {
  using L = WgSmem<D>;
  constexpr int kRow = kSwizzleCols * 2;           // bytes of a swizzled row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                        // [D/64][kBlockQ][64]
  const uint32_t sK = sQ + L::kQ;                  // stage s: + s * kKV
  const uint32_t sV = sK + kWgStages * L::kKV;     // [D/64][64 keys][64]
  const uint32_t bar_q = base + L::kBarOffset;
  const uint32_t bar_full = bar_q + 8;             // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kWgStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;       // heaviest tiles first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  int j_lo, j_hi;
  key_tile_range<L::kBlockQ, kWgBlockK>(qt, Sq, Sk, causal, window, &j_lo,
                                        &j_hi);
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, L::kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == L::kConsumers * 4) {                 // the producer warp
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int half = 0; half < L::kHalves; ++half)
        tma_load(sQ + half * L::kBlockQ * kRow, &tq, half * kSwizzleCols, h,
                 qt * L::kBlockQ, b, bar_q);
      for (int j = j_lo; j < j_hi; ++j) {
        const int n = j - j_lo, s = n % kWgStages;
        if (n >= kWgStages)
          mbar_wait(bar_empty + 8 * s, (n / kWgStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::kKV);
        for (int half = 0; half < L::kHalves; ++half) {
          const uint32_t at = s * L::kKV + half * kWgBlockK * kRow;
          tma_load(sK + at, &tk, half * kSwizzleCols, kvh, j * kWgBlockK, b,
                   full);
          tma_load(sV + at, &tv, half * kSwizzleCols, kvh, j * kWgBlockK, b,
                   full);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int off = Sk - Sq;
  const int q0 = qt * L::kBlockQ + wg * 64;        // the warpgroup's row 0
  const int r0 = q0 + (warp % 4) * 16 + lane / 4;  // this lane: r0, r0 + 8
  const int c0 = (lane % 4) * 2;                   // its column pair
  float acc[D / 2];                                // O, fragment as S's
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[16];
  const uint32_t qa = sQ + wg * 64 * kRow;
  mbar_wait(bar_q, 0);
  {
    float sc[32];
    mbar_wait(bar_full, 0);
    wg_fence();
    issue_qk<D, L::kBlockQ>(sc, qa, sK);
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(sc);
    softmax_tile(sc, m, l, corr, j_lo * kWgBlockK, q0, r0, c0, off, Sk,
                 causal, window, scale_log2);
    to_a_fragment(sc, pa, l);
  }
  // Key tile n's S = Q.K^T runs on the tensor cores while tile n-1's P.V
  // is issued behind it and tile n's softmax runs on the CUDA cores; P
  // enters wgmma's registers only once both products are done.  The two
  // warpgroups take turns to issue (warpgroup 0 first), so one's softmax
  // runs under the other's products.
  constexpr bool kTurns = L::kConsumers == 2;
  if (kTurns && wg == 1 && j_hi - j_lo > 1) wg_turn_pass(0);
  for (int j = j_lo + 1; j < j_hi; ++j) {
    const int n = j - j_lo, s = n % kWgStages;
    const int prev = (n - 1) % kWgStages;
    float sc[32];
    mbar_wait(bar_full + 8 * s, (n / kWgStages) & 1);
    if (kTurns) wg_turn_wait(wg);
    wg_fence();
    issue_qk<D, L::kBlockQ>(sc, qa, sK + s * L::kKV);
    wg_commit();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    fence_regs<D / 2>(acc);
    wg_fence();
    issue_pv<D>(acc, pa, sV + prev * L::kKV);
    wg_commit();
    if (kTurns && (wg == 0 || j + 1 < j_hi)) wg_turn_pass(1 - wg);
    wg_wait<1>();
    fence_regs<32>(sc);
    softmax_tile(sc, m, l, corr, j * kWgBlockK, q0, r0, c0, off, Sk,
                 causal, window, scale_log2);
    wg_wait<0>();
    fence_regs<D / 2>(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
    to_a_fragment(sc, pa, l);
  }
  const int last = (j_hi - 1 - j_lo) % kWgStages;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
  fence_regs<D / 2>(acc);
  wg_fence();
  issue_pv<D>(acc, pa, sV + last * L::kKV);
  wg_commit();
  wg_wait<0>();
  fence_regs<D / 2>(acc);
  if (lane == 0) mbar_arrive(bar_empty + 8 * last);

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + int64_t(b) * Sq * H * D + int64_t(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + 8 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const float* a = acc + 4 * jn + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(i) * H * D + 8 * jn +
                                         c0) =
          __floats2bfloat162_rn(a[0] / den[r], a[1] / den[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// A bf16 [B, S, heads, D] tensor as a 4-d map (d, head, position, batch)
// whose box is 64 columns of one head over `rows` positions, 128-byte
// swizzled; positions past S read as zeros.
int encode_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
               int D, int rows) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(S) * heads * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(kSwizzleCols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 int n_qtiles, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  using L = WgSmem<D>;
  int err = encode_map(&tq, q, B, Sq, H, D, L::kBlockQ);
  if (!err) err = encode_map(&tk, k, B, Sk, KV, D, kWgBlockK);
  if (!err) err = encode_map(&tv, v, B, Sk, KV, D, kWgBlockK);
  if (err) return err;
  constexpr size_t smem = L::kBytes;
  auto kernel = flash_attention_wgmma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(B * H, n_qtiles);
  kernel<<<grid, L::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, causal,
      window, kLog2e / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace shareddb

// is_bf16: 1 for bfloat16 q/k/v/o, 0 for float32; D 16, 32, 64, 128 or
// 256.  n_qtiles = ceil(Sq/64).
extern "C" int shareddb_flash_attention(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int Sq, int Sk, int H, int KV, int D,
                                        int causal, int window, int is_bf16,
                                        int n_qtiles, cudaStream_t stream) {
  using namespace shareddb;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                   window, n_qtiles, stream);
  return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window,
                         n_qtiles, stream);
}

// Dynamic shared memory of the tensor-core kernel at head dim D, bytes.
extern "C" int shareddb_flash_attention_wgmma_smem(int D) {
  using namespace shareddb;
  return D == 64    ? int(WgSmem<64>::kBytes)
         : D == 128 ? int(WgSmem<128>::kBytes)
         : D == 256 ? int(WgSmem<256>::kBytes)
                    : 0;
}

// bf16 q/k/v/o (16-byte aligned), D 64, 128 or 256; n_qtiles =
// ceil(Sq/128) at D 64 / 128, ceil(Sq/64) at D 256.
extern "C" int shareddb_flash_attention_wgmma(const void* q, const void* k,
                                              const void* v, void* o, int B,
                                              int Sq, int Sk, int H, int KV,
                                              int D, int causal, int window,
                                              int n_qtiles,
                                              cudaStream_t stream) {
  using namespace shareddb;
  if (D == 64)
    return launch_wgmma<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                            n_qtiles, stream);
  if (D == 128)
    return launch_wgmma<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                             n_qtiles, stream);
  if (D == 256)
    return launch_wgmma<256>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                             n_qtiles, stream);
  return int(cudaErrorInvalidValue);
}
