// Flash attention for Hopper: causal / sliding-window GQA attention with
// an online softmax in float32, the LM server's prefill attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel).  q [B,Sq,H,D], k/v [B,Sk,KV,D] in bf16 or f32 -> o [B,Sq,H,D]
// in q's type; scale 1/sqrt(D); query i sits at position i + Sk - Sq; head
// h reads kv head h / (H/KV); masked scores are -1e30, so a row that sees
// no key (causal, Sq > Sk) averages v uniformly, as the TPU kernel and the
// plain version do.
//
// What bounds it: at yi-6b's prefill (S 512, H 32, KV 4, D 128, bf16,
// causal) the card's least time is set by bytes, barely: 9.4 MB of q, k,
// v and o take 2.8 us at 3.35 TB/s, the 2.2 GFLOP 2.2 us on the bf16
// tensor cores; from S ~ 1k on (gemma3's 2048-token prefill) operations
// bound it.  This first kernel runs the multiply-adds on the CUDA cores
// in float32 (67 TFLOP/s), so operations bound it at every S; the tensor
// cores are a later change.
//
// Design.  The Pallas grid carries (m, l, acc) in VMEM across its
// sequential key axis; Hopper blocks run in no order, so ONE block owns
// one (b*h, 64-query tile) and loops over its 64-key tiles itself.  The
// block stages the Q tile once and each K/V tile in shared memory as
// float32 (rows padded to D+1 floats: conflict-free column reads), then
//   1. scores: 256 threads, each a 4x4 patch of the 64x64 tile (rows
//      ti+16r, keys tj+16c), masked and written to shared memory;
//   2. softmax: 4 threads per row update the row's running max and sum and
//      turn the scores into probabilities;
//   3. values: each thread keeps a 4 x D/16 patch of the accumulator in
//      registers (32 floats at D = 128), rescales it and adds P.V.
// Key tiles wholly outside a query tile's causal or window range are
// skipped (flash_attention.py::key_tile_range is the same rule); a tile
// holding a row that sees no key visits every key tile, so that row's
// uniform average covers all of v.  Keys past Sk score -inf and weigh 0;
// query rows past Sq are computed on zeros and not stored, so any Sq / Sk
// works.  About 116 KB of dynamic shared memory at D = 128: one block per
// SM.
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

// [*j_lo, *j_hi): the key tiles query tile qt visits
// (flash_attention.py::key_tile_range).
__device__ __forceinline__ void key_tile_range(int qt, int Sq, int Sk,
                                               int causal, int window,
                                               int* j_lo, int* j_hi) {
  const int off = Sk - Sq;
  const int n_k = (Sk + kBlockK - 1) / kBlockK;
  const int p0 = qt * kBlockQ + off;
  const int p1 = min(qt * kBlockQ + kBlockQ, Sq) - 1 + off;
  if (causal && p0 < 0) {
    *j_lo = 0;
    *j_hi = n_k;
    return;
  }
  const int hi = causal ? min(Sk, p1 + 1) : Sk;
  const int lo = window > 0 ? max(0, p0 - window + 1) : 0;
  *j_lo = lo / kBlockK;
  *j_hi = (hi + kBlockK - 1) / kBlockK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  key_tile_range(qt, Sq, Sk, causal, window, &j_lo, &j_hi);
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
  auto kernel = flash_attention_kernel<T, D>;
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
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace shareddb

// is_bf16: 1 for bfloat16 q/k/v/o, 0 for float32.  n_qtiles = ceil(Sq/64).
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
