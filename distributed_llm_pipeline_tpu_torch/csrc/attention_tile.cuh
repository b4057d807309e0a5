// The causal-over-cache GQA attention kernel over the dense KV layout
// (flash_attention.cu; the paged and latent kernels are paged_tile.cuh's).
//
// Contract: q [B,T,H,Hd] attends key columns c of its batch
// row b, where c attends query t iff c <= lens[b] + t and, when window > 0,
// lens[b] + t - c < window. Scores are scaled, soft-capped before the mask
// and soft-maxed in f32; the output [B,T,H,Hd] has q's dtype. K/V are bf16
// or f32 like q, or int8 codes with one f32 scale per head vector, each value
// dequantized as (code * scale) and rounded to q's dtype before the dot.
//
// An addressing policy (DenseKV) maps (b, c, kv head) to the index of the
// head vector of column c in the K/V arrays (and of its scale).
//
// Design. GQA is folded into query rows: the n_rep heads that share one KV
// head become n_rep consecutive rows, row r at query position lens + r /
// n_rep. One block owns one (batch row, KV head) pair and a tile of BQ
// folded rows; it walks the 32-column KV tiles from the first one inside the
// window to the last one the causal mask needs, staging each tile of K and V
// in shared memory (converted to f32) and keeping an online softmax in f32
// registers. Lane j of a warp scores column j of the tile against the warp's
// rows; each lane then accumulates Hd/32 output dims per row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlp_attn {

constexpr float kNegInf = -1e30f;  // the TPU kernels' masked-score fill
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;  // columns per KV tile: one per lane

// rows per warp for long query tiles: keeps the f32 accumulator at 32
// registers a thread. Short ones (decode: T * n_rep <= 4) take one row per
// warp, so no warp walks the KV tiles with padding rows.
constexpr int rows_per_warp(int hd) { return hd == 64 ? 16 : (hd == 128 ? 8 : 4); }

// dense cache: k/v [B, S, K, Hd], scales [B, S, K, 1]
struct DenseKV {
  int S;
  __device__ __forceinline__ size_t vec(int b, int c, int K, int kvh) const {
    return (size_t(b) * S + c) * K + kvh;
  }
};

template <int HD, int ROWS>
struct Cfg {
  static constexpr int RPW = ROWS;         // folded query rows per warp
  static constexpr int BQ = kWarps * RPW;  // folded query rows per block
  static constexpr int LD = HD + 4;        // padded smem row: no bank conflicts
  static constexpr int DPL = HD / 32;      // output dims per lane
  static constexpr int PER_THREAD = kBK * HD / kThreads;  // K (and V) elements
  static constexpr int BATCH = 16;         // loads in flight per thread and side
  static constexpr size_t SMEM = size_t(BQ + 2 * kBK) * LD * sizeof(float);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one K/V element as the dot sees it: dense values as stored; int8 codes
// dequantized as (code * scale) and rounded to q's dtype, as the TPU kernels
// do
template <typename QT, typename KT>
__device__ __forceinline__ float kv_value(const KT* p, size_t i, const float* s,
                                          size_t si) {
  if constexpr (sizeof(KT) == 1) {
    return to_f32(from_f32<QT>(to_f32(p[i]) * s[si]));
  } else {
    return to_f32(p[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// S: columns per batch row
template <int HD, int ROWS, typename QT, typename KT, typename KV>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                 const KT* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, KV kv, int S,
                 const int* __restrict__ lens, int len_scalar,
                 QT* __restrict__ out, int T, int H, int K, int n_rep,
                 float scale, float softcap, int window) {
  using C = Cfg<HD, ROWS>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + C::BQ * C::LD;               // [kBK][LD]
  float* Vs = Ks + kBK * C::LD;                 // [kBK][LD]

  const int b = blockIdx.y / K;
  const int kvh = blockIdx.y % K;
  const int Tq = T * n_rep;
  const int q0 = blockIdx.x * C::BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cache_len = lens ? lens[b] : len_scalar;

  // stage this block's folded query rows (rows past Tq are zeros)
  for (int i = tid; i < C::BQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD, r = q0 + rr;
    float x = 0.f;
    if (r < Tq) {
      const int t = r / n_rep, h = kvh * n_rep + r % n_rep;
      x = to_f32(q[((size_t(b) * T + t) * H + h) * HD + d]);
    }
    Qs[rr * C::LD + d] = x;
  }

  // KV tiles this block needs: from the first column inside the window of
  // its first row to the last column its last row sees causally (a parked
  // row's position may pass S: the walk stops at S)
  const int last_pos = cache_len + (min(q0 + C::BQ, Tq) - 1) / n_rep;
  const int kv_end = min(S, last_pos + 1);
  const int kv_begin = window > 0 ? max(0, cache_len + q0 / n_rep - window + 1) : 0;

  float m[C::RPW], l[C::RPW], acc[C::RPW][C::DPL];
  int pos[C::RPW];
#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    const int r = q0 + warp * C::RPW + i;
    pos[i] = r < Tq ? cache_len + r / n_rep : -1;  // -1: padding row sees nothing
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DPL; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = (kv_begin / kBK) * kBK; c0 < kv_end; c0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Qs is staged)
    // stage the tile in batches of BATCH elements a thread: every load of a
    // batch is issued before its first store, so a batch costs one memory
    // latency (a load-then-store loop costs one per element)
#pragma unroll
    for (int n0 = 0; n0 < C::PER_THREAD; n0 += C::BATCH) {
      float kx[C::BATCH], vx[C::BATCH];
#pragma unroll
      for (int n = 0; n < C::BATCH; ++n) {
        const int i = tid + (n0 + n) * kThreads, c = c0 + i / HD;
        kx[n] = vx[n] = 0.f;  // the ragged tail is zero-filled
        if (c < S) {
          const size_t si = kv.vec(b, c, K, kvh);
          kx[n] = kv_value<QT>(k, si * HD + i % HD, ks, si);
          vx[n] = kv_value<QT>(v, si * HD + i % HD, vs, si);
        }
      }
#pragma unroll
      for (int n = 0; n < C::BATCH; ++n) {
        const int i = tid + (n0 + n) * kThreads;
        Ks[(i / HD) * C::LD + i % HD] = kx[n];
        Vs[(i / HD) * C::LD + i % HD] = vx[n];
      }
    }
    __syncthreads();

    // scores: lane owns column c0 + lane
    const int c = c0 + lane;
    float s[C::RPW];
#pragma unroll
    for (int i = 0; i < C::RPW; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * C::LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int i = 0; i < C::RPW; ++i) {
        const float4 qq =
            reinterpret_cast<const float4*>(Qs + (warp * C::RPW + i) * C::LD)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // online softmax; softcap applies before the mask, as on the TPU
#pragma unroll
    for (int i = 0; i < C::RPW; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool visible =
          c < S && c <= pos[i] && (window == 0 || pos[i] - c < window);
      x = visible ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      // a fully masked tile has m_new == kNegInf and exp(x - m_new) == 1:
      // zero it through `visible` so it cannot poison l
      const float p = visible ? expf(x - m_new) : 0.f;
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::DPL; ++j) acc[i][j] *= alpha;
      s[i] = p;
    }

    // acc += P V: lane accumulates dims lane + 32 * j
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float vv[C::DPL];
#pragma unroll
      for (int j = 0; j < C::DPL; ++j) vv[j] = Vs[key * C::LD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < C::RPW; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], key);
#pragma unroll
        for (int j = 0; j < C::DPL; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  // every real row sees its own position (or, parked past S, all S
  // columns), so l > 0
#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    const int r = q0 + warp * C::RPW + i;
    if (r >= Tq) continue;
    const int t = r / n_rep, h = kvh * n_rep + r % n_rep;
    QT* o = out + ((size_t(b) * T + t) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < C::DPL; ++j) o[lane + 32 * j] = from_f32<QT>(acc[i][j] / l[i]);
  }
}

// the launch arguments every instantiation shares
template <typename KV>
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  KV kv;
  int S;
  const int* lens;
  int len_scalar;
  void* out;
  int B, T, H, K;
  float scale, softcap;
  int window;
  cudaStream_t stream;
};

template <int HD, int ROWS, typename QT, typename KT, typename KV>
cudaError_t launch(const Args<KV>& a) {
  using C = Cfg<HD, ROWS>;
  auto kernel = attention_kernel<HD, ROWS, QT, KT, KV>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (attr != cudaSuccess) return attr;
  const int n_rep = a.H / a.K;
  const dim3 grid((a.T * n_rep + C::BQ - 1) / C::BQ, a.B * a.K);
  kernel<<<grid, kThreads, C::SMEM, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.ks, a.vs, a.kv, a.S, a.lens, a.len_scalar,
      static_cast<QT*>(a.out), a.T, a.H, a.K, n_rep, a.scale, a.softcap, a.window);
  return cudaGetLastError();
}

template <int HD, typename QT, typename KT, typename KV>
cudaError_t launch_rows(const Args<KV>& a) {
  if (a.T * (a.H / a.K) <= kWarps) return launch<HD, 1, QT, KT>(a);
  return launch<HD, rows_per_warp(HD), QT, KT>(a);
}

template <int HD, typename KV>
cudaError_t dispatch_dtype(int q_dtype, int kv_int8, const Args<KV>& a) {
  if (q_dtype == 0) {
    return kv_int8 ? launch_rows<HD, float, int8_t>(a) : launch_rows<HD, float, float>(a);
  }
  return kv_int8 ? launch_rows<HD, __nv_bfloat16, int8_t>(a)
                 : launch_rows<HD, __nv_bfloat16, __nv_bfloat16>(a);
}

// q_dtype: 0 = float32, 1 = bfloat16 (K/V share it unless kv_int8 = 1).
// Head widths 64, 128 and 256; WIDE adds 512, the latent rank that is full
// rank at Llama-3.2-1B (Cfg<512, 4>: 80 rows of 516 floats, 165 KB of
// shared memory), instantiated by flash_attention.cu for the single-stream
// latent path.
// Returns the cudaError_t of the launch (0 = launched).
template <bool WIDE = false, typename KV>
int dispatch(int Hd, int q_dtype, int kv_int8, const Args<KV>& a) {
  switch (Hd) {
    case 64:
      return int(dispatch_dtype<64>(q_dtype, kv_int8, a));
    case 128:
      return int(dispatch_dtype<128>(q_dtype, kv_int8, a));
    case 256:
      return int(dispatch_dtype<256>(q_dtype, kv_int8, a));
    case 512:
      if constexpr (WIDE) return int(dispatch_dtype<512>(q_dtype, kv_int8, a));
      return int(cudaErrorInvalidValue);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace dlp_attn
