// Causal-over-cache GQA flash attention for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel `flash_attention` (distributed_llm_pipeline_tpu/
// ops/flash_attention.py, `_flash_kernel`). Same contract:
//   q [B,T,H,Hd] against k, v [B,S,K,Hd] (bf16 or f32 like q, or int8 codes
//   with f32 scales [B,S,K,1]); key c attends query t iff
//   c <= cache_len[b] + t and, when window > 0, cache_len[b] + t - c < window.
//   Output [B,T,H,Hd] in q's dtype.
//
// Design. GQA is folded into query rows as on the TPU: the n_rep heads that
// share one KV head become n_rep consecutive rows, row r at query position
// cache_len + r / n_rep. One block owns one (batch row, KV head) pair and a
// tile of BQ folded rows; it walks the KV tiles from the first one inside the
// window to the last one the causal mask needs, staging each 32-key tile of
// K and V in shared memory (converted to f32, int8 codes dequantized and
// rounded to q's dtype exactly as the TPU kernel does) and keeping an online
// softmax in f32 registers. Lane j of a warp scores key j of the tile against
// the warp's rows; each lane then accumulates Hd/32 output dims per row.
//
// What bounds it. At the main path's shapes the work is below the card's
// ridge point, so the least time is set by the bytes: Q, the live K/V and O.
// This first version is far from that bound. It is scalar f32 FMA work with
// no tensor cores, one block of 4 warps per (row, KV head, query tile), and
// one query row per warp at decode. Each 32-key tile then costs microseconds
// of latency: exposed HBM latency, plus the serial warp shuffles of the
// online softmax. At decode only B*K blocks run (PERF.md has the
// measurements). The planned fast version splits decode's KV walk across
// blocks, pipelines the tile loads with TMA, and runs QK^T and PV on wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked-score fill
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;  // keys per KV tile: one per lane

// rows per warp for long query tiles: keeps the f32 accumulator at 32
// registers a thread. Short ones (decode: T * n_rep <= 4) take one row per
// warp, so no warp walks the KV tiles with padding rows.
constexpr int rows_per_warp(int hd) { return hd == 64 ? 16 : (hd == 128 ? 8 : 4); }

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
// dequantized as (code * scale) and rounded to q's dtype (TPU kernel :83/:111)
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

template <int HD, int ROWS, typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ cache_lens,
             int cache_len_scalar, QT* __restrict__ out, int T, int S, int H,
             int K, int n_rep, float scale, float softcap, int window) {
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
  const int cache_len = cache_lens ? cache_lens[b] : cache_len_scalar;

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
  // its first row to the last column its last row sees causally
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
          const size_t si = (size_t(b) * S + c) * K + kvh;
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

    // scores: lane owns key c0 + lane
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

  // every real row sees its own position, so l > 0
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

template <int HD, int ROWS, typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* cache_lens, int cache_len_scalar,
                   void* out, int B, int T, int S, int H, int K, float scale,
                   float softcap, int window, cudaStream_t stream) {
  using C = Cfg<HD, ROWS>;
  auto kernel = flash_kernel<HD, ROWS, QT, KT>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (attr != cudaSuccess) return attr;
  const int n_rep = H / K;
  const dim3 grid((T * n_rep + C::BQ - 1) / C::BQ, B * K);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, cache_lens, cache_len_scalar,
      static_cast<QT*>(out), T, S, H, K, n_rep, scale, softcap, window);
  return cudaGetLastError();
}

template <int HD, typename QT, typename KT>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* cl, int cls,
                        void* out, int B, int T, int S, int H, int K, float scale,
                        float softcap, int window, cudaStream_t st) {
  if (T * (H / K) <= kWarps)
    return launch<HD, 1, QT, KT>(q, k, v, ks, vs, cl, cls, out, B, T, S, H, K, scale,
                                 softcap, window, st);
  return launch<HD, rows_per_warp(HD), QT, KT>(q, k, v, ks, vs, cl, cls, out, B, T, S,
                                               H, K, scale, softcap, window, st);
}

template <int HD>
cudaError_t dispatch_dtype(int q_dtype, int kv_int8, const void* q, const void* k,
                           const void* v, const float* ks, const float* vs,
                           const int* cl, int cls, void* out, int B, int T, int S,
                           int H, int K, float scale, float softcap, int window,
                           cudaStream_t st) {
  if (q_dtype == 0) {
    return kv_int8 ? launch_rows<HD, float, int8_t>(q, k, v, ks, vs, cl, cls, out, B, T,
                                                    S, H, K, scale, softcap, window, st)
                   : launch_rows<HD, float, float>(q, k, v, ks, vs, cl, cls, out, B, T,
                                                   S, H, K, scale, softcap, window, st);
  }
  return kv_int8
             ? launch_rows<HD, __nv_bfloat16, int8_t>(q, k, v, ks, vs, cl, cls, out, B, T,
                                                      S, H, K, scale, softcap, window, st)
             : launch_rows<HD, __nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, cl, cls, out,
                                                             B, T, S, H, K, scale,
                                                             softcap, window, st);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (k/v share it unless kv_int8 = 1).
// cache_lens: device int32 [B], or null to use cache_len_scalar for every row.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_flash_attention(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale,
                                   const int* cache_lens, int cache_len_scalar,
                                   void* out, int B, int T, int S, int H, int K,
                                   int Hd, int q_dtype, int kv_int8, float scale,
                                   float softcap, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hd) {
    case 64:
      return dispatch_dtype<64>(q_dtype, kv_int8, q, k, v, k_scale, v_scale, cache_lens,
                                cache_len_scalar, out, B, T, S, H, K, scale, softcap,
                                window, st);
    case 128:
      return dispatch_dtype<128>(q_dtype, kv_int8, q, k, v, k_scale, v_scale,
                                 cache_lens, cache_len_scalar, out, B, T, S, H, K,
                                 scale, softcap, window, st);
    case 256:
      return dispatch_dtype<256>(q_dtype, kv_int8, q, k, v, k_scale, v_scale,
                                 cache_lens, cache_len_scalar, out, B, T, S, H, K,
                                 scale, softcap, window, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
