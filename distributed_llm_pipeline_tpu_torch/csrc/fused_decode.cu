// The fused decode step of one layer's attention half for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the TPU kernel `fused_decode_attn` (distributed_llm_pipeline_tpu/
// ops/fused_decode.py, `_fused_kernel`). Same contract, for x [B, D] at one
// new token per row (T = 1):
//   h = RMSNorm(x) * norm_w, rounded to the activation dtype;
//   q, k, v = h @ wq, wk, wv over dense weights (the activation dtype) or
//   q8_0 packs (int8 codes, one bf16 scale per 32 along D; a weight is
//   code * scale rounded to the activation dtype, as `_deq_q8`);
//   RoPE (interleaved or half pairs) on q and k, each product rounded to the
//   activation dtype before it and the result after it, as the unfused step
//   rounds them;
//   attention of each query head over the pool positions [0, lengths[b])
//   through the block tables (bf16/f32 pools, or int8 codes with f32 scales,
//   each value dequantized as code * scale rounded to the activation
//   dtype), with window and softcap, plus the new token's own diagonal term:
//   on an int8 pool it goes through the same quantize round trip as the pool
//   write (scale = amax * f32(1/127), codes rounded half to even, rintf);
//   y = x + O-proj(attention), the f32 head sum rounded to the activation
//   dtype before the residual add.
//   Outputs y [B, D], and k_new / v_new [B, K, Hd] (post-rope, pre-quant)
//   for the caller's pool scatter.
//
// Design. One block per kv head g owns all B rows, so every weight element
// is read from device memory once per step (the TPU grid's head-outer
// order). In the block, 16 warps:
//   1. normalize x into shared memory h [B, D] (activation dtype);
//   2. run the head's Q, K and V rows (R*Hd + 2*Hd of them) as warp-per-row
//      matvecs against all B rows of h (8 rows per pass; each lane loads 8
//      weights at a time, 16 bytes of bf16);
//   3. apply RoPE pairwise, round, write k_new / v_new, and on an int8 pool
//      round-trip the diagonal K/V through the pool's quantizer;
//   4. attend: one task per (batch row, 4 query heads); when there are
//      fewer tasks than warps, each task's 32-column tiles are dealt out
//      over several warps whose online-softmax partials (m, l, acc) are
//      merged in shared memory in warp order; then the diagonal term;
//   5. the head's O-projection partial [B, D] (warp per output row over the
//      head group's R*Hd columns of wo) goes to a [K, B, D] f32 workspace.
// The TPU grid runs in order and carries the cross-head sum in scratch;
// blocks here run in no order. So the sum is a last-block reduction: every
// block fences its partials and takes a ticket from an atomic counter; the
// block that takes the last ticket sums the K partials in head order
// 0..K-1 (no float atomics: the sum does not depend on run order), writes
// y, and resets the counter. One launch per layer.
//
// Limits (ops/fused_decode.fused_supported answers them): head dims that
// are multiples of 8 up to 256, D a multiple of 8 (32 for q8_0 weights,
// and R*Hd a multiple of 32), and a shared-memory working set of at most
// 227 KB (kSmemLimit; h dominates: B*D elements).
//
// What bounds it. Bytes: the head's weights once, the pool positions the
// rows attend once, x, y and the new K/V. The design reads each weight once
// but runs only K blocks (8 at Llama-3.2-1B), so one SM's load rate and
// FMA rate set its time, far from the card's; splitting D and the head
// group across a cluster, tensor cores and pipelined loads are later work.
// PERF.md has the measurements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlp_fused {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 8;      // batch rows per matvec pass
constexpr int kRT = 4;      // query heads per attention task
constexpr int kBK = 32;     // pool columns per tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;   // f32(1/127), as the reference's jit
constexpr size_t kSmemLimit = 232448;      // 227 KB a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// 8 consecutive elements (16-byte aligned for bf16, 32 for f32) as floats
__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float o[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = float(int8_t(w[i / 4] >> (8 * (i % 4))));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One projection [F, L], row-major (out-features major), dense in the
// activation dtype CT or a q8_0 pack (int8 codes, bf16 scale per 32 columns).
template <typename CT, bool Q8>
struct Mat {
  const void* w;
  const __nv_bfloat16* s;
  int L;
  // the 8 weights of row f at columns [c, c + 8), c % 8 == 0
  __device__ __forceinline__ void load(int f, int c, float o[8]) const {
    if constexpr (Q8) {
      load8(static_cast<const int8_t*>(w) + size_t(f) * L + c, o);
      const float sc = __bfloat162float(s[size_t(f) * (L / 32) + c / 32]);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = round_to<CT>(o[i] * sc);
    } else {
      load8(static_cast<const CT*>(w) + size_t(f) * L + c, o);
    }
  }
};

// For each of this warp's rows i of n_rows: the dot of the weight row
// (load(i, c, w8)) with every batch row of acts [B][L] (shared memory, the
// activation dtype), in f32, passed to store(i, b, value).
template <typename CT, typename Load, typename Store>
__device__ __forceinline__ void warp_matvec(int n_rows, int L, const CT* acts,
                                            int B, int warp, int lane,
                                            Load load, Store store) {
  for (int i = warp; i < n_rows; i += kWarps) {
    for (int b0 = 0; b0 < B; b0 += kBT) {
      float acc[kBT];
#pragma unroll
      for (int bb = 0; bb < kBT; ++bb) acc[bb] = 0.f;
#pragma unroll 4
      for (int c = lane * 8; c < L; c += 256) {
        float w8[8];
        load(i, c, w8);
#pragma unroll
        for (int bb = 0; bb < kBT; ++bb) {
          if (b0 + bb < B) {
            float a8[8];
            load8(acts + size_t(b0 + bb) * L + c, a8);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[bb] = fmaf(a8[j], w8[j], acc[bb]);
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < kBT; ++bb) {
        if (b0 + bb < B) {
          const float v = warp_sum(acc[bb]);
          if (lane == 0) store(i, b0 + bb, v);
        }
      }
    }
  }
}

struct Params {
  const void* x;
  const void* norm_w;
  const float* cos;   // [B, Hd/2]
  const float* sin;
  const void* wq; const __nv_bfloat16* wq_s;
  const void* wk; const __nv_bfloat16* wk_s;
  const void* wv; const __nv_bfloat16* wv_s;
  const void* wo; const __nv_bfloat16* wo_s;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;  // [B, NT]
  const int* lengths; // [B]
  void* y;            // [B, D]
  void* k_new;        // [B, K, Hd]
  void* v_new;
  float* ws;          // [K, B, D]
  unsigned* counter;  // zero between launches
  int B, D, H, K, Hd, NT, bs;
  int rope_half;
  float eps, scale, softcap;
  int window;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// the shared-memory layout; fused_supported's budget is the same sum
struct Smem {
  size_t h, q, kd, vd, at, pm, pl, pacc, flag, total;
  __host__ __device__ Smem(int B, int D, int R, int Hd, int act_bytes) {
    size_t o = 0;
    h = o;    o += align16(size_t(B) * D * act_bytes);
    q = o;    o += align16(size_t(B) * R * Hd * 4);
    kd = o;   o += align16(size_t(B) * Hd * 4);
    vd = o;   o += align16(size_t(B) * Hd * 4);
    at = o;   o += align16(size_t(B) * R * Hd * act_bytes);
    pm = o;   o += align16(size_t(kWarps) * kRT * 4);
    pl = o;   o += align16(size_t(kWarps) * kRT * 4);
    pacc = o; o += align16(size_t(kWarps) * kRT * Hd * 4);
    flag = o; o += 16;
    total = o;
  }
};

// one pool value as attention sees it: dense as stored; int8 codes
// dequantized as code * scale rounded to the activation dtype
template <typename CT, typename KT>
__device__ __forceinline__ void pool8(const KT* p, const float* s, size_t vec,
                                      int Hd, int d, float o[8]) {
  load8(p + vec * Hd + d, o);
  if constexpr (sizeof(KT) == 1) {
    const float sc = s[vec];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = round_to<CT>(o[i] * sc);
  }
}

template <typename CT, typename KT>
__device__ __forceinline__ float pool1(const KT* p, const float* s, size_t vec,
                                       int Hd, int d) {
  if constexpr (sizeof(KT) == 1) {
    return round_to<CT>(to_f(p[vec * Hd + d]) * s[vec]);
  } else {
    return to_f(p[vec * Hd + d]);
  }
}

template <int HDM, typename CT, bool Q8, typename KT>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const Params p) {
  constexpr int DPL = HDM / 32;   // output dims per lane
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int g = blockIdx.x;       // kv head
  const int B = p.B, D = p.D, K = p.K, Hd = p.Hd;
  const int R = p.H / K;
  const int RHd = R * Hd;
  const Smem L(B, D, R, Hd, sizeof(CT));
  CT* h_s = reinterpret_cast<CT*>(smem + L.h);
  float* q_s = reinterpret_cast<float*>(smem + L.q);      // [B][R*Hd]
  float* kd_s = reinterpret_cast<float*>(smem + L.kd);    // [B][Hd]
  float* vd_s = reinterpret_cast<float*>(smem + L.vd);
  CT* at_s = reinterpret_cast<CT*>(smem + L.at);          // [B][R*Hd]
  float* pm_s = reinterpret_cast<float*>(smem + L.pm);    // [warp][kRT]
  float* pl_s = reinterpret_cast<float*>(smem + L.pl);
  float* pacc_s = reinterpret_cast<float*>(smem + L.pacc);  // [warp][kRT][Hd]
  int* flag_s = reinterpret_cast<int*>(smem + L.flag);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const CT* x = static_cast<const CT*>(p.x);
  const CT* nw = static_cast<const CT*>(p.norm_w);

  // 1. RMSNorm: h = (x * rsqrt(mean(x^2) + eps)) * w, rounded
  for (int b = warp; b < B; b += kWarps) {
    const CT* xr = x + size_t(b) * D;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f(xr[c]);
      ss = fmaf(v, v, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / float(D) + p.eps);
    for (int c = lane; c < D; c += 32)
      h_s[size_t(b) * D + c] = from_f<CT>(to_f(xr[c]) * inv * to_f(nw[c]));
  }
  __syncthreads();

  // 2. the head's Q, K and V rows against every batch row of h (raw f32)
  const Mat<CT, Q8> wq{p.wq, p.wq_s, D}, wk{p.wk, p.wk_s, D}, wv{p.wv, p.wv_s, D};
  warp_matvec<CT>(
      RHd + 2 * Hd, D, h_s, B, warp, lane,
      [&](int i, int c, float* w8) {
        if (i < RHd) wq.load(g * RHd + i, c, w8);
        else if (i < RHd + Hd) wk.load(g * Hd + i - RHd, c, w8);
        else wv.load(g * Hd + i - RHd - Hd, c, w8);
      },
      [&](int i, int b, float v) {
        if (i < RHd) q_s[size_t(b) * RHd + i] = v;
        else if (i < RHd + Hd) kd_s[size_t(b) * Hd + i - RHd] = v;
        else vd_s[size_t(b) * Hd + i - RHd - Hd] = v;
      });
  __syncthreads();

  // 3. RoPE on the f32 products, q and k rounded; k_new / v_new out
  CT* k_new = static_cast<CT*>(p.k_new);
  CT* v_new = static_cast<CT*>(p.v_new);
  const int half = Hd / 2;
  for (int t = tid; t < B * (R + 1) * half; t += kThreads) {
    const int b = t / ((R + 1) * half), hr = t / half % (R + 1), i = t % half;
    const int i0 = p.rope_half ? i : 2 * i, i1 = p.rope_half ? i + half : 2 * i + 1;
    float* buf = hr < R ? q_s + size_t(b) * RHd + hr * Hd : kd_s + size_t(b) * Hd;
    const float c = p.cos[size_t(b) * half + i], s = p.sin[size_t(b) * half + i];
    // the projections rounded to the activation dtype first, as the unfused
    // step's proj outputs are (the TPU kernel ropes the f32 products; at
    // f32 the two are one); then products and sums rounded one at a time,
    // as the unfused rope computes them
    const float t0 = round_to<CT>(buf[i0]), t1 = round_to<CT>(buf[i1]);
    const float o0 = round_to<CT>(__fsub_rn(__fmul_rn(t0, c), __fmul_rn(t1, s)));
    const float o1 = round_to<CT>(__fadd_rn(__fmul_rn(t0, s), __fmul_rn(t1, c)));
    buf[i0] = o0;
    buf[i1] = o1;
    if (hr == R) {
      CT* kn = k_new + (size_t(b) * K + g) * Hd;
      kn[i0] = from_f<CT>(o0);
      kn[i1] = from_f<CT>(o1);
    }
  }
  for (int t = tid; t < B * Hd; t += kThreads) {
    const int b = t / Hd, d = t % Hd;
    const float v = round_to<CT>(vd_s[t]);
    vd_s[t] = v;
    v_new[(size_t(b) * K + g) * Hd + d] = from_f<CT>(v);
  }
  __syncthreads();
  if constexpr (sizeof(KT) == 1) {
    // the diagonal sees what the pool write stores: quantize, dequantize
    for (int w = warp; w < 2 * B; w += kWarps) {
      float* vec = (w < B ? kd_s : vd_s) + size_t(w % B) * Hd;
      float amax = 0.f;
      for (int d = lane; d < Hd; d += 32) amax = fmaxf(amax, fabsf(vec[d]));
      const float s = fmaxf(warp_max(amax) * kInv127, 1e-12f);
      for (int d = lane; d < Hd; d += 32) {
        const float code = fminf(fmaxf(rintf(vec[d] / s), -127.f), 127.f);
        vec[d] = round_to<CT>(code * s);
      }
    }
    __syncthreads();
  }

  // 4. attention over the pool, then the diagonal
  const KT* kp = static_cast<const KT*>(p.k_pool);
  const KT* vp = static_cast<const KT*>(p.v_pool);
  const int S = p.NT * p.bs;
  const int nrc = (R + kRT - 1) / kRT;
  const int ntask = B * nrc;
  const int wpt = ntask >= kWarps ? 1 : kWarps / ntask;   // warps per task
  auto finish = [&](int b, int r0, float* m, float* l, float (*acc)[DPL]) {
    const float* kd = kd_s + size_t(b) * Hd;
    const float* vd = vd_s + size_t(b) * Hd;
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) {
      if (r0 + rr >= R) break;
      const float* qr = q_s + size_t(b) * RHd + (r0 + rr) * Hd;
      float sd = 0.f;
      for (int d = lane; d < Hd; d += 32) sd = fmaf(qr[d], kd[d], sd);
      sd = warp_sum(sd) * p.scale;
      if (p.softcap > 0.f) sd = p.softcap * tanhf(sd / p.softcap);
      const float m_new = fmaxf(m[rr], sd);
      const float alpha = expf(m[rr] - m_new), pd = expf(sd - m_new);
      const float inv = 1.f / (alpha * l[rr] + pd);
      CT* o = at_s + size_t(b) * RHd + (r0 + rr) * Hd;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < Hd) o[d] = from_f<CT>(fmaf(alpha, acc[rr][j], pd * vd[d]) * inv);
      }
    }
  };
  for (int task = warp / wpt; task < ntask; task += kWarps / wpt) {
    const int sub = warp % wpt;
    const int b = task / nrc, r0 = task % nrc * kRT;
    const int len = p.lengths[b];
    const int end = min(len, S);
    const int lo = p.window > 0 ? max(0, len - p.window + 1) : 0;
    const int* tbl = p.tables + size_t(b) * p.NT;
    float m[kRT], l[kRT], acc[kRT][DPL];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) {
      m[rr] = kNegInf;
      l[rr] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.f;
    }
    for (int c0 = lo / kBK * kBK + sub * kBK; c0 < end; c0 += wpt * kBK) {
      const int c = c0 + lane;
      const bool visible = c >= lo && c < end;
      float s[kRT];
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) s[rr] = 0.f;
      if (visible) {
        const size_t vec = (size_t(tbl[c / p.bs]) * p.bs + c % p.bs) * K + g;
        for (int d = 0; d < Hd; d += 8) {
          float k8[8];
          pool8<CT>(kp, p.k_scale, vec, Hd, d, k8);
#pragma unroll
          for (int rr = 0; rr < kRT; ++rr) {
            if (r0 + rr < R) {
              float q8[8];
              load8(q_s + size_t(b) * RHd + (r0 + rr) * Hd + d, q8);
#pragma unroll
              for (int i = 0; i < 8; ++i) s[rr] = fmaf(q8[i], k8[i], s[rr]);
            }
          }
        }
      }
      // online softmax; softcap before the mask, as the unfused path
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        float xs = s[rr] * p.scale;
        if (p.softcap > 0.f) xs = p.softcap * tanhf(xs / p.softcap);
        xs = visible ? xs : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(xs));
        const float alpha = expf(m[rr] - m_new);
        const float pr = visible ? expf(xs - m_new) : 0.f;
        l[rr] = alpha * l[rr] + warp_sum(pr);
        m[rr] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[rr][j] *= alpha;
        s[rr] = pr;
      }
      const int k_lo = max(lo - c0, 0), k_hi = min(end - c0, kBK);
      for (int key = k_lo; key < k_hi; ++key) {
        const int cc = c0 + key;
        const size_t vec = (size_t(tbl[cc / p.bs]) * p.bs + cc % p.bs) * K + g;
        float vv[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          vv[j] = d < Hd ? pool1<CT>(vp, p.v_scale, vec, Hd, d) : 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < kRT; ++rr) {
          const float pr = __shfl_sync(0xffffffffu, s[rr], key);
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[rr][j] = fmaf(pr, vv[j], acc[rr][j]);
        }
      }
    }
    if (wpt == 1) {
      finish(b, r0, m, l, acc);
    } else {   // park this warp's partial for the merge
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        if (lane == 0) {
          pm_s[warp * kRT + rr] = m[rr];
          pl_s[warp * kRT + rr] = l[rr];
        }
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < Hd) pacc_s[(size_t(warp) * kRT + rr) * Hd + d] = acc[rr][j];
        }
      }
    }
  }
  if (wpt > 1) {
    __syncthreads();
    if (warp < ntask) {   // merge the task's partials in warp order
      const int task = warp, b = task / nrc, r0 = task % nrc * kRT;
      float m[kRT], l[kRT], acc[kRT][DPL];
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        float mx = kNegInf;
        for (int w = task * wpt; w < (task + 1) * wpt; ++w)
          mx = fmaxf(mx, pm_s[w * kRT + rr]);
        m[rr] = mx;
        l[rr] = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.f;
        for (int w = task * wpt; w < (task + 1) * wpt; ++w) {
          const float f = expf(pm_s[w * kRT + rr] - mx);
          l[rr] = fmaf(f, pl_s[w * kRT + rr], l[rr]);
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < Hd)
              acc[rr][j] = fmaf(f, pacc_s[(size_t(w) * kRT + rr) * Hd + d], acc[rr][j]);
          }
        }
      }
      finish(b, r0, m, l, acc);
    }
  }
  __syncthreads();

  // 5. this head's O-projection partial [B, D] into the workspace
  const Mat<CT, Q8> wo{p.wo, p.wo_s, p.H * Hd};
  float* ws = p.ws + size_t(g) * B * D;
  warp_matvec<CT>(
      D, RHd, at_s, B, warp, lane,
      [&](int n, int c, float* w8) { wo.load(n, g * RHd + c, w8); },
      [&](int n, int b, float v) { ws[size_t(b) * D + n] = v; });

  // 6. the last block to finish sums the heads in order 0..K-1
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag_s = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  CT* y = static_cast<CT*>(p.y);
  for (int i = tid; i < B * D; i += kThreads) {
    float sum = 0.f;
    for (int kh = 0; kh < K; ++kh) sum += __ldcg(p.ws + size_t(kh) * B * D + i);
    y[i] = from_f<CT>(to_f(x[i]) + round_to<CT>(sum));
  }
  if (tid == 0) *p.counter = 0u;
}

template <int HDM, typename CT, bool Q8, typename KT>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = fused_decode_kernel<HDM, CT, Q8, KT>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemLimit));
  if (attr != cudaSuccess) return attr;
  kernel<<<p.K, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDM, typename CT, bool Q8>
cudaError_t dispatch_kv(const Params& p, int kv_int8, size_t smem, cudaStream_t st) {
  return kv_int8 ? launch<HDM, CT, Q8, int8_t>(p, smem, st)
                 : launch<HDM, CT, Q8, CT>(p, smem, st);
}

template <int HDM>
cudaError_t dispatch_types(const Params& p, int act_dtype, int w_q8, int kv_int8,
                           size_t smem, cudaStream_t st) {
  if (act_dtype == 0) {
    if (w_q8) return cudaErrorInvalidValue;   // q8_0 weights serve bf16 only
    return dispatch_kv<HDM, float, false>(p, kv_int8, smem, st);
  }
  return w_q8 ? dispatch_kv<HDM, __nv_bfloat16, true>(p, kv_int8, smem, st)
              : dispatch_kv<HDM, __nv_bfloat16, false>(p, kv_int8, smem, st);
}

}  // namespace dlp_fused

// act_dtype: 0 = float32, 1 = bfloat16 (x, norm_w, dense weights, outputs
// and a dense pool share it); w_q8: the four projections are q8_0 packs
// (bf16 only); kv_int8: int8 pools with f32 scales. counter: a device
// unsigned that is 0 between launches (the kernel resets it); one stream at
// a time may use it. Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_fused_decode(
    const void* x, const void* norm_w, const float* cos, const float* sin,
    const void* wq, const void* wq_s, const void* wk, const void* wk_s,
    const void* wv, const void* wv_s, const void* wo, const void* wo_s,
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* tables, const int* lengths, void* y,
    void* k_new, void* v_new, float* ws, unsigned* counter, int B, int D, int H,
    int K, int Hd, int NT, int bs, int act_dtype, int w_q8, int kv_int8,
    int rope_half, float eps, float scale, float softcap, int window,
    void* stream) {
  using namespace dlp_fused;
  if (Hd % 8 || Hd < 8 || Hd > 256 || D % 8 || H % K)
    return int(cudaErrorInvalidValue);
  const size_t smem = Smem(B, D, H / K, Hd, act_dtype == 0 ? 4 : 2).total;
  if (smem > kSmemLimit) return int(cudaErrorInvalidValue);
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const Params p{x, norm_w, cos, sin, wq, bf(wq_s), wk, bf(wk_s), wv, bf(wv_s), wo,
                 bf(wo_s), k_pool, v_pool, k_scale, v_scale, tables, lengths, y,
                 k_new, v_new, ws, counter, B, D, H, K, Hd, NT, bs, rope_half,
                 eps, scale, softcap, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hd <= 64) return int(dispatch_types<64>(p, act_dtype, w_q8, kv_int8, smem, st));
  if (Hd <= 128) return int(dispatch_types<128>(p, act_dtype, w_q8, kv_int8, smem, st));
  return int(dispatch_types<256>(p, act_dtype, w_q8, kv_int8, smem, st));
}
