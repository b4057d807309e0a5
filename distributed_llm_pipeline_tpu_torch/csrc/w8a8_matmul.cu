// W8A8 integer-dot matmul of few activation rows against a Q8_0, int8, Q6_K,
// Q4_K, Q5_KS, Q2_KS or Q3_KS pack, for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels `gw8a8_matmul_pallas` (distributed_llm_pipeline_
// tpu/ops/quant_matmul.py, math in `gw8a8_band_accum`) on Q8_0 packs,
// `int8_matmul_pallas` (`_int8_kernel`) on int8 packs at M <= 4 (int8's
// larger M runs int8_matmul.cu), `q6_k_w8a8_matmul_pallas`
// (ops/kquant_matmul.py, `_q6k_w8a8_kernel`) on Q6_K packs,
// `q4_k_w8a8_matmul_pallas` / `q5_ks_w8a8_matmul_pallas` /
// `q2_ks_w8a8_matmul_pallas` (`_q4k_w8a8_kernel`, `_q5ks_w8a8_kernel`,
// `_q2ks_w8a8_kernel`) on the affine Q4_K, Q5_KS and Q2_KS packs, and
// `q3_ks_w8a8_matmul_pallas` (`_q3ks_w8a8_kernel`) on Q3_KS packs. Same
// contract, with the activation quantization folded in:
//   x [M, D] (f32 or bf16, M <= 32) is quantized per (row, group of `group`
//   columns): xs = amax * f32(1/127) (the reference's amax / 127 as XLA
//   compiles it), inv = xs > 0 ? 1 / max(xs, 1e-30) : 0 (IEEE division),
//   xq = clamp(rint(x * inv), -127, 127) -- the reference's `quantize_acts`,
//   bit for bit. Then out[m, f] = sum over groups g of
//   xs[m, g] * sum over sub-blocks s of g of float(P[m, s, f]) * scale[f, s],
//   where P is the exact int32 dot of xq and the weight codes over the
//   sub-block's SUB rows (32 for Q8_0, int8, Q4_K and Q5_KS, 16 for Q6_K,
//   Q2_KS and Q3_KS; int8's f32 scale is its group's, shared by the group's
//   sub-blocks). An affine pack (weight = code * scale - offset) subtracts
//   sum over s of (float(S[m, s]) * xs[m, g(s)]) * offset[f, s], S the exact
//   sum of xq over the sub-block. Output [M, F] in f32 or bf16.
//
// Design. A decode step's projections are GEMVs: bounded by the weight bytes
// (1.0625 B/weight for Q8_0, 0.875 for Q6_K), with M <= 32 rows of x reused
// against each. One warp owns one output row f; lane j takes sub-block
// s0 + j of the chunk, decodes its codes into registers (quant_tile.cuh) and
// runs SUB/4 dp4a per activation row. The group sum over the sub-blocks of
// one group is a butterfly over the group's adjacent lanes; each group's sum
// times xs goes into a per-lane f32 accumulator, summed across the warp at
// the end. Each block (8 warps, 8 output rows) quantizes x itself, 1024
// columns at a time into shared memory: no separate launch per projection,
// at the price of re-reading x from L2 once per block (cheap at decode's M,
// dominant at M = 32 against narrow F). For an affine pack the prologue also
// stores each row's sums S over every SUB columns (dp4a against ones), and
// each lane subtracts its sub-block's offset term. The bands of a packed
// byte (two for Q4_K and Q5_KS, four for Q2_KS, Q3_KS and Q6_K's 2-bit
// plane) are walked one after the other, so each packed byte is read once
// per band, after the first time from L1 or L2.

#include <type_traits>

#include "quant_tile.cuh"

namespace {

using namespace dlp_quant;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;  // columns of x quantized into shared memory at a time

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

// MT: activation rows the registers hold (M <= MT); xq_out / xs_out, when not
// null, receive block 0's quantized activations
template <class Dec, int MT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(Dec dec, const void* __restrict__ x, bool x_bf16, void* __restrict__ out,
            bool out_bf16, int M, int D, int F, int group, int8_t* __restrict__ xq_out,
            float* __restrict__ xs_out) {
  constexpr int SUB = Dec::SUB;
  constexpr int WORDS = SUB / 4;  // code words per sub-block
  __shared__ __align__(16) int8_t xq_s[MT][kChunk];
  __shared__ float xs_s[MT][kChunk / 32];
  __shared__ int ss_s[Dec::AFFINE ? MT : 1][kChunk / SUB];  // per-SUB sums of xq
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * kWarps + warp;
  const int spg = group / SUB;  // sub-blocks per group: 1 to 16 lanes
  const bool dump = xq_out != nullptr && blockIdx.x == 0;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int len = min(kChunk, D - c0);
    const int ng = len / group;
    __syncthreads();  // the previous chunk is consumed
    // quantize x[:, c0 : c0 + len], one warp per (row, group)
    for (int pr = warp; pr < M * ng; pr += kWarps) {
      const int m = pr / ng, g = pr % ng;
      const size_t base = size_t(m) * D + c0 + size_t(g) * group;
      float amax = 0.f;
      for (int i = lane; i < group; i += 32) amax = fmaxf(amax, fabsf(load_f32(x, base + i, x_bf16)));
      amax = warp_max(amax);
      const float xs = amax * (1.0f / 127.0f);
      const float inv = xs > 0.f ? 1.0f / fmaxf(xs, 1e-30f) : 0.f;
      for (int i = lane; i < group; i += 32) {
        const float q = fminf(fmaxf(rintf(load_f32(x, base + i, x_bf16) * inv), -127.f), 127.f);
        xq_s[m][g * group + i] = int8_t(q);
        if (dump) xq_out[base + i] = int8_t(q);
      }
      if (lane == 0) {
        xs_s[m][g] = xs;
        if (dump) xs_out[size_t(m) * (D / group) + c0 / group + g] = xs;
      }
      if constexpr (Dec::AFFINE) {
        __syncwarp();  // the group's codes are in shared memory
        for (int sb = lane; sb < group / SUB; sb += 32) {
          const int* xw = reinterpret_cast<const int*>(&xq_s[m][g * group + sb * SUB]);
          int sum = 0;
#pragma unroll
          for (int i = 0; i < WORDS; ++i) sum = __dp4a(xw[i], 0x01010101, sum);
          ss_s[m][g * group / SUB + sb] = sum;
        }
      }
    }
    __syncthreads();
    if (f >= F) continue;  // a ragged last block: no row, but it keeps the barriers

    const int nsb = len / SUB;
    for (int s0 = 0; s0 < nsb; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < nsb;  // a whole group is live or not: 32 % spg == 0
      int w[WORDS];
      float sc = 0.f, off = 0.f;
#pragma unroll
      for (int i = 0; i < WORDS; ++i) w[i] = 0;
      if (live) {
#pragma unroll
        for (int h = 0; h < SUB / 16; ++h) dec.codes16(f, c0 + s * SUB + 16 * h, w + 4 * h);
        sc = dec.scale_at(f, c0 + s * SUB);
        if constexpr (Dec::AFFINE) off = dec.offset_at(f, c0 + s * SUB);
      }
      const int col = live ? s * SUB : 0;
      const int g = col / group;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const int* xw = reinterpret_cast<const int*>(&xq_s[m][col]);
          int p = 0;
#pragma unroll
          for (int i = 0; i < WORDS; ++i) p = __dp4a(w[i], xw[i], p);
          float t = float(p) * sc;  // the sub-block's term
          for (int o = 1; o < spg; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
          if (live && lane % spg == 0) acc[m] += t * xs_s[m][g];  // group sum, times xs
          if constexpr (Dec::AFFINE) {  // sub-block s is sum s
            if (live) acc[m] -= float(ss_s[m][s]) * xs_s[m][g] * off;
          }
        }
      }
    }
  }
  if (f >= F) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float v = warp_sum(acc[m]);
      if (lane == 0) store_f32(out, size_t(m) * F + f, v, out_bf16);
    }
  }
}

template <class Dec, int MT>
cudaError_t launch_mt(const Dec& dec, const void* x, int x_bf16, void* out, int out_bf16,
                      int M, int D, int F, int group, int8_t* xq_out, float* xs_out,
                      cudaStream_t stream) {
  const dim3 grid((F + kWarps - 1) / kWarps);
  w8a8_kernel<Dec, MT><<<grid, kThreads, 0, stream>>>(dec, x, x_bf16 != 0, out, out_bf16 != 0,
                                                      M, D, F, group, xq_out, xs_out);
  return cudaGetLastError();
}

template <class Dec>
int launch(const Dec& dec, const void* x, int8_t* xq_out, float* xs_out, void* out,
           int x_bf16, int out_bf16, int M, int D, int F, int group, void* stream) {
  if (M < 1 || M > 32 || F < 1 || group < Dec::SUB || group % Dec::SUB || D % group ||
      kChunk % group || 32 % (group / Dec::SUB))
    return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = [&](auto mt) {
    return int(launch_mt<Dec, decltype(mt)::value>(dec, x, x_bf16, out, out_bf16, M, D, F,
                                                   group, xq_out, xs_out, st));
  };
  if (M <= 1) return a(std::integral_constant<int, 1>{});
  if (M <= 2) return a(std::integral_constant<int, 2>{});
  if (M <= 4) return a(std::integral_constant<int, 4>{});
  if (M <= 8) return a(std::integral_constant<int, 8>{});
  if (M <= 16) return a(std::integral_constant<int, 16>{});
  return a(std::integral_constant<int, 32>{});
}

}  // namespace

// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32. xq_out / xs_out may be null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_w8a8_q8_0(const void* x, const void* qs, const void* scale, void* out,
                             int8_t* xq_out, float* xs_out, int x_bf16, int out_bf16, int M,
                             int D, int F, int group, void* stream) {
  const Q8_0 dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(scale), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_int8(const void* x, const void* qs, const void* gs, void* out,
                             int8_t* xq_out, float* xs_out, int x_bf16, int out_bf16, int M,
                             int D, int F, int group, void* stream) {
  const Int8 dec{static_cast<const int8_t*>(qs), static_cast<const float*>(gs), D, group};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_q4_k(const void* x, const void* qs, const void* a, const void* b,
                             void* out, int8_t* xq_out, float* xs_out, int x_bf16, int out_bf16,
                             int M, int D, int F, int group, void* stream) {
  const Q4K dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_q5_ks(const void* x, const void* q5n, const void* q5h, const void* a,
                              const void* b, void* out, int8_t* xq_out, float* xs_out,
                              int x_bf16, int out_bf16, int M, int D, int F, int group,
                              void* stream) {
  const Q5KS dec{static_cast<const int8_t*>(q5n), static_cast<const int8_t*>(q5h),
                 static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_q6_k(const void* x, const void* ql, const void* qh, const void* s,
                             void* out, int8_t* xq_out, float* xs_out, int x_bf16, int out_bf16,
                             int M, int D, int F, int group, void* stream) {
  const Q6K dec{static_cast<const int8_t*>(ql), static_cast<const int8_t*>(qh),
                static_cast<const __nv_bfloat16*>(s), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_q2_ks(const void* x, const void* q2l, const void* a, const void* b,
                              void* out, int8_t* xq_out, float* xs_out, int x_bf16,
                              int out_bf16, int M, int D, int F, int group, void* stream) {
  const Q2KS dec{static_cast<const int8_t*>(q2l), static_cast<const __nv_bfloat16*>(a),
                 static_cast<const __nv_bfloat16*>(b), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

extern "C" int dlp_w8a8_q3_ks(const void* x, const void* q3l, const void* q3h, const void* s,
                              void* out, int8_t* xq_out, float* xs_out, int x_bf16,
                              int out_bf16, int M, int D, int F, int group, void* stream) {
  const Q3KS dec{static_cast<const int8_t*>(q3l), static_cast<const int8_t*>(q3h),
                 static_cast<const __nv_bfloat16*>(s), D};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}
