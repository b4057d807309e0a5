// int8 W8A8 matmul of many activation rows against an int8 pack, for Hopper
// (sm_90a), plain C ABI: the route of `int8_matmul` above a few rows (M <= 4
// runs w8a8_matmul.cu with the int8 decoder).
//
// Replaces the TPU kernel `int8_matmul_pallas` (distributed_llm_pipeline_tpu/
// ops/quant_matmul.py, `_int8_kernel`). Same contract, in two launches:
//   1. dlp_int8_quantize_acts: x [M, D] (f32 or bf16) quantized per (row,
//      group of `group` columns) to xq int8 [M, D] and xs f32 [M, D/group]:
//      xs = amax * f32(1/127), inv = xs > 0 ? 1 / max(xs, 1e-30) : 0 (IEEE
//      division), xq = clamp(rint(x * inv), -127, 127) -- the reference's
//      `quantize_acts` as it serves under jit, bit for bit (the W8A8
//      prologue's code). The reference runs it as an XLA op outside Pallas.
//   2. dlp_int8_matmul: out[m, f] = sum over groups g, in order, of
//      float(P[m, g, f]) * (xs[m, g] * gs[f, g]), P the exact int32 dot of
//      xq and qs [F, D] over the group's columns (|P| <= 256 * 127^2 < 2^24,
//      so the conversion is exact). Each product and sum is rounded on its
//      own (no FMA), as the plain version computes it. Output [M, F] in f32
//      or bf16.
//
// Design. Prefill and mixed steps are GEMMs bounded by the tensor cores'
// int8 rate (2 * M * D * F operations over 1979 TOP/s) once M is in the
// hundreds. One block (8 warps) owns a 64 x 128 output tile and walks D in
// 64-column k-tiles, staged into shared memory by cp.async, two stages deep
// (the next tile's copies run while the tensor cores work on this one).
// Each warp owns 32 x 32 of the tile: 2 x 4 `mma.sync m16n8k32` s8 products
// per 32 columns into int32 fragments, read from shared memory rows padded
// to 80 bytes so the fragment reads of 8 rows by 4 lanes hit 32 banks. At
// the end of each weight group the int32 fragments are scaled into f32
// accumulators in registers (the mma fragment layout names each element's
// row and column) and cleared. Ragged M and F tiles are zero-filled by the
// copies and masked at the store. No TMA, no wgmma: a first kernel that is
// right; PERF.md has its distance from the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace dlp_quant;

// ---- activation quantization: one warp per (row, group)

constexpr int kQWarps = 8;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kQWarps * 32)
quantize_kernel(const void* __restrict__ x, bool x_bf16, int8_t* __restrict__ xq,
                float* __restrict__ xs, int M, int D, int group) {
  const int ng = D / group;
  const int pair = blockIdx.x * kQWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pair >= M * ng) return;
  const int m = pair / ng, g = pair % ng;
  const size_t base = size_t(m) * D + size_t(g) * group;
  float amax = 0.f;
  for (int i = lane; i < group; i += 32) amax = fmaxf(amax, fabsf(load_f32(x, base + i, x_bf16)));
  amax = warp_max(amax);
  const float s = amax * (1.0f / 127.0f);
  const float inv = s > 0.f ? 1.0f / fmaxf(s, 1e-30f) : 0.f;
  for (int i = lane; i < group; i += 32)
    xq[base + i] = int8_t(fminf(fmaxf(rintf(load_f32(x, base + i, x_bf16) * inv), -127.f), 127.f));
  if (lane == 0) xs[size_t(m) * ng + g] = s;
}

// ---- the GEMM

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int kThreads = 256;  // 8 warps: 2 along M by 4 along N, 32 x 32 each
constexpr int LDS = BK + 16;   // bytes per staged row (see Design)
constexpr int kStages = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// c += a (16 x 32, row-major) . b (32 x 8, column-major), s8 in, s32 out.
// Fragments (lane = 4 * gid + tig): a[0] row gid, bytes 4 tig ..; a[1] row
// gid + 8; a[2], a[3] the same rows at byte 16 + 4 tig. b[0] column gid,
// bytes 4 tig ..; b[1] byte 16 + 4 tig. c[0], c[1] row gid, columns 2 tig,
// 2 tig + 1; c[2], c[3] row gid + 8.
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ qs, const float* __restrict__ gs,
                 void* __restrict__ out, bool out_bf16, int M, int D, int F, int group) {
  __shared__ __align__(16) int8_t a_s[kStages][BM][LDS];
  __shared__ __align__(16) int8_t b_s[kStages][BN][LDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ng = D / group, nk = (D + BK - 1) / BK;

  float acc[2][4][4];
  int p[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0.f;
        p[i][j][c] = 0;
      }

  // one k-tile into a stage: x's 64 rows (one 16-byte chunk a thread), the
  // weight's 128 rows (two a thread); rows past M or F and columns past D
  // are zero
  const auto load_stage = [&](int st, int k0) {
    {
      const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
      const bool ok = m0 + r < M && k0 + c < D;
      cp_async16(&a_s[st][r][c], ok ? xq + size_t(m0 + r) * D + k0 + c : xq, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / 4, c = (i % 4) * 16;
      const bool ok = n0 + r < F && k0 + c < D;
      cp_async16(&b_s[st][r][c], ok ? qs + size_t(n0 + r) * D + k0 + c : qs, ok);
    }
  };

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) % kStages, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();  // this k-tile's copies have landed
    __syncthreads();
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int k = kt * BK + kk;
      if (k >= D) break;  // D % 64 == 32: the last tile's second half
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        a[i][0] = lds32(&a_s[st][r][kk + 4 * tig]);
        a[i][1] = lds32(&a_s[st][r + 8][kk + 4 * tig]);
        a[i][2] = lds32(&a_s[st][r][kk + 16 + 4 * tig]);
        a[i][3] = lds32(&a_s[st][r + 8][kk + 16 + 4 * tig]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + gid;
        b[j][0] = lds32(&b_s[st][n][kk + 4 * tig]);
        b[j][1] = lds32(&b_s[st][n][kk + 16 + 4 * tig]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(p[i][j], a[i], b[j]);
      if ((k + 32) % group == 0) {  // the end of weight group g: scale, fold, clear
        const int g = k / group;
        float sx[2][2], sg[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm * 32 + i * 16 + gid + 8 * h;
            sx[i][h] = r < M ? xs[size_t(r) * ng + g] : 0.f;
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + j * 8 + 2 * tig + e;
            sg[j][e] = n < F ? gs[size_t(n) * ng + g] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float s = __fmul_rn(sx[i][c / 2], sg[j][c % 2]);
              acc[i][j][c] = __fadd_rn(acc[i][j][c], __fmul_rn(float(p[i][j][c]), s));
              p[i][j][c] = 0;
            }
      }
    }
    __syncthreads();  // the stage is consumed before the next loop refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = m0 + wm * 32 + i * 16 + gid + 8 * (c / 2);
        const int n = n0 + wn * 32 + j * 8 + 2 * tig + c % 2;
        if (r < M && n < F) store_f32(out, size_t(r) * F + n, acc[i][j][c], out_bf16);
      }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32. Each returns the cudaError_t
// of its launch (0 = launched).
extern "C" int dlp_int8_quantize_acts(const void* x, int8_t* xq, float* xs, int x_bf16, int M,
                                      int D, int group, void* stream) {
  if (M < 1 || group < 32 || group % 32 || D % group) return int(cudaErrorInvalidValue);
  const int pairs = M * (D / group);
  quantize_kernel<<<(pairs + kQWarps - 1) / kQWarps, kQWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, x_bf16 != 0, xq, xs, M, D, group);
  return int(cudaGetLastError());
}

extern "C" int dlp_int8_matmul(const int8_t* xq, const float* xs, const int8_t* qs,
                               const float* gs, void* out, int out_bf16, int M, int D, int F,
                               int group, void* stream) {
  if (M < 1 || F < 1 || group < 32 || group % 32 || D % group) return int(cudaErrorInvalidValue);
  if (!aligned16(xq) || !aligned16(qs)) return int(cudaErrorMisalignedAddress);
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xq, xs, qs, gs, out, out_bf16 != 0, M, D, F, group);
  return int(cudaGetLastError());
}
