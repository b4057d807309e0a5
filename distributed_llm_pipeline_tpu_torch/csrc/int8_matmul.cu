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
//      xq and qs [F, D] over the group's columns. Each product and sum is
//      rounded on its own (no FMA), as the plain version computes it.
//      Output [M, F] in f32 or bf16.
//
// What bounds it. At prefill widths (M = 512, D x F = 2048 x 8192) the
// product's 17.2 G integer operations take 8.7 us at the int8 tensor-core
// rate and the operands' 17 MB 5 us of memory time: operations, on paper.
// On the H100 a block's tiles stream from L2 no faster than the tensor
// cores would take them, as cuBLAS's own int8 GEMM does at that shape
// (PERF.md): the time follows the bytes a ring keeps in flight. The design
// keeps both operands in shared memory, moves each once per block, keeps
// as much of the ring loading as it can, and keeps the per-group fold off
// the conversion pipe:
//
// - wgmma m64nBNk32 .s32.s8.s8 with both operands in shared memory, K-major
//   as xq [M, D] and qs [F, D] already are. A block is two consumer
//   warpgroups of 64 rows of x each (BM = 128) over BN = 128 or 64 rows of
//   qs (output columns), the host's shape-only choice (ops/quant_matmul.py
//   `int8_plan`: the narrower tile where its whole grid fits one wave).
//   There is no split-K: every output sums its groups in group order in one
//   block, so the result is the plain version's bit for bit.
// - An asynchronous ring, filled by TMA. A k-step is 128 columns: one
//   128-byte row of x and of qs a row, in the 128-byte swizzle the MMA
//   reads (a 32-column slice starts 32 bytes in); 6 stages at BN = 128, 8
//   at 64, so the stage a consumer holds is a small part of the ring. A
//   step holds 128 / group whole groups; a group of 256 spans two steps,
//   the first released once the group's MMAs are done, before its fold
//   (the scales sit in the second). kquant_gemm.cuh's
//   mbarrier, TMA and wgmma helpers are reused. The producer warp refills a
//   stage once all 8 consumer warps release it: one lane issues the boxes
//   (rows past M or F and columns past D land as 0), and all 32 copy by
//   cp.async the scales of the groups that end in the step (xs of the
//   block's rows and gs of its columns: their rows, 4 * D/group bytes, are
//   no TMA pitch at D = 1152 or 2080). The stage's mbarrier counts lane 0's
//   arrival with the TMA bytes and each lane's copies as they land.
// - The fold off the conversion pipe. |P| <= 256 * 128 * 127 < 2^22, so
//   float(P) is the float whose bits are 0x4B400000 + P, less 12582912.0f
//   (1.5 * 2^23), exactly: an integer add and an f32 subtract, not a cvt.
//   A group's first MMA overwrites the int32 accumulators (scale-d 0); once
//   they are done the warpgroup folds them into its f32 sums as the
//   contract orders: __fadd_rn(acc, __fmul_rn(float(P), __fmul_rn(xs, gs))).
//   A group of 256 is 8 MMAs; group 128, 64, 32 (D = 1152, 2080) 4, 2, 1 a
//   fold. One set of accumulators: at BN = 128 two would take 3 * 64
//   registers a thread of the 168 that 288 threads leave.
// - The epilogue writes each thread's pairs of outputs (8-byte f32 or
//   4-byte bf16 stores where F is even) straight from the registers, masking
//   the ragged M and F edges.
//
// PERF.md has the measurements.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kquant_gemm.cuh"
#include "quant_tile.cuh"

namespace {

using namespace dlp_quant;

// ---- activation quantization: one warp per (row, group)

constexpr int kQWarps = 8;

__global__ void __launch_bounds__(kQWarps * 32)
quantize_kernel(const void* __restrict__ x, bool x_bf16, int8_t* __restrict__ xq,
                float* __restrict__ xs, int M, int D, int group) {
  const int ng = D / group;
  const int pair = blockIdx.x * kQWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pair >= M * ng) return;
  const int m = pair / ng, g = pair % ng;
  const size_t base = size_t(m) * D + size_t(g) * group;
  const float s = quantize_group(x, x_bf16, base, group, xq + base);
  if (lane == 0) xs[size_t(m) * ng + g] = s;
}

// ---- the GEMM

using dlp_kgemm::fence_regs;
using dlp_kgemm::mbar_arrive;
using dlp_kgemm::mbar_arrive_tx;
using dlp_kgemm::mbar_init;
using dlp_kgemm::mbar_wait;
using dlp_kgemm::smem_u32;
using dlp_kgemm::tma_load;
using dlp_kgemm::wgmma_commit;
using dlp_kgemm::wgmma_fence;
using dlp_kgemm::wgmma_wait;

constexpr int BM = 128;       // rows of x a block: two consumer warpgroups of 64
constexpr int KSTEP = 128;    // columns of a k-step: one 128-byte smem row
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 32;   // + the producer warp
constexpr uint32_t MAGIC = 0x4B400000u;   // the bits of 12582912.0f = 1.5 * 2^23
constexpr float MAGIC_F = 12582912.0f;

// The tiling of one instantiation: GROUP columns a weight group, BN rows of
// qs a block. A k-step holds GPK whole groups, or (GROUP = 256) half of
// one: SPG steps a group. A stage holds a k-step's x [BM][128], qs
// [BN][128] and scales [GPK][BM + BN] (xs of the block's rows, then gs of
// its columns, for each group that ends in the step); then the mbarriers.
template <int GROUP, int BN>
struct Geo {
  static constexpr int GPK = GROUP < KSTEP ? KSTEP / GROUP : 1;   // groups a k-step
  static constexpr int SPG = GROUP > KSTEP ? GROUP / KSTEP : 1;   // k-steps a group
  static constexpr int STAGES = BN == 128 ? 6 : 8;
  static constexpr int W_OFF = BM * KSTEP;
  static constexpr int SC_OFF = W_OFF + BN * KSTEP;
  static constexpr int SC_ROW = BM + BN;      // floats of one group's scales
  static constexpr int STAGE = (SC_OFF + GPK * SC_ROW * 4 + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = STAGES * STAGE;   // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;   // + slack to align the base
  static constexpr int ACC = BN / 2;          // int32 and f32 accumulators a thread
  static constexpr int SC_LANE = SC_ROW / 32;  // scales a producer lane copies a group
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(SC_ROW % 32 == 0 && BM % 32 == 0, "the producer lanes share a group's scales");
};

// An operand tile (K-major, rows of 128 bytes) in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1); the
// tile base is 1024-byte aligned and a 32-deep slice starts 32 bytes in.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// ---- cp.async for the scales

// 4 bytes from global memory at src into shared memory at dst, or 4 zero
// bytes when `ok` is false (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// an arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

struct Maps {
  CUtensorMap x, w;
};

// d = A (64 rows of x, K-major in shared memory) . B (N rows of qs, K-major
// in shared memory) over 32 columns, plus d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// grid (ceil(F / BN), ceil(M / BM)); every block walks all of D
template <int GROUP, int BN>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_kernel(const __grid_constant__ Maps maps, const float* __restrict__ xs,
                 const float* __restrict__ gs, void* __restrict__ out, int out_bf16, int M,
                 int D, int F) {
  using G = Geo<GROUP, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw0);
  const uint32_t full0 = base + G::BAR_OFF, empty0 = full0 + 8 * G::STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ng = D / GROUP, ns = (D + KSTEP - 1) / KSTEP;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      // the producer lane 0's arrival with the TMA bytes, and the 32 lanes'
      // scale copies as they land
      mbar_init(full0 + 8 * s, 33);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);   // each consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: step i into stage i % STAGES once it is released
    const int lane = threadIdx.x - CONSUMERS;
    for (int i = 0; i < ns; ++i) {
      const int s = i % G::STAGES;
      const uint32_t st = base + s * G::STAGE, full = full0 + 8 * s;
      if (i >= G::STAGES) mbar_wait(empty0 + 8 * s, (i / G::STAGES - 1) & 1);
      if (lane == 0) {
        // the step's columns of x and qs (past D they land as 0)
        mbar_arrive_tx(full, (BM + BN) * KSTEP);
        tma_load(st, &maps.x, i * KSTEP, m0, full);
        tma_load(st + G::W_OFF, &maps.w, i * KSTEP, n0, full);
      }
      // the scales of the groups that end in the step: for each, rows
      // lane + 32 j of [BM + BN] (xs of the block's rows, then gs of its
      // columns), 0 past M or F
      const int g0 = i / G::SPG * G::GPK;
      const int count = (i + 1) % G::SPG ? 0 : min(G::GPK, ng - g0);
      const uint32_t sc = st + G::SC_OFF;
#pragma unroll 1
      for (int gi = 0; gi < count; ++gi) {
        const int g = g0 + gi;
#pragma unroll
        for (int j = 0; j < G::SC_LANE; ++j) {
          const int r = lane + 32 * j;
          const uint32_t dst = sc + 4 * (gi * G::SC_ROW + r);
          if (j < BM / 32) {
            const bool ok = m0 + r < M;
            cp_async4(dst, ok ? xs + size_t(m0 + r) * ng + g : xs, ok);
          } else {
            const bool ok = n0 + r - BM < F;
            cp_async4(dst, ok ? gs + size_t(n0 + r - BM) * ng + g : gs, ok);
          }
        }
      }
      cp_async_arrive(full);
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block;
  // this thread's rows are row and row + 8, its column pairs 8j + 2c. Groups
  // run in order, g = 0 .. ng - 1: group g lies in step g / GPK.
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = 64 * wg + 16 * warp + lane / 4, c = lane % 4;
  float sum[G::ACC];
#pragma unroll
  for (int k = 0; k < G::ACC; ++k) sum[k] = 0.f;

  uint32_t acc[G::ACC];   // a group's P, overwritten by its first MMA
  for (int g = 0; g < ng; ++g) {
    // the group's GROUP / 32 slices: of its one step (GROUP <= 128), or
    // four of each of its two (256), a straight-line batch each
    const int i = g / G::GPK * G::SPG, gi = g % G::GPK;
    int s = i % G::STAGES;
    if (gi == 0) mbar_wait(full0 + 8 * s, (i / G::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < GROUP / 32 / G::SPG; ++q) {
      const uint32_t st = base + s * G::STAGE + (gi * (GROUP / 32) + q) * 32;
      wgmma_s8(acc, sw128_desc(st + wg * 64 * KSTEP), sw128_desc(st + G::W_OFF), q);
    }
    wgmma_commit();
    if constexpr (G::SPG == 2) {
      // the second half in the next step, added to the first
      s = (i + 1) % G::STAGES;
      mbar_wait(full0 + 8 * s, ((i + 1) / G::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t st = base + s * G::STAGE + q * 32;
        wgmma_s8(acc, sw128_desc(st + wg * 64 * KSTEP), sw128_desc(st + G::W_OFF), 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (G::SPG == 2 && lane == 0) mbar_arrive(empty0 + 8 * (i % G::STAGES));
    // the fold, in group order: float(P) exactly, times xs * gs, added
    const float* sg =
        reinterpret_cast<const float*>(sbase + s * G::STAGE + G::SC_OFF) + gi * G::SC_ROW;
    const float sx[2] = {sg[row], sg[row + 8]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 g2 = *reinterpret_cast<const float2*>(sg + BM + 8 * j + 2 * c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * j + 2 * h + e;
          const float p = __fsub_rn(__uint_as_float(acc[k] + MAGIC), MAGIC_F);
          sum[k] = __fadd_rn(sum[k], __fmul_rn(p, __fmul_rn(sx[h], e ? g2.y : g2.x)));
        }
    }
    // the step's last group releases its stage
    if ((gi == G::GPK - 1 || g == ng - 1) && lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // sum[4j + 2h + e] is row m0 + row + 8h, column n0 + 8j + 2c + e
  const bool pairs = F % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h, n = n0 + 8 * j + 2 * c;
      if (m >= M || n >= F) continue;
      const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
      const size_t o = size_t(m) * F + n;
      if (out_bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (n + 1 < F) p[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* p = static_cast<float*>(out) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (n + 1 < F) p[1] = v1;
        }
      }
    }
}

template <int GROUP, int BN>
cudaError_t opt_in() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_gemm_kernel<GROUP, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<GROUP, BN>::SMEM);
  return attr;
}

// xq [M, D] and qs [F, D] as the ring reads them: bytes, 128 columns x BM
// or BN rows a box, in the MMA's 128-byte swizzle
bool code_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return dlp_kgemm::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols, KSTEP,
                             box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int GROUP, int BN>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* qs, const float* gs,
                   void* out, int out_bf16, int M, int D, int F, cudaStream_t st) {
  const cudaError_t attr = opt_in<GROUP, BN>();
  if (attr != cudaSuccess) return attr;
  Maps maps;
  if (!code_map(&maps.x, xq, M, D, BM) || !code_map(&maps.w, qs, F, D, BN))
    return cudaErrorInvalidValue;
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<GROUP, BN>
      <<<grid, THREADS, Geo<GROUP, BN>::SMEM, st>>>(maps, xs, gs, out, out_bf16, M, D, F);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_group(const int8_t* xq, const float* xs, const int8_t* qs, const float* gs,
                         void* out, int out_bf16, int M, int D, int F, int group,
                         cudaStream_t st) {
  switch (group) {
    case 256: return launch<256, BN>(xq, xs, qs, gs, out, out_bf16, M, D, F, st);
    case 128: return launch<128, BN>(xq, xs, qs, gs, out, out_bf16, M, D, F, st);
    case 64: return launch<64, BN>(xq, xs, qs, gs, out, out_bf16, M, D, F, st);
    case 32: return launch<32, BN>(xq, xs, qs, gs, out, out_bf16, M, D, F, st);
    default: return cudaErrorInvalidValue;
  }
}

// out = {rows of x a block, rows of qs a block, columns a k-step, stages,
// threads, dynamic shared memory bytes, blocks an SM holds}
template <int GROUP, int BN>
cudaError_t geometry(int* out) {
  using G = Geo<GROUP, BN>;
  cudaError_t err = opt_in<GROUP, BN>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, int8_gemm_kernel<GROUP, BN>,
                                                        THREADS, G::SMEM);
  const int geo[7] = {BM, BN, KSTEP, G::STAGES, THREADS, G::SMEM, blocks};
  for (int i = 0; i < 7; ++i) out[i] = geo[i];
  return err;
}

template <int BN>
cudaError_t geometry_group(int group, int* out) {
  switch (group) {
    case 256: return geometry<256, BN>(out);
    case 128: return geometry<128, BN>(out);
    case 64: return geometry<64, BN>(out);
    case 32: return geometry<32, BN>(out);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32. Each returns the cudaError_t
// of its launch (0 = launched).
extern "C" int dlp_int8_quantize_acts(const void* x, int8_t* xq, float* xs, int x_bf16, int M,
                                      int D, int group, void* stream) {
  if (M < 1 || group < 32 || group > 256 || group % 32 || D % group)
    return int(cudaErrorInvalidValue);
  const int pairs = M * (D / group);
  quantize_kernel<<<(pairs + kQWarps - 1) / kQWarps, kQWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, x_bf16 != 0, xq, xs, M, D, group);
  return int(cudaGetLastError());
}

// bn: 128 or 64 rows of qs a block, from the host's plan (int8_plan); group
// 256, 128, 64 or 32.
extern "C" int dlp_int8_matmul(const int8_t* xq, const float* xs, const int8_t* qs,
                               const float* gs, void* out, int out_bf16, int M, int D, int F,
                               int group, int bn, void* stream) {
  if (M < 1 || F < 1 || group < 32 || D % group || (M + BM - 1) / BM > 65535 ||
      (bn != 128 && bn != 64))
    return int(cudaErrorInvalidValue);
  if (!aligned16(xq) || !aligned16(qs)) return int(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bn == 128 ? launch_group<128>(xq, xs, qs, gs, out, out_bf16, M, D, F, group, st)
                       : launch_group<64>(xq, xs, qs, gs, out, out_bf16, M, D, F, group, st));
}

// The GEMM's tiling for a group and bn (see geometry above), for the host's
// plan. Returns the cudaError_t of the queries.
extern "C" int dlp_int8_matmul_geometry(int group, int bn, int* out) {
  if (bn == 128) return int(geometry_group<128>(group, out));
  if (bn == 64) return int(geometry_group<64>(group, out));
  return int(cudaErrorInvalidValue);
}
