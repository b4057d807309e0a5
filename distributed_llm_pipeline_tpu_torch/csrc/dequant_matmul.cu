// Fused-dequant matmul of bf16 activations against a Q8_0, Q6_K, Q4_K or
// Q5_K (byte-code) pack, for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels `q8_0_matmul_pallas` (distributed_llm_pipeline_
// tpu/ops/quant_matmul.py, `_q8_kernel`), `q6_k_matmul_pallas`,
// `q4_k_matmul_pallas` and `q5_k_matmul_pallas` (ops/kquant_matmul.py,
// `_q6k_kernel`, `_q4k_kernel`, `_q5k_kernel`). Same contract:
//   out [M, F] = x [M, D] @ W^T, W [F, D] = code * scale as the pack's
//   decoder gives it (quant_tile.cuh), each weight value dequantized in the
//   activation dtype -- the f32 product code * scale rounded once to bf16,
//   as the TPU kernels dequantize in x.dtype -- and the products accumulated
//   in f32. An affine pack (Q4_K, Q5_K: weight = code * scale - offset per
//   32 rows) does not fold the offset into the staged weight, which would
//   round code * scale - offset once more: as `_q4k_kernel` and
//   `_q5k_kernel`, it subtracts
//   bf16(sum of x over each 32 columns) * offset, accumulated in f32 with
//   the rest. Output in f32 or bf16.
//
// Design. Prefill and mixed steps (M > 32) are GEMMs that would be bounded
// by the tensor cores at large M; the dense bf16 weight never exists in
// device memory. One block (4 warps) owns a 64 x 64 output tile and walks D
// in 64-column steps: it stages x's 64 x 64 tile and decodes the weight's
// 64 x 64 tile into shared memory as bf16, then each warp runs 2 x 2 WMMA
// 16x16x16 bf16 products into f32 fragments. The next tile's global reads
// go into registers while the tensor cores work on this one. The output goes
// through shared memory so ragged M and F edges are masked. An affine
// pack's offset term is one more 16-deep WMMA slice per k-tile: x' holds the
// tile's two block sums of each row (8 columns a thread, summed in f32,
// then over 4 lanes), w' the two offsets of each output row, negated, and
// both are zero in their other 14 columns. No TMA, no wgmma, one
// shared-memory stage: a first kernel that is right; PERF.md has its
// distance from the bound. A tensor-parallel row shard of a Q5_K weight has
// a D that only 32 divides: the last k-tile then holds one sub-block and
// zeros (x, codes and offsets past D load as 0).

#include "quant_tile.cuh"

#include <mma.h>

namespace {

using namespace dlp_quant;
using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 8;   // bf16 per staged row: 144 B, 32-byte aligned fragments
constexpr int LDC = BN + 4;   // f32 per output-staging row
constexpr int LDO = 16;       // bf16 per row of the offset slices x', w'

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int XLOADS = BM * BK / 8 / kThreads;   // 16-byte x loads per thread and tile
constexpr int WLOADS = BN * BK / 16 / kThreads;  // 16-code weight decodes per thread and tile

// one k-tile's global reads, held in registers until the tile is staged
struct TileRegs {
  int4 x[XLOADS];
  int w[WLOADS][4];
  float sc[WLOADS];
  float off[WLOADS];  // affine packs: the offset of the 32 rows that start at c
};

template <class Dec>
__device__ __forceinline__ void load_tile(const Dec& dec, const __nv_bfloat16* x, int M, int D,
                                          int F, int m0, int n0, int k0, TileRegs& t) {
#pragma unroll
  for (int j = 0; j < XLOADS; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    t.x[j] = make_int4(0, 0, 0, 0);  // rows past M and columns past D are 0
    if (m0 + r < M && k0 + c < D)
      t.x[j] = *reinterpret_cast<const int4*>(x + size_t(m0 + r) * D + k0 + c);
  }
#pragma unroll
  for (int j = 0; j < WLOADS; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const int f = n0 + r;
    t.sc[j] = t.off[j] = 0.f;
    t.w[j][0] = t.w[j][1] = t.w[j][2] = t.w[j][3] = 0;
    if (f < F && k0 + c < D) {
      dec.codes16(f, k0 + c, t.w[j]);
      t.sc[j] = dec.scale_at(f, k0 + c);
      if constexpr (Dec::AFFINE) t.off[j] = dec.offset_at(f, k0 + c);
    }
  }
}

// the registers into shared memory: x as it is, each weight value as
// bf16(code * scale); for an affine pack also x's block sums into column
// c / 32 of xo and the negated offsets into column c / 32 of wo
template <class Dec>
__device__ __forceinline__ void stage_tile(const TileRegs& t, __nv_bfloat16* xt,
                                           __nv_bfloat16* wt, __nv_bfloat16* xo,
                                           __nv_bfloat16* wo) {
#pragma unroll
  for (int j = 0; j < XLOADS; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    *reinterpret_cast<int4*>(xt + r * LDS + c) = t.x[j];
  }
#pragma unroll
  for (int j = 0; j < WLOADS; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    uint32_t pk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      pk[e] = bf16x2(float(code_byte(t.w[j][e / 2], 2 * (e % 2))) * t.sc[j],
                     float(code_byte(t.w[j][e / 2], 2 * (e % 2) + 1)) * t.sc[j]);
    int4* dst = reinterpret_cast<int4*>(wt + r * LDS + c);
    dst[0] = make_int4(int(pk[0]), int(pk[1]), int(pk[2]), int(pk[3]));
    dst[1] = make_int4(int(pk[4]), int(pk[5]), int(pk[6]), int(pk[7]));
  }
  if constexpr (Dec::AFFINE) {
#pragma unroll
    for (int j = 0; j < XLOADS; ++j) {
      // the 4 adjacent lanes i % 8 = 0..3 (or 4..7) hold one row's 32 columns
      const int i = threadIdx.x + j * kThreads, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&t.x[j]);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += __bfloat162float(v[e]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (c % 32 == 0) xo[r * LDO + c / 32] = __float2bfloat16_rn(sum);
    }
#pragma unroll
    for (int j = 0; j < WLOADS; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      if (c % 32 == 0) wo[r * LDO + c / 32] = __float2bfloat16_rn(-t.off[j]);
    }
  }
}

template <class Dec>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(Dec dec, const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
               bool out_bf16, int M, int D, int F) {
  __shared__ __align__(32) __nv_bfloat16 xt[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 wt[BN * LDS];
  __shared__ __align__(32) float ct[BM * LDC];
  // the offset slices of an affine pack: columns 0 and 1 are staged per
  // k-tile, columns 2..15 stay 0
  __shared__ __align__(32) __nv_bfloat16 xo[Dec::AFFINE ? BM * LDO : 1];
  __shared__ __align__(32) __nv_bfloat16 wo[Dec::AFFINE ? BN * LDO : 1];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 quarter
  if constexpr (Dec::AFFINE) {
    for (int i = threadIdx.x; i < BM * (LDO - 2); i += kThreads) {
      xo[(i / (LDO - 2)) * LDO + 2 + i % (LDO - 2)] = __float2bfloat16_rn(0.f);
      wo[(i / (LDO - 2)) * LDO + 2 + i % (LDO - 2)] = __float2bfloat16_rn(0.f);
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  TileRegs regs;
  load_tile(dec, x, M, D, F, m0, n0, 0, regs);
  for (int k0 = 0; k0 < D; k0 += BK) {
    stage_tile<Dec>(regs, xt, wt, xo, wo);
    __syncthreads();
    // the next tile's reads are in flight while the tensor cores work
    if (k0 + BK < D) load_tile(dec, x, M, D, F, m0, n0, k0 + BK, regs);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xt + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wt + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if constexpr (Dec::AFFINE) {  // acc -= bf16(block sums of x) * offsets
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xo + (wm * 32 + i * 16) * LDO, LDO);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wo + (wn * 32 + j * 16) * LDO, LDO);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ct + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < M && n0 + c < F) store_f32(out, size_t(m0 + r) * F + n0 + c, ct[r * LDC + c], out_bf16);
  }
}

template <class Dec>
int launch(const Dec& dec, const void* x, void* out, int out_bf16, int M, int D, int F,
           void* stream) {
  if (M < 1 || F < 1 || D < 16 || D % 16 || (M + BM - 1) / BM > 65535) return int(cudaErrorInvalidValue);
  if (Dec::AFFINE && D % 32) return int(cudaErrorInvalidValue);  // k-tiles of whole sub-blocks
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_kernel<Dec><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, static_cast<const __nv_bfloat16*>(x), out, out_bf16 != 0, M, D, F);
  return int(cudaGetLastError());
}

}  // namespace

// x is bfloat16 [M, D]; out_bf16: 1 = bfloat16 output, 0 = float32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_dequant_matmul_q8_0(const void* x, const void* qs, const void* scale,
                                       void* out, int out_bf16, int M, int D, int F,
                                       void* stream) {
  const Q8_0 dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(scale), D};
  return launch(dec, x, out, out_bf16, M, D, F, stream);
}

extern "C" int dlp_dequant_matmul_q4_k(const void* x, const void* qs, const void* a,
                                       const void* b, void* out, int out_bf16, int M, int D,
                                       int F, void* stream) {
  const Q4K dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), D};
  return launch(dec, x, out, out_bf16, M, D, F, stream);
}

extern "C" int dlp_dequant_matmul_q5_k(const void* x, const void* q5, const void* a,
                                       const void* b, void* out, int out_bf16, int M, int D,
                                       int F, void* stream) {
  const Q5K dec{{static_cast<const int8_t*>(q5), static_cast<const __nv_bfloat16*>(a), D},
                static_cast<const __nv_bfloat16*>(b)};
  return launch(dec, x, out, out_bf16, M, D, F, stream);
}

extern "C" int dlp_dequant_matmul_q6_k(const void* x, const void* ql, const void* qh,
                                       const void* s, void* out, int out_bf16, int M, int D,
                                       int F, void* stream) {
  const Q6K dec{static_cast<const int8_t*>(ql), static_cast<const int8_t*>(qh),
                static_cast<const __nv_bfloat16*>(s), D};
  return launch(dec, x, out, out_bf16, M, D, F, stream);
}
