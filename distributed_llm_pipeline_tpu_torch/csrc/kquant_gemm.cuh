// Fused-dequant GEMM over the band-interleaved Q4_K and Q6_K packs and the
// Q5_K and Q8_0 byte-code packs for Hopper (sm_90a): the one kernel template
// behind dequant_matmul.cu's dlp_dequant_matmul_q4_k, _q6_k, _q5_k and _q8_0.
//
// Replaces the TPU kernels `q4_k_matmul_pallas`, `q6_k_matmul_pallas` and
// `q5_k_matmul_pallas` (distributed_llm_pipeline_tpu/ops/kquant_matmul.py,
// `_q4k_kernel`, `_q6k_kernel`, `_q5k_kernel`) and `q8_0_matmul_pallas`
// (ops/quant_matmul.py, `_q8_kernel`). Contract (dequant_matmul.cu):
// out [M, F] = x [M, D] . W^T, x bf16, each weight value bf16(code * scale)
// -- the exact product rounded once -- and the products accumulated in f32;
// Q4_K and Q5_K (w = a * q - b per 32 rows) do not fold b into the weight:
// they subtract bf16(sum of x over each 32 columns) * b, the sums taken in
// f32. Output f32 or bf16.
//
//   Q4_K  qs [F, D/2] (byte j: row j in its low nibble, row D/2 + j in its
//         high one), a, b bf16 [F, D/32]
//   Q6_K  ql [F, D/2] (byte j: row j low, D/2 + j high), qh [F, D/4] (bits
//         2k..2k+1 of byte j: row k * D/4 + j), s bf16 [F, D/16]
//   Q5_K  q5 [F, D] (one code in [0, 31] a byte: a tensor-parallel row shard
//         splits it like a dense weight, so D is only a multiple of 32),
//         a, b bf16 [F, D/32]
//   Q8_0  qs [F, D] (one signed code in [-128, 127] a byte, D a multiple of
//         32), scale bf16 [F, D/32]
//
// What bounds it. At prefill widths (M = 512, D x F = 2048 x 8192) the
// product's 17 GFLOP take 17 us at the bf16 tensor-core rate and the packs'
// 10-14 MB 3-4 us of memory time: operations. So the design keeps the tensor
// cores fed and moves each packed byte once per block:
//
// - Band-interleaved k-steps. A k-step covers the packed positions
//   [32t, 32t + 32) of every band at once -- two 32-column slabs of x and W
//   for Q4_K (columns p.. of band 0 and D/2 + p.. of band 1), four for Q6_K
//   -- the TPU kernels' contraction order: each packed byte is fetched once
//   and decoded into all its bands. Q5_K and Q8_0 have one plane and no
//   bands: a k-step covers four consecutive 32-column slabs (128 codes a row), so
//   that, as for Q6_K, 8 MMAs share each step's handoff (the full-barrier
//   wait, the wgmma commit and wait, the release); with one slab a step the
//   handoff would come once every 2 MMAs. A D that 128 does not divide ends
//   in a ragged step: only its real slabs are loaded and multiplied.
// - The product is computed transposed, out^T = W . x^T, with wgmma
//   m64nBMk16 in its register form: the decoded weights are the A operand,
//   in registers, and x is the B operand, in shared memory. A block is two
//   consumer warpgroups of 64 rows of W each (128 output columns) over BM =
//   64 or 128 rows of x, with f32 accumulators in registers.
// - Decode straight into the A fragments. Each thread reads, from the staged
//   planes, the bytes of its two W rows at the four positions its fragment
//   holds, and turns a code into bf16 exactly in pairs (byte_perm puts each
//   code under the exponent of 128, giving 128 + code; a bf16x2 subtract of
//   128, or of 160 for Q6_K's code + 32, leaves the code), then one bf16x2
//   multiply by the scale rounds the exact product once: bf16(code * scale),
//   the contract's value. The trick holds for a byte below 128 only (its top
//   bit would land in the exponent), so Q8_0's signed byte c goes in two
//   halves: its low 7 bits under the exponent give 128 + (c & 127), its sign
//   bit under the same exponent the bias, 128 (0x4300) or 256 (0x4380), and
//   the one subtract leaves c exactly for all 256 byte values, -128
//   included. The fragments of step i + 1 are decoded while the
//   tensor cores multiply step i (two register sets). Nothing the threads
//   write is read by the tensor cores through shared memory, so the loop
//   needs no proxy fence and no block-wide barrier (a decoded W tile staged
//   in shared memory needs fence.proxy.async, which compiles to a CTA-wide
//   memory barrier, and on the H100 the decode then did not overlap the
//   MMAs).
// - An asynchronous ring, filled by TMA. STAGES shared-memory stages each
//   hold a step's x slabs and raw packed bytes. One producer thread refills
//   a stage as soon as both warpgroups release it, every box by TMA through
//   2D tensor maps (x's built per launch, the pack's once for each placement
//   of it): x in boxes of 32 columns x BM rows that land in the MMA's
//   64-byte swizzle, the code planes in 32-byte x 128-row boxes; rows past M
//   or F and columns past the end land as 0. One
//   mbarrier a stage counts the bytes, another hands the stage back. The
//   scales come a window of 8 or 16 steps at a time, 48 bytes a row and
//   band, into two window slots: loaded a step at a time they were many
//   tiny rows of TMA work and held the block back on the H100 (as did the
//   codes staged by one warp's cp.async). Q5_K's four scales of a step are
//   adjacent (Q8_0's too): one box a window. A TMA row pitch must be a
//   multiple of 16 bytes; a Q5_K shard's a and b rows and a Q8_0 scale row
//   are D/16 bytes, so the host hands the maps copies padded to 8 values a
//   row where D/32 is not a multiple of 8 (ops/quant_matmul.py
//   gemm_pack_maps, once for each placement).
// - The affine offset term as one more stretch of K: a first small kernel
//   writes -bf16(sum_32 x) [M, D/32] (zero-padded to a multiple of 32
//   columns) to a workspace; the GEMM's last k-steps multiply b (the A
//   operand, read as it is) against it, and skip any 16-deep MMA that would
//   hold only padding.
// - Split-K where the grid is thin, from shapes only (the host's plan,
//   ops/quant_matmul.py `gemm_plan`, reads the tiling through the library's
//   *_geometry entries): each split writes an f32 partial tile to a
//   workspace and a second kernel sums them in split order (no atomics: a
//   relaunch gives the same bits).
// - The epilogue turns the transposed tile back through shared memory and
//   writes rows of 4 outputs (16-byte f32 or 8-byte bf16 stores where F
//   allows), masking the ragged M and F edges.
//
// PERF.md has the measurements.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace dlp_kgemm {
// Internal linkage: launch's function-local statics (the shared-memory
// opt-in) belong to this library alone (see paged_tile.cuh).
namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128;        // rows of W (output columns) a block: two warpgroups of 64
constexpr int SLAB = 32;       // columns of a slab: one 64-byte smem row
constexpr int XSUM_SUB = 32;   // Q4_K's and Q5_K's offset sub-block
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 32;   // + the producer warp

// The packs, as a stage holds them for BN = 128 rows of W. A k-step covers
// POS packed positions of each of BANDS bands: SLABS 32-column slabs of x
// and of W. RAW_BYTES of codes, plane by plane (Q4_K: qs [128][32]; a step
// of the offset term: b [128][64], 32 columns of bf16; Q6_K: ql bands 0/2,
// ql bands 1/3, qh, each [128][32]; Q5_K: q5 and Q8_0: qs, one [128][32] box
// a slab).
// The scales come a window of WIN k-steps at a time (Q4_K's a: one a band
// and step; Q6_K's s: two; Q5_K's a: four, adjacent), into one of two
// window slots: per scale band (SC_BANDS) and row a box of SC_BOX values
// from the 8-aligned column at or before the window's first (a
// 16-byte-aligned box, and a window is longer than the ring, so a slot is
// never reloaded before its last step is decoded). D_ALIGN: the D the pack
// takes is a multiple of it.
struct Q4K {
  static constexpr int BANDS = 2, POS = 32, SLABS = 2, RAW_BYTES = BN * 64;
  static constexpr int RAW_TX = BN * 32;   // a weight step's codes
  static constexpr int SC_BANDS = 2, PER_STEP = 1, WIN = 16, SC_BOX = 24;
  static constexpr bool AFFINE = true;
  static constexpr int D_ALIGN = 256;
  static constexpr int stages(int bm) { return bm == 64 ? 10 : 7; }
};

struct Q6K {
  static constexpr int BANDS = 4, POS = 32, SLABS = 4, RAW_BYTES = 3 * BN * 32;
  static constexpr int RAW_TX = RAW_BYTES;
  static constexpr int SC_BANDS = 4, PER_STEP = 2, WIN = 8, SC_BOX = 24;
  static constexpr bool AFFINE = false;
  static constexpr int D_ALIGN = 256;
  static constexpr int stages(int bm) { return bm == 64 ? 6 : 4; }
};

struct Q5K {
  static constexpr int BANDS = 1, POS = 4 * SLAB, SLABS = 4, RAW_BYTES = SLABS * BN * 32;
  static constexpr int RAW_TX = RAW_BYTES;
  static constexpr int SC_BANDS = 1, PER_STEP = SLABS, WIN = 8, SC_BOX = 40;
  static constexpr bool AFFINE = true;
  static constexpr int D_ALIGN = SLAB;
  static constexpr int stages(int bm) { return bm == 64 ? 6 : 4; }
};

// Q5_K's layout without the offset: signed codes, one scale per 32 columns
struct Q8 {
  static constexpr int BANDS = 1, POS = 4 * SLAB, SLABS = 4, RAW_BYTES = SLABS * BN * 32;
  static constexpr int RAW_TX = RAW_BYTES;
  static constexpr int SC_BANDS = 1, PER_STEP = SLABS, WIN = 8, SC_BOX = 40;
  static constexpr bool AFFINE = false;
  static constexpr int D_ALIGN = SLAB;
  static constexpr int stages(int bm) { return bm == 64 ? 6 : 4; }
};

// The tensor maps of a pack, encoded once for each placement of it: the code
// planes (bytes, 32 columns x 128 rows: Q4_K qs, Q5_K q5 and Q8_0 qs in
// codes0; Q6_K ql in codes0, qh in codes1), the scales (bf16, SC_BOX columns:
// Q4_K and Q5_K a, Q6_K s, Q8_0 scale) and the affine packs' b (bf16, 32
// columns).
struct PackMaps {
  CUtensorMap codes0, codes1, scales, b;
};

// ... and of a launch: x and the block sums (bf16, boxes of 32 columns x BM
// rows, 64-byte swizzled), then the pack's
struct Maps {
  CUtensorMap x, xs;
  PackMaps pk;
};

// The tiling of one instantiation, defined here only: BM rows of x, and the
// shared-memory map (the stages: x slabs | raw codes; two scale window
// slots; the mbarriers).
// The epilogue reuses the stages for the transposed output tile.
template <class Dec, int BM>
struct Geo {
  static constexpr int STAGES = Dec::stages(BM);
  static constexpr int X_BYTES = Dec::SLABS * BM * 64;
  static constexpr int RAW_OFF = X_BYTES;
  static constexpr int STAGE = (RAW_OFF + Dec::RAW_BYTES + 1023) / 1024 * 1024;
  static constexpr int SC_BAND = BN * Dec::SC_BOX * 2;          // a band's boxes
  static constexpr int SC_SLOT = Dec::SC_BANDS * SC_BAND;       // a window slot
  static constexpr int SC_OFF = STAGES * STAGE;                 // two window slots
  static constexpr int BAR_OFF = SC_OFF + 2 * SC_SLOT;   // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;  // + slack to align the base
  static constexpr int ACC = BM / 2;                 // f32 accumulators a thread
  static constexpr int NA = Dec::SLABS * 2 * 4;      // A registers a step: 4 a 16-deep MMA
  static constexpr int LDO = BN + 4;                 // f32 a row of the output tile
  static_assert(BM * LDO * 4 <= BAR_OFF, "the output tile fits in the stages");
  static_assert(Dec::WIN >= STAGES - 2, "a window outlives the ring");
  static_assert(Dec::PER_STEP * Dec::WIN + 8 <= Dec::SC_BOX, "a box holds its window");
  static_assert(Dec::SLABS * SLAB == Dec::BANDS * Dec::POS, "a step's slabs cover its positions");
};

// the weight's k-steps (the last one ragged where D / BANDS is not a
// multiple of POS: Q5_K only)
template <class Dec>
__host__ __device__ constexpr int main_steps(int D) {
  return (D + Dec::BANDS * Dec::POS - 1) / (Dec::BANDS * Dec::POS);
}
// the Q4_K offset term: 32 columns of [M, D/32] a step
__host__ __device__ constexpr int tail_steps(int D, bool affine) {
  return affine ? (D / XSUM_SUB + SLAB - 1) / SLAB : 0;
}
__host__ __device__ constexpr int xsum_cols(int D) {
  return (D / XSUM_SUB + SLAB - 1) / SLAB * SLAB;
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// ---------------------------------------------------------------------------
// PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a box of the tensor map at (column c, row r) into shared memory at dst,
// counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}
// the consumer warpgroups only (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving registers an in-flight wgmma uses
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The B operand (x, K-major) in the 64-byte swizzle: rows of 32 bf16 (64
// bytes), 8-row groups 512 bytes apart (SBO), the leading offset unused (1);
// the tile base is 512-byte aligned and a 16-deep slice starts 32 bytes in.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
         (uint64_t(2) << 62);
}

// d = A (64 x 16 of W, the warpgroup's fragments in a[0..3]) . B (16 x N of
// x^T, K-major in shared memory), plus d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// decode: codes (one per byte, each below 128, or signed for Q8_0) times a
// scale, in pairs

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf16x2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// bytes SEL (0x4140: bytes 0, 1; 0x4342: bytes 2, 3) of `codes` under the
// exponent of 128: bf16 0x43cc = 128 + cc exactly; less `bias` (128 + the
// code's offset), exactly; times the scale, rounded once
template <uint32_t SEL>
__device__ __forceinline__ uint32_t scaled_pair(uint32_t codes, __nv_bfloat162 bias,
                                                __nv_bfloat162 scale) {
  const uint32_t v = __byte_perm(codes, 0x43434343u, SEL);
  return bf16x2_bits(__hmul2(__hsub2(bits_bf16x2(v), bias), scale));
}

// Q8_0's signed bytes: the low 7 bits of each (`low7`, codes & 0x7f7f7f7f)
// under the exponent of 128 give 128 + (c & 127); its sign bit (`sign`,
// codes & 0x80808080) under the same exponent gives 0x4300 (128) or 0x4380
// (256); the difference is c exactly, for every byte value
template <uint32_t SEL>
__device__ __forceinline__ uint32_t signed_pair(uint32_t low7, uint32_t sign,
                                                __nv_bfloat162 scale) {
  const uint32_t v = __byte_perm(low7, 0x43434343u, SEL);
  const uint32_t bias = __byte_perm(sign, 0x43434343u, SEL);
  return bf16x2_bits(__hmul2(__hsub2(bits_bf16x2(v), bits_bf16x2(bias)), scale));
}

__device__ __forceinline__ __nv_bfloat162 splat(uint16_t h) {
  return bits_bf16x2(uint32_t(h) | (uint32_t(h) << 16));
}

// The bytes of a fragment row in a 32-byte plane row: positions 2c, 2c + 1
// (low half) and 2c + 8, 2c + 9 (high half) of the 16-deep block at kb * 16.
__device__ __forceinline__ uint32_t frag_bytes(const uint8_t* row, int kb, int c) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(row + 16 * kb + 2 * c);
  return uint32_t(p[0]) | (uint32_t(p[4]) << 16);
}

// Band k's column of step t's first scale, and the first column of the box
// that holds it in step t's window slot.
template <class Dec>
__device__ __forceinline__ int scale_col(int k, int t, int D) {
  return k * (D / 64) + Dec::PER_STEP * t;
}
template <class Dec>
__device__ __forceinline__ int window_col(int k, int t, int D) {
  return scale_col<Dec>(k, t / Dec::WIN * Dec::WIN, D) & ~7;
}
// step t's scales in its window slot `sc`: band k, row rr, value j
template <class Dec>
__device__ __forceinline__ uint16_t scale_at(const uint8_t* sc, int k, int rr, int t, int j,
                                             int D) {
  const int col = scale_col<Dec>(k, t, D) + j - window_col<Dec>(k, t, D);
  return reinterpret_cast<const uint16_t*>(sc + k * BN * Dec::SC_BOX * 2 +
                                           rr * Dec::SC_BOX * 2)[col];
}

// The A fragments of one k-step for this thread: W rows r (and r + 8) of the
// stage; 16-deep block q = 2 * band + kb in a[4q .. 4q + 3]: (row r, k 2c..),
// (r + 8, 2c..), (r, 2c + 8..), (r + 8, 2c + 8..).
__device__ __forceinline__ void decode(Q4K, const uint8_t* raw, const uint8_t* sc, int r, int c,
                                       int t, int D, uint32_t (&a)[16]) {
  const __nv_bfloat162 bias = bits_bf16x2(0x43004300u);   // 128
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
    const __nv_bfloat162 s0 = splat(scale_at<Q4K>(sc, 0, rr, t, 0, D));
    const __nv_bfloat162 s1 = splat(scale_at<Q4K>(sc, 1, rr, t, 0, D));
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const uint32_t q = frag_bytes(raw + rr * 32, kb, c);
      const uint32_t lo = q & 0x0F0F0F0Fu, hi = (q >> 4) & 0x0F0F0F0Fu;
      a[4 * kb + h] = scaled_pair<0x4140u>(lo, bias, s0);
      a[4 * kb + 2 + h] = scaled_pair<0x4342u>(lo, bias, s0);
      a[8 + 4 * kb + h] = scaled_pair<0x4140u>(hi, bias, s1);
      a[8 + 4 * kb + 2 + h] = scaled_pair<0x4342u>(hi, bias, s1);
    }
  }
}

__device__ __forceinline__ void decode(Q6K, const uint8_t* raw, const uint8_t* sc, int r, int c,
                                       int t, int D, uint32_t (&a)[32]) {
  const __nv_bfloat162 bias = bits_bf16x2(0x43204320u);   // 160 = 128 + 32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const uint32_t la = frag_bytes(raw + rr * 32, kb, c);
      const uint32_t lb = frag_bytes(raw + BN * 32 + rr * 32, kb, c);
      const uint32_t qh = frag_bytes(raw + 2 * BN * 32 + rr * 32, kb, c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t l = (k & 1) ? lb : la;
        const uint32_t codes =
            ((l >> ((k >> 1) * 4)) & 0x0F0F0F0Fu) | (((qh >> (2 * k)) & 0x03030303u) << 4);
        const __nv_bfloat162 s = splat(scale_at<Q6K>(sc, k, rr, t, kb, D));
        a[8 * k + 4 * kb + h] = scaled_pair<0x4140u>(codes, bias, s);
        a[8 * k + 4 * kb + 2 + h] = scaled_pair<0x4342u>(codes, bias, s);
      }
    }
  }
}

// slab s of the step in a[8s .. 8s + 7], one scale a slab and row
__device__ __forceinline__ void decode(Q5K, const uint8_t* raw, const uint8_t* sc, int r, int c,
                                       int t, int D, uint32_t (&a)[32]) {
  const __nv_bfloat162 bias = bits_bf16x2(0x43004300u);   // 128
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
#pragma unroll
    for (int s = 0; s < Q5K::SLABS; ++s) {
      const __nv_bfloat162 sc_s = splat(scale_at<Q5K>(sc, 0, rr, t, s, D));
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const uint32_t q = frag_bytes(raw + s * BN * 32 + rr * 32, kb, c);
        a[8 * s + 4 * kb + h] = scaled_pair<0x4140u>(q, bias, sc_s);
        a[8 * s + 4 * kb + 2 + h] = scaled_pair<0x4342u>(q, bias, sc_s);
      }
    }
  }
}

// Q8_0: as Q5_K, each code signed
__device__ __forceinline__ void decode(Q8, const uint8_t* raw, const uint8_t* sc, int r, int c,
                                       int t, int D, uint32_t (&a)[32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
#pragma unroll
    for (int s = 0; s < Q8::SLABS; ++s) {
      const __nv_bfloat162 sc_s = splat(scale_at<Q8>(sc, 0, rr, t, s, D));
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const uint32_t q = frag_bytes(raw + s * BN * 32 + rr * 32, kb, c);
        const uint32_t low7 = q & 0x7F7F7F7Fu, sign = q & 0x80808080u;
        a[8 * s + 4 * kb + h] = signed_pair<0x4140u>(low7, sign, sc_s);
        a[8 * s + 4 * kb + 2 + h] = signed_pair<0x4342u>(low7, sign, sc_s);
      }
    }
  }
}

// the offset term's A: b [128][32 bf16] as it is, in a[0..7]
template <int N>
__device__ __forceinline__ void offset_frags(const uint8_t* raw, int r, int c,
                                             uint32_t (&a)[N]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(raw + (r + 8 * h) * 64);
      a[4 * kb + h] = row[8 * kb + c];
      a[4 * kb + 2 + h] = row[8 * kb + 4 + c];
    }
}

// the producer (one thread): step t into the stage at `st`, every box by TMA
// and counted on `full` (boxes past M, F or the offset term's end land as
// 0); at a window's first step (or the split's first) also the window's
// scales into its slot
template <class Dec, int BM>
__device__ __forceinline__ void load_step(const Maps& maps, int D, int m0, int n0, int t, int k0,
                                          int n_main, uint32_t st, uint32_t sc0, uint32_t full) {
  using G = Geo<Dec, BM>;
  const uint32_t raw = st + G::RAW_OFF;
  if (t < n_main) {
    const bool window = t == k0 || t % Dec::WIN == 0;
    const int p = t * Dec::POS, band = D / Dec::BANDS;
    const int sc_bytes = window ? G::SC_SLOT : 0;
    if constexpr (Dec::BANDS == 1) {
      // Q5_K, Q8_0: the step's slabs of x and of the codes that lie inside D
      const int slabs = min(Dec::SLABS, (D - p) / SLAB);
      mbar_arrive_tx(full, slabs * (BM * 64 + BN * SLAB) + sc_bytes);
      for (int s = 0; s < slabs; ++s) {
        tma_load(st + s * BM * 64, &maps.x, p + SLAB * s, m0, full);
        tma_load(raw + s * BN * SLAB, &maps.pk.codes0, p + SLAB * s, n0, full);
      }
    } else {
      mbar_arrive_tx(full, G::X_BYTES + Dec::RAW_TX + sc_bytes);
#pragma unroll
      for (int s = 0; s < Dec::BANDS; ++s)
        tma_load(st + s * BM * 64, &maps.x, s * band + p, m0, full);
      tma_load(raw, &maps.pk.codes0, p, n0, full);
      if constexpr (!Dec::AFFINE) {   // Q6_K: ql of bands 1/3 and qh too
        tma_load(raw + BN * 32, &maps.pk.codes0, D / 4 + p, n0, full);
        tma_load(raw + 2 * BN * 32, &maps.pk.codes1, p, n0, full);
      }
    }
    if (window) {
      const uint32_t sc = sc0 + (t / Dec::WIN % 2) * G::SC_SLOT;
#pragma unroll
      for (int k = 0; k < Dec::SC_BANDS; ++k)
        tma_load(sc + k * G::SC_BAND, &maps.pk.scales, window_col<Dec>(k, t, D), n0, full);
    }
  } else {
    // the offset term: columns [32u, 32u + 32) of -bf16(sum_32 x) and of b
    const int u = t - n_main;
    mbar_arrive_tx(full, BM * 64 + BN * 64);
    tma_load(st, &maps.xs, SLAB * u, m0, full);
    tma_load(raw, &maps.pk.b, SLAB * u, n0, full);
  }
}

// ---------------------------------------------------------------------------
// the kernels

// grid (F / BN, M / BM, splits); split z runs k-steps [z * sps, (z + 1) * sps)
template <class Dec, int BM>
__global__ void __launch_bounds__(THREADS, 1)
kgemm_kernel(const __grid_constant__ Maps maps, float* __restrict__ part, void* __restrict__ out,
             int out_bf16, int M, int D, int F, int sps) {
  using G = Geo<Dec, BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw0);
  const uint32_t full0 = base + G::BAR_OFF, empty0 = full0 + 8 * G::STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_main = main_steps<Dec>(D);
  const int total = n_main + tail_steps(D, Dec::AFFINE);
  const int k0 = blockIdx.z * sps;
  const int ns = min(total, k0 + sps) - k0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's arrival (and its TMA bytes)
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);   // each consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer: one thread refills each stage once both warpgroups release it
    if (threadIdx.x == CONSUMERS) {
      for (int j = 0; j < ns; ++j) {
        const int s = j % G::STAGES;
        if (j >= G::STAGES) mbar_wait(empty0 + 8 * s, (j / G::STAGES - 1) & 1);
        load_step<Dec, BM>(maps, D, m0, n0, k0 + j, k0, n_main, base + s * G::STAGE,
                           base + G::SC_OFF, full0 + 8 * s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns W rows [64 wg, 64 wg + 64) of the block;
  // this thread's fragment rows are r and r + 8, its column pair c. Each
  // warp releases a slot once its warpgroup's MMAs on it are done (its own
  // decode of the slot came earlier).
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r = 64 * wg + 16 * warp + lane / 4, c = lane % 4;
  const int nb = D / XSUM_SUB;
  const Dec dec{};
  // the block's first MMA overwrites the accumulators (no zero fill: a
  // non-MMA write to them between MMAs would make the compiler serialize the
  // MMAs)
  float acc[G::ACC];
  int accumulate = 0;
  uint32_t a0[G::NA], a1[G::NA];   // the fragments of two k-steps, in turn
  auto window_slot = [&](int t) { return sbase + G::SC_OFF + (t / Dec::WIN % 2) * G::SC_SLOT; };

  // One k-step: multiply step i with its fragments `cur`; once step i - 1's
  // products are done (its fragments `next` and its slot are free), release
  // the slot and decode step i + 1 into `next`. N_MMA is the step's count of
  // 16-deep MMAs. Each call site issues one straight-line batch: a branch
  // around the MMAs would merge into a compiler-made commit, and the wait
  // below would then hold the batch just issued. Only the fragments are
  // fenced, each set once no MMA can be reading it (`cur` stays live until
  // the next step fences it as `next`); a fence on the accumulators while a
  // batch is in flight would make the compiler serialize the MMAs.
  auto step = [&](int i, auto n_mma, uint32_t(&cur)[G::NA], uint32_t(&next)[G::NA]) {
    const int t = k0 + i;
    const uint32_t xb = base + (i % G::STAGES) * G::STAGE;
    fence_regs(cur);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < decltype(n_mma)::value; ++q)
      wgmma_rs(acc, cur + 4 * q, sw64_desc(xb + (q / 2) * BM * 64 + (q % 2) * 32),
               q == 0 ? accumulate : 1);
    accumulate = 1;
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(next);
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % G::STAGES));
    if (i + 1 < ns) {
      const int s = (i + 1) % G::STAGES;
      const uint8_t* st = sbase + s * G::STAGE;
      mbar_wait(full0 + 8 * s, ((i + 1) / G::STAGES) & 1);
      if (t + 1 < n_main) {
        decode(dec, st + G::RAW_OFF, window_slot(t + 1), r, c, t + 1, D, next);
      } else {
        offset_frags(st + G::RAW_OFF, r, c, next);
      }
    }
  };
  // a weight step: every slab, or in the ragged last step of a Q5_K or Q8_0
  // D that 128 does not divide, only the slabs inside D (1 to 3: 2 to 6 MMAs)
  const int last_slabs = (D - (n_main - 1) * Dec::POS * Dec::BANDS) / SLAB;
  auto main_step = [&](int i, uint32_t(&cur)[G::NA], uint32_t(&next)[G::NA]) {
    if constexpr (Dec::D_ALIGN < Dec::SLABS * SLAB) {
      static_assert(Dec::SLABS == 4, "the ragged step's batches below");
      if (k0 + i == n_main - 1 && last_slabs < Dec::SLABS) {
        if (last_slabs == 1) {
          step(i, Int<2>(), cur, next);
        } else if (last_slabs == 2) {
          step(i, Int<4>(), cur, next);
        } else {
          step(i, Int<6>(), cur, next);
        }
        return;
      }
    }
    step(i, Int<2 * Dec::SLABS>(), cur, next);
  };
  // the offset term: every slab but the last holds 32 real columns
  auto offset_step = [&](int i, uint32_t(&cur)[G::NA], uint32_t(&next)[G::NA]) {
    if (i + 1 < ns || nb - SLAB * (k0 + i - n_main) > 16) {
      step(i, Int<2>(), cur, next);
    } else {
      step(i, Int<1>(), cur, next);
    }
  };
  auto offset_steps = [&](int i, uint32_t(&p)[G::NA], uint32_t(&q)[G::NA]) {
    for (; i < ns; i += 2) {
      offset_step(i, p, q);
      if (i + 1 < ns) offset_step(i + 1, q, p);
    }
  };

  mbar_wait(full0, 0);
  if (k0 < n_main) {
    decode(dec, sbase + G::RAW_OFF, window_slot(k0), r, c, k0, D, a0);
    const int i_main = min(ns, n_main - k0);
    int i = 0;
    for (; i + 1 < i_main; i += 2) {
      main_step(i, a0, a1);
      main_step(i + 1, a1, a0);
    }
    if (i < i_main) {
      main_step(i, a0, a1);
      if constexpr (Dec::AFFINE) offset_steps(i + 1, a1, a0);
    } else if constexpr (Dec::AFFINE) {
      offset_steps(i, a0, a1);
    }
  } else if constexpr (Dec::AFFINE) {
    offset_frags(sbase + G::RAW_OFF, r, c, a0);
    offset_steps(0, a0, a1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the transposed tile to shared memory (the stages are free: every step
  // has been consumed), then rows of 4 outputs to global memory.
  // acc[4j + 2h + e] is W row r + 8h, x row 8j + 2c + e
  consumers_sync();
  float* tile = reinterpret_cast<float*>(sbase);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(8 * j + 2 * c + e) * G::LDO + r + 8 * h] = acc[4 * j + 2 * h + e];
  consumers_sync();
  float* const dst = gridDim.z > 1 ? part + size_t(blockIdx.z) * M * F : nullptr;
  const bool quads = F % 4 == 0;
  for (int k = threadIdx.x; k < BM * (BN / 4); k += CONSUMERS) {
    const int m = k / (BN / 4), f = 4 * (k % (BN / 4));
    if (m0 + m >= M || n0 + f >= F) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + m * G::LDO + f);
    const float w[4] = {v.x, v.y, v.z, v.w};
    const size_t o = size_t(m0 + m) * F + n0 + f;
    if (dst || !out_bf16) {
      float* p = dst ? dst + o : static_cast<float*>(out) + o;
      if (quads) {
        *reinterpret_cast<float4*>(p) = v;
      } else {
        for (int e = 0; e < 4 && n0 + f + e < F; ++e) p[e] = w[e];
      }
    } else {
      bf16* p = static_cast<bf16*>(out) + o;
      if (quads) {
        *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2_bits(__floats2bfloat162_rn(v.x, v.y)),
                                                  bf16x2_bits(__floats2bfloat162_rn(v.z, v.w)));
      } else {
        for (int e = 0; e < 4 && n0 + f + e < F; ++e) p[e] = __float2bfloat16_rn(w[e]);
      }
    }
  }
}

// xs [M, KT] = -bf16(sum of x over each 32 columns), summed in f32 in
// column order; columns D/32 .. KT - 1 are 0
__global__ void xsum_kernel(const bf16* __restrict__ x, bf16* __restrict__ xs, int M, int D,
                            int KT) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(M) * KT) return;
  const size_t m = i / KT;
  const int j = int(i % KT);
  float s = 0.f;
  if (j < D / XSUM_SUB) {
    const int4* p = reinterpret_cast<const int4*>(x + m * D + size_t(j) * XSUM_SUB);
#pragma unroll
    for (int c = 0; c < XSUM_SUB / 8; ++c) {
      const int4 v = p[c];
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += __bfloat162float(e[k]);
    }
  }
  xs[i] = __float2bfloat16_rn(-s);
}

// out = the splits' partials [splits, n] summed in split order
__global__ void splitk_reduce_kernel(const float* __restrict__ part, void* __restrict__ out,
                                     int out_bf16, int splits, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[size_t(k) * n + i];
    if (out_bf16) {
      static_cast<bf16*>(out)[i] = __float2bfloat16_rn(s);
    } else {
      static_cast<float*>(out)[i] = s;
    }
  }
}

template <class Dec, int BM>
cudaError_t opt_in() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kgemm_kernel<Dec, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<Dec, BM>::SMEM);
  return attr;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [rows, cols] row-major, rows `pitch` elements apart (0: cols), in boxes of
// box_cols x box_rows, rows and columns past the end read as 0
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base, int rows,
              int cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle, int pitch = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(pitch ? pitch : cols) * esize};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x or the block sums: bf16, 32 columns (a slab) x bm rows, in the MMA's
// 64-byte swizzle
bool act_map(CUtensorMap* map, const void* base, int rows, int cols, int bm) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, SLAB, bm,
                  CU_TENSOR_MAP_SWIZZLE_64B);
}
bool byte_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols, SLAB, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
              int pitch = 0) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, box_cols, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE, pitch);
}

// Q5_K's a and b rows and Q8_0's scale rows as the maps read them: D/32
// values, rows padded to a multiple of 8 values (16 bytes, TMA's least row
// pitch)
constexpr int scale_pitch(int D) { return (D / XSUM_SUB + 7) / 8 * 8; }

// the packs' maps: Q4_K (qs, a, b), Q6_K (ql, qh, s), Q5_K (q5, a, b), Q8_0
// (qs, scale; its b map, never loaded, over the scales)
bool pack_maps(PackMaps& m, Q4K, const void* qs, const void* a, const void* b, int D, int F) {
  return byte_map(&m.codes0, qs, F, D / 2) && byte_map(&m.codes1, qs, F, D / 2) &&
         bf16_map(&m.scales, a, F, D / 32, Q4K::SC_BOX) && bf16_map(&m.b, b, F, D / 32, SLAB);
}
bool pack_maps(PackMaps& m, Q6K, const void* ql, const void* qh, const void* s, int D, int F) {
  return byte_map(&m.codes0, ql, F, D / 2) && byte_map(&m.codes1, qh, F, D / 4) &&
         bf16_map(&m.scales, s, F, D / 16, Q6K::SC_BOX) && bf16_map(&m.b, s, F, D / 16, SLAB);
}
bool pack_maps(PackMaps& m, Q5K, const void* q5, const void* a, const void* b, int D, int F) {
  const int pitch = scale_pitch(D);
  return byte_map(&m.codes0, q5, F, D) && byte_map(&m.codes1, q5, F, D) &&
         bf16_map(&m.scales, a, F, D / 32, Q5K::SC_BOX, pitch) &&
         bf16_map(&m.b, b, F, D / 32, SLAB, pitch);
}
bool pack_maps(PackMaps& m, Q8, const void* qs, const void* scale, const void*, int D, int F) {
  const int pitch = scale_pitch(D);
  return byte_map(&m.codes0, qs, F, D) && byte_map(&m.codes1, qs, F, D) &&
         bf16_map(&m.scales, scale, F, D / 32, Q8::SC_BOX, pitch) &&
         bf16_map(&m.b, scale, F, D / 32, SLAB, pitch);
}

// The pack's maps into `out` (sizeof(PackMaps) bytes), for the caller to keep
// while the pack stays where it is. p0, p1, p2: the pack's fields (Q4_K qs,
// a, b; Q6_K ql, qh, s; Q5_K q5, and a, b with rows scale_pitch(D) values
// apart; Q8_0 qs and scale with rows so apart, p2 unused).
template <class Dec>
cudaError_t encode_pack(const void* p0, const void* p1, const void* p2, int D, int F,
                        void* out) {
  if (F < 1 || D < Dec::D_ALIGN || D % Dec::D_ALIGN || out == nullptr)
    return cudaErrorInvalidValue;
  PackMaps m;
  if (!pack_maps(m, Dec{}, p0, p1, p2, D, F)) return cudaErrorInvalidValue;
  memcpy(out, &m, sizeof(m));
  return cudaSuccess;
}

template <class Dec, int BM>
cudaError_t launch_bm(const void* x, const void* xs, const void* pack, float* part, void* out,
                      int out_bf16, int M, int D, int F, int splits, int sps, cudaStream_t st) {
  using G = Geo<Dec, BM>;
  const cudaError_t attr = opt_in<Dec, BM>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  Maps maps;
  if (!act_map(&maps.x, x, M, D, BM) ||
      !act_map(&maps.xs, Dec::AFFINE ? xs : x, M, Dec::AFFINE ? xsum_cols(D) : D, BM))
    return cudaErrorInvalidValue;
  memcpy(&maps.pk, pack, sizeof(PackMaps));
  kgemm_kernel<Dec, BM><<<grid, THREADS, G::SMEM, st>>>(maps, part, out, out_bf16, M, D, F, sps);
  return cudaGetLastError();
}

// One call: (Q4_K, Q5_K) the block sums into xs [M, xsum_cols(D)], the GEMM over
// `bm` (64 or 128) rows of x a block in `splits` splits of `sps` k-steps,
// and (splits > 1) the reduction of part [splits, M, F] into out. pack: the
// pack's maps (encode_pack) in host memory.
template <class Dec>
cudaError_t launch(const void* x, void* xs, const void* pack, void* part, void* out,
                   int out_bf16, int M, int D, int F, int bm, int splits, int sps,
                   cudaStream_t st) {
  const int total = main_steps<Dec>(D) + tail_steps(D, Dec::AFFINE);
  if (M < 1 || F < 1 || D < Dec::D_ALIGN || D % Dec::D_ALIGN || (bm != 64 && bm != 128) ||
      splits < 1 ||
      splits > 65535 || sps < 1 || splits * sps < total || (splits - 1) * sps >= total ||
      (splits > 1 && part == nullptr) || (Dec::AFFINE && xs == nullptr) || pack == nullptr)
    return cudaErrorInvalidValue;
  if (Dec::AFFINE) {
    const size_t n = size_t(M) * xsum_cols(D);
    xsum_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(xs), M, D, xsum_cols(D));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  float* pw = splits > 1 ? static_cast<float*>(part) : nullptr;
  const cudaError_t err =
      bm == 64 ? launch_bm<Dec, 64>(x, xs, pack, pw, out, out_bf16, M, D, F, splits, sps, st)
               : launch_bm<Dec, 128>(x, xs, pack, pw, out, out_bf16, M, D, F, splits, sps, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = size_t(M) * F;
  const unsigned blocks = unsigned(n / 1024 + 1 < 8192 ? n / 1024 + 1 : 8192);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(pw, out, out_bf16, splits, n);
  return cudaGetLastError();
}

// out = {rows of x a block, rows of W a block, packed positions a k-step
// and band, bands, columns of the offset term a k-step (0: none), stages,
// threads, dynamic shared memory bytes, blocks an SM holds, the multiple of
// which D must be}: what ops/quant_matmul.py's gemm_plan cuts by
template <class Dec, int BM>
cudaError_t geometry_bm(int* out) {
  using G = Geo<Dec, BM>;
  cudaError_t err = opt_in<Dec, BM>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kgemm_kernel<Dec, BM>, THREADS,
                                                        G::SMEM);
  const int geo[10] = {BM,        BN,      Dec::POS, Dec::BANDS, Dec::AFFINE ? SLAB : 0,
                       G::STAGES, THREADS, G::SMEM,  blocks,     Dec::D_ALIGN};
  for (int i = 0; i < 10; ++i) out[i] = geo[i];
  return err;
}

template <class Dec>
cudaError_t geometry(int bm, int* out) {
  if (bm == 64) return geometry_bm<Dec, 64>(out);
  if (bm == 128) return geometry_bm<Dec, 128>(out);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dlp_kgemm
