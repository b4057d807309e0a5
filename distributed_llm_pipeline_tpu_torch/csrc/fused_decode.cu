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
// What bounds it. A decode step at small B moves bytes: each weight once
// (Llama-3.2-1B: 2.62 MB a kv head, 21 MB a layer in bf16, 6.3 us at
// 3.35 TB/s), each visible pool position once, x, y and the new K/V; its
// multiply-adds (B a weight) are ~1.4 us of the card's f32 FMA rate at
// B = 4. On the H100 one SM draws a small share of the card's memory
// rate however it loads (bulk copies, 16-byte loads), so a head's weights
// are spread over a cluster of C CTAs, every load that does not depend on
// x is issued before x is read, and the arithmetic is kept off the
// critical path:
// in bf16 the matvecs run on the tensor cores, since an FMA unit spends
// ~3 instructions unpacking and reducing for each multiply-add.
//
// Design. Grid K * C, a cluster of C CTAs per kv head g (cluster rank c);
// 16 warps a CTA. C = 8 (fewer where 8 * K passes the SMs): the H100 holds
// 15 clusters of 8 at once but only 7 of 16, and 16 measured slower. The
// host cuts the work by shape alone (ops/fused_decode.py `fused_plan`);
// the kernel refuses a plan whose shared memory is not its layout's.
//   0. At the start, before x: warp 0 fills a ring of `stages` stages with
//      the CTA's run of the head's R*Hd + 2*Hd Q/K/V rows, 1-D bulk copies
//      (cp.async.bulk into an mbarrier a stage), one a row into rows 16
//      bytes longer than the data (a fragment's 8 rows then fall in
//      distinct banks), tiles cut at the wq | wk | wv edges, a q8_0 tile's
//      bf16 scales one run. A run of scales that does not start or end on
//      16 bytes is copied widened to the 16-byte grain that holds it (such
//      a grain lies in one page with the bytes it holds) and read at its
//      offset. (Prefetching the rest toward L2 measured no faster: one SM's
//      draw, not the memory, sets the pace.) After the norm every thread
//      issues cp.async copies (16 bytes, 8 for int8 codes, 4 for scales)
//      of its share of the CTA's first key tiles of K and V, their pool
//      rows read from the block tables at once; with `late_keys` (a cut
//      that fits no other way: f32 at a large B) their arrays overlay the
//      ring and these copies wait until RoPE is done.
//   1. Each CTA normalizes all B rows of x into shared memory (h).
//   2. Q/K/V tile by tile. bf16: mma.sync m16n8k16 with the batch rows as
//      M (16 a step, rows past B zero), 8 weight rows as N and 16 columns
//      as K, f32 sums; a warp takes an n-block by a slice of the columns
//      (16 units a tile), q8_0 codes dequantized into the B fragment as
//      code * scale rounded to bf16. f32: units of two rows by 256 columns
//      on the FMA units. Each output row's dot stays in one CTA. A tile
//      costs a near-fixed wait and barriers however many rows it has, so
//      a stage is ~64 KB (fewer, larger tiles measured faster). Two
//      block barriers a tile (one thread waits on the stage's mbarrier
//      first): once every warp's units are done, warp 0 refills the stage
//      while the other warps add each row's units in order (the tile's
//      sums, two buffers) and send the raw f32 products to every CTA of
//      the cluster through distributed shared memory (DSMEM), behind a
//      cluster barrier.
//   3. Every CTA applies RoPE and the rounding to the whole head (the half
//      style's pairs span the head, so rope follows the gather); rank 0
//      writes k_new / v_new.
//   4. Attention: row b's visible keys [lo, end) are cut into C runs, CTA c
//      taking [lo + n*c/C, lo + n*(c+1)/C), walked in tiles of 32 keys (one
//      a lane), tile-major over the rows; `kv_round` tiles a round,
//      `kv_buffers` rounds in flight (cp.async groups); an int8 round is
//      dequantized once into the activation dtype (each code read once,
//      not once a query head). Warp w owns the
//      tasks (b, r) = w, w + 16, ..., with an online-softmax partial (m, l,
//      acc) in shared memory; a lane scores its key against q over the
//      head dim in a lane-rotated order of 8-wide chunks (no bank
//      conflicts), then accumulates P * V with lanes over contiguous dims.
//   5. The C partials of each (b, r) are merged in CTA order through DSMEM
//      by CTA (b * R + r) % C, the diagonal term added once in the merge;
//      the rounded output goes to every CTA's [B, R*Hd] attention tile.
//   6. The O-projection of the CTA's D/C slice of wo's rows over the head
//      group's columns, its weights loaded straight into the MMA
//      fragments (a warp an n-block of 8 rows, each row's whole dot; f32:
//      FMA units), into ws[g][b][slice] (f32). Each CTA then takes a
//      ticket on its slice's counter; the last of the K CTAs of slice c
//      sums the K partials in head order 0..K-1, adds x and writes that
//      slice of y, then resets the counter. No float atomics: a relaunch
//      gives the same bits. One launch per layer; no CTA waits on another
//      cluster.
//
// Limits (ops/fused_decode.fused_supported answers them): head dims that
// are multiples of 8 up to 256, D a multiple of 8 (32 for q8_0 weights,
// and R*Hd a multiple of 32), and the plan's shared memory of at most
// 227 KB (kSmemLimit; B*D for h and B*(R+2)*Hd f32 products, whose places
// the attention's arrays take once RoPE has read them, the key tiles and
// the ring).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dlp_fused {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 4;        // batch rows a matvec pass
constexpr int kTK = 32;       // pool columns a key tile: one a lane
constexpr int kFill = 32;     // the thread that hands out key tiles
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 16;
constexpr int kMaxRound = 8;
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;   // f32(1/127), as the reference's jit
constexpr int kSmemLimit = 232448;         // 227 KB a block may use

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

__device__ __forceinline__ void bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

// 8 consecutive elements (16-byte aligned for bf16, 32 for f32, 8 for int8)
__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf16x2(u.x, o); bf16x2(u.y, o + 2); bf16x2(u.z, o + 4); bf16x2(u.w, o + 6);
}
__device__ __forceinline__ void load8(const int8_t* p, float o[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = float(int8_t((i < 4 ? u.x : u.y) >> (8 * (i % 4))));
}

// N = 2, 4 or 8 consecutive elements, aligned to their size
template <int N>
__device__ __forceinline__ void loadn(const float* p, float* o) {
  if constexpr (N == 8) {
    load8(p, o);
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 8) {
    load8(p, o);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2(u.x, o); bf16x2(u.y, o + 2);
  } else {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  }
}
template <int N>
__device__ __forceinline__ void loadn(const int8_t* p, float* o) {
  if constexpr (N == 8) {
    load8(p, o);
  } else {
    const uint32_t u = N == 4 ? *reinterpret_cast<const uint32_t*>(p)
                              : uint32_t(*reinterpret_cast<const uint16_t*>(p));
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = float(int8_t(u >> (8 * i)));
  }
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
}
template <int N>
__device__ __forceinline__ void storen(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(v[i], v[i + 1]);
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

// N <= 32 values a lane summed across the warp: at each of the first
// log2(N) butterfly steps a lane keeps half of its values (the upper half
// where its bit o is set) and adds its partner's copy of that half; the
// rest are plain butterfly steps. Lane l ends with value l / (32 / N).
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  static_assert(N <= 32 && (N & (N - 1)) == 0, "a power of two up to 32 values");
  int n = N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        if (j < n / 2) {
          const float keep = up ? v[j + n / 2] : v[j];
          const float send = up ? v[j] : v[j + n / 2];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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
// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(N)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a 16-byte grain run [a0, a0 + bytes) that holds [a, a + n)
__device__ __forceinline__ int widened(uintptr_t a, size_t n, uintptr_t& a0) {
  a0 = a & ~uintptr_t(15);
  return int(((a + n + 15) & ~uintptr_t(15)) - a0);
}

// ---------------------------------------------------------------------------
// the plan and the shared-memory layout

// the host's cut (ops/fused_decode.py `fused_plan`)
struct Plan {
  int cluster;      // C CTAs a kv head
  int qkv_rows;     // the head's Q/K/V rows a CTA (the last ones fewer)
  int out_rows;     // rows of wo (columns of y) a CTA
  int qkv_tile;     // Q/K/V rows a stage
  int stages;
  int stage_bytes;
  int kv_round;     // key tiles a round
  int kv_buffers;   // rounds in flight
  int late_keys;    // the key tiles' arrays overlay the ring: their copies wait for it
};

__host__ __device__ inline int a16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int chunks(int L) { return (L + 255) / 256; }   // 256 columns a unit
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets from the start of shared memory; ops/fused_decode.py
// `fused_layout` computes the same. In bf16, h [B][D + 8] and the attention
// output [B][R*Hd + 8] and a stage's rows (D*WB + 16 bytes apart) are
// padded so that a fragment's 8 rows fall in distinct banks (f32 rows are
// not). The roped q and the diagonal K/V take h's place once the Q/K/V
// tiles are done; the attention output and the partials follow them, over
// what h and the products leave once RoPE has read them. With late_keys
// the key tiles' arrays follow the partials too (over the products, the
// tiles' sums and the ring), else they lie before the ring.
struct Layout {
  int runs, h, prod, qr, kd, vd, at, pm, pl, pacc, red, items, vecs, kv, kvc, ring, bars, flag,
      total;
  int red_stage;                    // a tile's units' sums (two, alternating)
  int slot, slot_v, slot_s;         // a key tile: K, V at slot_v, int8 scales at slot_s
  int cslot, cslot_v;               // an int8 key tile dequantized: K, V at cslot_v
  int qkv_sc, qkv_need;             // a stage's q8_0 scale run, and its bytes
};

__host__ __device__ inline Layout make_layout(int B, int D, int R, int Hd, int ab, bool q8,
                                              bool kv8, const Plan& p) {
  const int RHd = R * Hd, NQ = RHd + 2 * Hd, wb = q8 ? 1 : ab, kb = kv8 ? 1 : ab;
  const int pad = ab == 2 ? 8 : 0;
  Layout L;
  L.qkv_sc = a16(p.qkv_tile * (D * wb + 16));
  L.qkv_need = L.qkv_sc + (q8 ? a16(p.qkv_tile * D / 16) + (D % 256 ? 16 : 0) : 0);
  L.slot_v = a16(kTK * Hd * kb);
  L.slot_s = 2 * L.slot_v;
  L.slot = L.slot_s + (kv8 ? 2 * kTK * 4 : 0);
  L.cslot_v = kv8 ? a16(kTK * Hd * ab) : 0;
  L.cslot = 2 * L.cslot_v;
  L.red_stage = a16(p.qkv_tile * imax(kWarps, chunks(D)) * B * 4);
  int o = 0;
  L.runs = o;  o += a16(2 * B * 4);
  L.h = o;
  int u = o;
  L.qr = u;    u += a16(B * RHd * ab);
  L.kd = u;    u += a16(B * Hd * 4);
  L.vd = u;    u += a16(B * Hd * 4);
  L.prod = o + imax(a16(B * (D + pad) * ab), u - o);
  L.at = u;    u += a16(B * (RHd + pad) * ab);
  L.pm = u;    u += a16(B * R * 4);
  L.pl = u;    u += a16(B * R * 4);
  L.pacc = u;  u += a16(B * R * Hd * 4);
  // the tiles' sums and the ring after the products (and, while the key
  // tiles are in flight under the Q/K/V tiles, after the partials too)
  o = L.red = p.late_keys ? L.prod + a16(B * NQ * 4) : imax(L.prod + a16(B * NQ * 4), u);
  o += 2 * L.red_stage;
  int& k = p.late_keys ? u : o;     // where the key tiles' arrays go
  L.items = k; k += a16(p.kv_buffers * p.kv_round * 3 * 4);
  L.vecs = k;  k += p.kv_buffers * p.kv_round * kTK * 4;
  L.kv = k;    k += p.kv_buffers * p.kv_round * L.slot;
  L.kvc = k;   k += p.kv_round * L.cslot;
  L.ring = o;  o = imax(o + p.stages * p.stage_bytes, u);
  L.bars = o;  o += a16(8 * p.stages);
  L.flag = o;  o += 16 + 4 * kWarps;
  L.total = o;
  return L;
}

// The CTA's Q/K/V rows [a, e) of the head's NQ, cut at the wq | wk | wv
// edges into tiles of at most tr rows: their count, and tile i's first row
// and rows.
__device__ __forceinline__ int qkv_tiles(int a, int e, int RHd, int Hd, int tr) {
  const int edge[4] = {0, RHd, RHd + Hd, RHd + 2 * Hd};
  int n = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int lo = max(a, edge[s]), hi = min(e, edge[s + 1]);
    if (hi > lo) n += (hi - lo + tr - 1) / tr;
  }
  return n;
}
__device__ __forceinline__ void qkv_tile(int a, int e, int RHd, int Hd, int tr, int i,
                                         int& start, int& rows) {
  const int edge[4] = {0, RHd, RHd + Hd, RHd + 2 * Hd};
  start = a;
  rows = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int lo = max(a, edge[s]), hi = min(e, edge[s + 1]);
    if (hi <= lo) continue;
    const int n = (hi - lo + tr - 1) / tr;
    if (i < n) {
      start = lo + i * tr;
      rows = min(tr, hi - start);
      return;
    }
    i -= n;
  }
}

struct Params {
  const void* x;
  const void* norm_w;
  const float* cos;   // [B, Hd/2]
  const float* sin;
  const void* w[4];                 // wq, wk, wv, wo: dense, or q8_0 codes
  const __nv_bfloat16* s[4];        // their q8_0 scales
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
  unsigned* counter;  // [C], zero between launches
  int B, D, H, K, Hd, NT, bs;
  int rope_half;
  float eps, scale, softcap;
  int window;
  Plan plan;
};

// ---------------------------------------------------------------------------
// bf16 activations: the matvecs on the tensor cores (mma.sync m16n8k16, f32
// sums): M = 16 batch rows of the activations, N = 8 weight rows, K = 16
// columns. Lane l holds fragment group g = l / 4 and pair t = l % 4.

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A: activation rows b and b + 8 at columns (k, k + 1) and (k + 8, k + 9),
// act [B][stride] bf16; rows past B and columns past L are zero
__device__ __forceinline__ void a_frag(const __nv_bfloat16* act, int stride, int B, int L, int b,
                                       int k, uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                       uint32_t& a3) {
  const auto ld = [&](int row, int col) -> uint32_t {
    return row < B && col < L
               ? *reinterpret_cast<const uint32_t*>(act + size_t(row) * stride + col)
               : 0u;
  };
  a0 = ld(b, k);
  a1 = ld(b + 8, k);
  a2 = ld(b, k + 8);
  a3 = ld(b + 8, k + 8);
}

// two q8_0 codes times their bf16 scale, each rounded to bf16, as a pair
__device__ __forceinline__ uint32_t deq2(uint16_t c, float s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(float(int8_t(c & 0xff)) * s,
                                                 float(int8_t(c >> 8)) * s);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B: one weight row (shared or global memory: bf16, or q8_0 codes with
// the row's bf16 scales, one per 32 columns) at columns (k, k + 1) and
// (k + 8, k + 9); columns past L and rows not `ok` are zero
template <bool Q8>
__device__ __forceinline__ void b_frag(const uint8_t* row, const __nv_bfloat16* scales, int L,
                                       int k, bool ok, uint32_t& b0, uint32_t& b1) {
  b0 = b1 = 0u;
  if (!ok || k >= L) return;
  if constexpr (Q8) {
    const float s = __bfloat162float(scales[k / 32]);   // k..k+9 lie in one 32-block
    b0 = deq2(*reinterpret_cast<const uint16_t*>(row + k), s);
    if (k + 8 < L) b1 = deq2(*reinterpret_cast<const uint16_t*>(row + k + 8), s);
  } else {
    b0 = *reinterpret_cast<const uint32_t*>(row + 2 * k);
    if (k + 8 < L) b1 = *reinterpret_cast<const uint32_t*>(row + 2 * (k + 8));
  }
}

// ---------------------------------------------------------------------------
// f32 activations: FMA units of two weight rows by 256 columns

// One unit: rows r and r + 1 (when `two`) of w (row r at w + r * stride
// bytes, f32) at the lane's 8 columns c against batch rows [b0, b0 + kBT)
// of acts [B][as]; the 2 * kBT sums reduced across the warp (lane l holds
// value l / 4: row (l / 4) / kBT, batch row b0 + (l / 4) % kBT).
__device__ __forceinline__ void unit_sums(const uint8_t* w, int stride, int r, bool two, int c,
                                          const float* acts, int as, int L, int B, int b0,
                                          int lane, float (&acc)[2 * kBT]) {
#pragma unroll
  for (int e = 0; e < 2 * kBT; ++e) acc[e] = 0.f;
  if (c < L) {
    float w0[8], w1[8];
    load8(reinterpret_cast<const float*>(w + size_t(r) * stride) + c, w0);
    if (two) {
      load8(reinterpret_cast<const float*>(w + size_t(r + 1) * stride) + c, w1);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w1[j] = 0.f;
    }
#pragma unroll
    for (int bb = 0; bb < kBT; ++bb) {
      if (b0 + bb < B) {
        float a8[8];
        load8(acts + size_t(b0 + bb) * as + c, a8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[bb] = fmaf(a8[j], w0[j], acc[bb]);
          acc[kBT + bb] = fmaf(a8[j], w1[j], acc[kBT + bb]);
        }
      }
    }
  }
  warp_sums<2 * kBT>(acc, lane);
}

template <int HDM, typename CT, bool Q8, typename KT>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const __grid_constant__ Params p, const __grid_constant__ Layout L) {
  constexpr int DPL = HDM / 32;   // contiguous head dims a lane
  constexpr bool KV8 = sizeof(KT) == 1;
  constexpr bool MMA = std::is_same<CT, __nv_bfloat16>::value;   // bf16: tensor cores
  constexpr int WB = Q8 ? 1 : int(sizeof(CT));
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.plan.cluster;
  const int crank = int(cluster.block_rank());
  const int g = blockIdx.x / C;   // kv head
  const int B = p.B, D = p.D, K = p.K, Hd = p.Hd;
  const int R = p.H / K;
  const int RHd = R * Hd, NQ = RHd + 2 * Hd, HHd = p.H * Hd;
  const int hs = D + (MMA ? 8 : 0), as = RHd + (MMA ? 8 : 0);   // h's and the output's strides
  const int rs = D * WB + 16;           // a stage's row stride, bytes
  const int S = p.NT * p.bs;
  const int nst = p.plan.stages, RI = p.plan.kv_round, NB = p.plan.kv_buffers;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;   // a fragment's group and pair
  int* run_s = reinterpret_cast<int*>(smem + L.runs);       // [2][B] the CTA's key runs
  CT* h_s = reinterpret_cast<CT*>(smem + L.h);               // [B][hs]
  float* prod_s = reinterpret_cast<float*>(smem + L.prod);  // [B][NQ] raw q | k | v
  CT* qr_s = reinterpret_cast<CT*>(smem + L.qr);             // [B][R*Hd] roped q
  float* kd_s = reinterpret_cast<float*>(smem + L.kd);      // [B][Hd] the diagonal K
  float* vd_s = reinterpret_cast<float*>(smem + L.vd);      //          and V
  CT* at_s = reinterpret_cast<CT*>(smem + L.at);             // [B][as] attention out
  float* pm_s = reinterpret_cast<float*>(smem + L.pm);      // [B*R] the CTA's partials
  float* pl_s = reinterpret_cast<float*>(smem + L.pl);
  float* pacc_s = reinterpret_cast<float*>(smem + L.pacc);  // [B*R][Hd]
  int* item_s = reinterpret_cast<int*>(smem + L.items);     // [buffer][slot]: b, k0, keys
  int* vec_s = reinterpret_cast<int*>(smem + L.vecs);       // [buffer][slot][key]: pool row
  uint8_t* kv_s = smem + L.kv;
  uint8_t* ring = smem + L.ring;
  int* flag_s = reinterpret_cast<int*>(smem + L.flag);
  float* ss_s = reinterpret_cast<float*>(smem + L.flag + 16);   // [warp] RMSNorm partials
  const uint32_t full0 = smem_u32(smem + L.bars);   // a stage's tile landed
  const CT* x = static_cast<const CT*>(p.x);

  // the CTA's Q/K/V rows (the ring's tiles) and wo rows
  const int qa = min(NQ, crank * p.plan.qkv_rows), qe = min(NQ, qa + p.plan.qkv_rows);
  const int n0 = min(D, crank * p.plan.out_rows), n1 = min(D, n0 + p.plan.out_rows);
  const int nq = qkv_tiles(qa, qe, RHd, Hd, p.plan.qkv_tile);
  // tile i's first row, rows, projection (wq, wk, wv) and that projection's row
  const auto tile_of = [&](int i, int& a, int& n, int& m, int& row) {
    qkv_tile(qa, qe, RHd, Hd, p.plan.qkv_tile, i, a, n);
    m = a < RHd ? 0 : a < RHd + Hd ? 1 : 2;
    row = m == 0 ? g * RHd + a : g * Hd + a - RHd - (m == 2 ? Hd : 0);
  };
  // the byte address of the q8_0 scales of tile i's first row
  const auto scale_run = [&](int m, int row) {
    return reinterpret_cast<uintptr_t>(p.s[m]) + size_t(row) * (D / 16);
  };

  // tile i into stage i % nst (the lanes of warp 0): one bulk copy a row
  // (rows rs bytes apart in the stage), and a q8_0 tile's run of scales
  const auto issue = [&](int i) {
    uint8_t* stage = ring + size_t(i % nst) * p.plan.stage_bytes;
    const uint32_t full = full0 + 8 * (i % nst);
    int a, n, m, row;
    tile_of(i, a, n, m, row);
    int sb = 0;
    uintptr_t s0 = 0;
    if constexpr (Q8) sb = widened(scale_run(m, row), size_t(n) * (D / 16), s0);
    if (lane == 0) mbar_arrive_tx(full, n * D * WB + sb);
    __syncwarp();
    for (int r = lane; r < n; r += 32)
      bulk_load(smem_u32(stage + r * rs),
                static_cast<const uint8_t*>(p.w[m]) + size_t(row + r) * D * WB, D * WB, full);
    if (Q8 && lane == 0)
      bulk_load(smem_u32(stage + L.qkv_sc), reinterpret_cast<const void*>(s0), sb, full);
  };

  // 0. barriers and the first weight tiles (warp 0), the key runs
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < nst; ++s) mbar_init(full0 + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int i = 0; i < min(nst, nq); ++i) issue(i);
  }
  for (int b = tid - 32; b >= 0 && b < B; b += kThreads - 32) {   // warps 1..
    const int len = p.lengths[b];
    const int end = min(len, S);
    const int lo = p.window > 0 ? max(0, len - p.window + 1) : 0;
    const long long n = max(0, end - lo);
    run_s[b] = lo + int(n * crank / C);
    run_s[B + b] = lo + int(n * (crank + 1) / C);
  }
  // every CTA of the cluster has started once the matching wait returns
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();
  int n_items = 0, max_t = 0;
  for (int b = 0; b < B; ++b) {
    const int nt = (run_s[B + b] - run_s[b] + kTK - 1) / kTK;
    n_items += nt;
    max_t = max(max_t, nt);
  }
  const int rounds = (n_items + RI - 1) / RI;
  int ct = 0, cb = 0;   // (kFill) the next (tile, row) to hand out, tile-major
  const auto fill = [&](int buf) {
    for (int s = 0; s < RI; ++s) {
      int* it = item_s + (buf * RI + s) * 3;
      it[0] = -1;
      it[2] = 0;
      while (ct < max_t) {
        if (cb == B) {
          cb = 0;
          ++ct;
          continue;
        }
        const int b = cb++, k0 = run_s[b] + ct * kTK;
        if (k0 < run_s[B + b]) {
          it[0] = b;
          it[1] = k0;
          it[2] = min(kTK, run_s[B + b] - k0);
          break;
        }
      }
    }
  };
  // the pool rows of the keys of buffers [b0, b1) (every thread a key), read
  // from the block tables at once, not one dependent load before each copy
  const auto find_rows = [&](int b0, int b1) {
    for (int t = tid; t < (b1 - b0) * RI * kTK; t += kThreads) {
      const int sl = b0 * RI + t / kTK, key = t % kTK;
      const int* it = item_s + sl * 3;
      if (key < it[2]) {
        const int pos = it[1] + key;
        vec_s[sl * kTK + key] = __ldg(p.tables + size_t(it[0]) * p.NT + pos / p.bs) * p.bs +
                                pos % p.bs;
      }
    }
  };
  // the round in buffer buf: this thread's share of its copies, one group
  const auto load_round = [&](int buf) {
    constexpr int CP = KV8 ? 8 : 16;
    const int cpk = Hd * int(sizeof(KT)) / CP;   // copies a key vector
    for (int s = 0; s < RI; ++s) {
      const int sl = buf * RI + s, nk = item_s[sl * 3 + 2];
      uint8_t* slot = kv_s + size_t(sl) * L.slot;
      for (int e = tid; e < 2 * nk * cpk; e += kThreads) {
        const int which = e / (nk * cpk), rem = e % (nk * cpk), key = rem / cpk, c = rem % cpk;
        const size_t vec = size_t(vec_s[sl * kTK + key]) * K + g;
        cp_async<CP>(slot + (which ? L.slot_v : 0) + (key * Hd * int(sizeof(KT)) + c * CP),
                     static_cast<const uint8_t*>(which ? p.v_pool : p.k_pool) +
                         vec * Hd * sizeof(KT) + c * CP);
      }
      if constexpr (KV8) {
        for (int e = tid; e < 2 * nk; e += kThreads) {
          const int which = e / nk, key = e % nk;
          const size_t vec = size_t(vec_s[sl * kTK + key]) * K + g;
          cp_async<4>(slot + L.slot_s + which * kTK * 4 + key * 4,
                      (which ? p.v_scale : p.k_scale) + vec);
        }
      }
    }
    cp_commit();
  };

  // 1. RMSNorm: h = (x * rsqrt(mean(x^2) + eps)) * w, rounded; a row's
  // columns over wpr warps, 8 a lane, their sums of squares added in warp
  // order
  const CT* nw = static_cast<const CT*>(p.norm_w);
  const int wpr = B >= kWarps ? 1 : kWarps / B;   // warps a row
  for (int b0 = 0; b0 < B; b0 += kWarps / wpr) {
    const int b = b0 + warp / wpr, sl = warp % wpr;
    const CT* xr = x + size_t(b) * D;
    float ss = 0.f;
    if (b < B) {
      for (int c = (sl * 32 + lane) * 8; c < D; c += wpr * 256) {
        float v[8];
        load8(xr + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) ss_s[warp] = ss;
    __syncthreads();
    if (b < B) {
      float tot = 0.f;
      for (int w = warp - sl; w < warp - sl + wpr; ++w) tot += ss_s[w];
      const float inv = rsqrtf(tot / float(D) + p.eps);
      for (int c = (sl * 32 + lane) * 8; c < D; c += wpr * 256) {
        float v[8], w8[8];
        load8(xr + c, v);
        load8(nw + c, w8);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = v[j] * inv * w8[j];
        storen<8>(h_s + size_t(b) * hs + c, v);
      }
    }
    __syncthreads();
  }
  // the first rounds of key tiles: landing under the Q/K/V tiles, or once
  // RoPE is done where their arrays overlay the ring
  const auto first_rounds = [&] {
    if (tid == kFill) {
      for (int j = 0; j < NB; ++j) fill(j);
    }
    __syncthreads();
    find_rows(0, NB);
    __syncthreads();
    for (int j = 0; j < NB; ++j) load_round(j);
  };
  if (!p.plan.late_keys) first_rounds();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // 2. the CTA's Q, K and V rows against every batch row of h, tile by
  // tile. Each unit's sums go to the tile's sums [row][slice][b] (two
  // buffers, alternating). bf16: units of 8 rows (an n-block) by a slice of
  // the D/16 k-steps, 16 units a tile; f32: two rows by 256 columns. Once
  // every warp's units are done, warp 0 refills the stage and warps 1..15
  // add each row's slices in order (a thread an output) and send the
  // products to every CTA of the cluster, under the next tile's wait.
  const int nbk = (p.plan.qkv_tile + 7) / 8, ks_all = (D + 15) / 16;
  const int nsl = MMA ? (nbk >= kWarps ? 1 : kWarps / nbk) : chunks(D);   // slices a row
  const int ksl = (ks_all + nsl - 1) / nsl;
  const auto emit_sums = [&](int i) {   // warps 1..15: tile i's products, to every CTA
    int a, n, m, row;
    tile_of(i, a, n, m, row);
    const float* red = reinterpret_cast<const float*>(smem + L.red + (i & 1) * L.red_stage);
    for (int o = tid - 32; o < n * B; o += kThreads - 32) {
      const int rr = o / B, b = o % B;
      const float* rp = red + size_t(rr) * nsl * B + b;
      float sum = rp[0];
      for (int k = 1; k < nsl; ++k) sum += rp[size_t(k) * B];
      for (int c2 = 0; c2 < C; ++c2)
        cluster.map_shared_rank(prod_s, c2)[size_t(b) * NQ + a + rr] = sum;
    }
  };
  for (int i = 0; i < nq; ++i) {
    if (tid == 0) mbar_wait(full0 + 8 * (i % nst), (i / nst) & 1);
    __syncthreads();   // tile i landed; tile i - 1's sums are read
    const uint8_t* stage = ring + size_t(i % nst) * p.plan.stage_bytes;
    float* red = reinterpret_cast<float*>(smem + L.red + (i & 1) * L.red_stage);
    int a, n, m, row;
    tile_of(i, a, n, m, row);
    if constexpr (MMA) {
      const auto sc = reinterpret_cast<const __nv_bfloat16*>(stage + L.qkv_sc +
                                                             int(scale_run(m, row) & 15));
      for (int u = warp; u < nbk * nsl; u += kWarps) {
        const int nb = u / nsl, sl = u % nsl, r = nb * 8 + g8;
        const uint8_t* wrow = stage + size_t(r) * rs;
        const __nv_bfloat16* srow = Q8 ? sc + size_t(r) * (D / 32) : nullptr;
        const int s0 = sl * ksl, s1 = min(ks_all, s0 + ksl);
        for (int m0 = 0; m0 < B; m0 += 16) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int s = s0; s < s1; ++s) {
            const int k = 16 * s + 2 * t4;
            uint32_t a0, a1, a2, a3, b0, b1;
            a_frag(reinterpret_cast<const __nv_bfloat16*>(h_s), hs, B, D, m0 + g8, k, a0, a1,
                   a2, a3);
            b_frag<Q8>(wrow, srow, D, k, r < n, b0, b1);
            mma_bf16(c, a0, a1, a2, a3, b0, b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = nb * 8 + 2 * t4 + (e & 1), b = m0 + g8 + (e >> 1) * 8;
            if (rr < n && b < B) red[(size_t(rr) * nsl + sl) * B + b] = c[e];
          }
        }
      }
    } else {
      for (int u = warp; u < (n + 1) / 2 * nsl; u += kWarps) {
        const int r = u / nsl * 2, k = u % nsl;
        const bool two = r + 1 < n;
        for (int b0 = 0; b0 < B; b0 += kBT) {
          float acc[2 * kBT];
          unit_sums(stage, rs, r, two, k * 256 + lane * 8, reinterpret_cast<const float*>(h_s),
                    hs, D, B, b0, lane, acc);
          const int vi = lane / 4, j = vi / kBT, bb = vi % kBT;
          if (lane % 4 == 0 && (j == 0 || two) && b0 + bb < B)
            red[(size_t(r + j) * nsl + k) * B + b0 + bb] = acc[0];
        }
      }
    }
    __syncthreads();   // tile i's units are done: its stage is free, its sums whole
    if (warp == 0) {
      if (i + nst < nq) issue(i + nst);
    } else {
      emit_sums(i);
    }
  }
  cluster.sync();

  // 3. RoPE on the f32 products, q and k rounded; k_new / v_new out (rank 0)
  CT* k_new = static_cast<CT*>(p.k_new);
  CT* v_new = static_cast<CT*>(p.v_new);
  const int half = Hd / 2;
  for (int t = tid; t < B * (R + 1) * half; t += kThreads) {
    const int b = t / ((R + 1) * half), hr = t / half % (R + 1), i = t % half;
    const int i0 = p.rope_half ? i : 2 * i, i1 = p.rope_half ? i + half : 2 * i + 1;
    const float* src = prod_s + size_t(b) * NQ + (hr < R ? hr * Hd : RHd);
    const float c = p.cos[size_t(b) * half + i], s = p.sin[size_t(b) * half + i];
    // the projections rounded to the activation dtype first, as the unfused
    // step's proj outputs are (the TPU kernel ropes the f32 products; at
    // f32 the two are one); then products and sums rounded one at a time,
    // as the unfused rope computes them
    const float t0 = round_to<CT>(src[i0]), t1 = round_to<CT>(src[i1]);
    const float o0 = round_to<CT>(__fsub_rn(__fmul_rn(t0, c), __fmul_rn(t1, s)));
    const float o1 = round_to<CT>(__fadd_rn(__fmul_rn(t0, s), __fmul_rn(t1, c)));
    if (hr < R) {
      CT* q = qr_s + size_t(b) * RHd + hr * Hd;
      q[i0] = from_f<CT>(o0);
      q[i1] = from_f<CT>(o1);
    } else {
      kd_s[size_t(b) * Hd + i0] = o0;
      kd_s[size_t(b) * Hd + i1] = o1;
      if (crank == 0) {
        CT* kn = k_new + (size_t(b) * K + g) * Hd;
        kn[i0] = from_f<CT>(o0);
        kn[i1] = from_f<CT>(o1);
      }
    }
  }
  for (int t = tid; t < B * Hd; t += kThreads) {
    const int b = t / Hd, d = t % Hd;
    const float v = round_to<CT>(prod_s[size_t(b) * NQ + RHd + Hd + d]);
    vd_s[t] = v;
    if (crank == 0) v_new[(size_t(b) * K + g) * Hd + d] = from_f<CT>(v);
  }
  __syncthreads();   // the products are read: the partials may take their place
  for (int t = tid; t < B * R; t += kThreads) {
    pm_s[t] = kNegInf;
    pl_s[t] = 0.f;
  }
  for (int t = tid; t < B * R * Hd; t += kThreads) pacc_s[t] = 0.f;
  __syncthreads();
  if (p.plan.late_keys) first_rounds();
  if constexpr (KV8) {
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

  // 4. attention over the CTA's key runs: per (b, r) an online-softmax
  // partial, tile by tile
  const int nc8 = Hd / 8, d0 = lane * DPL;
  for (int j = 0; j < rounds; ++j) {
    const int buf = j % NB;
    if (NB == 2) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();
    if constexpr (KV8) {   // the round's codes dequantized once: code * scale, rounded
      for (int e = tid; e < RI * 2 * kTK * (Hd / 8); e += kThreads) {
        const int s = e / (2 * kTK * (Hd / 8)), rem = e % (2 * kTK * (Hd / 8));
        const int which = rem / (kTK * (Hd / 8)), key = rem / (Hd / 8) % kTK, d = rem % (Hd / 8) * 8;
        if (key >= item_s[(buf * RI + s) * 3 + 2]) continue;
        const uint8_t* slot = kv_s + size_t(buf * RI + s) * L.slot;
        const float sc = reinterpret_cast<const float*>(slot + L.slot_s)[which * kTK + key];
        float v[8];
        load8(reinterpret_cast<const int8_t*>(slot + (which ? L.slot_v : 0)) + key * Hd + d, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= sc;
        storen<8>(reinterpret_cast<CT*>(smem + L.kvc + s * L.cslot + (which ? L.cslot_v : 0)) +
                      key * Hd + d,
                  v);
      }
      __syncthreads();
    }
    for (int task = warp; task < B * R; task += kWarps) {
      const int b = task / R, r = task % R;
      const CT* qrow = qr_s + size_t(b) * RHd + r * Hd;
      float m = kNegInf, l = 0.f, acc[DPL];
      bool any = false;
      for (int s = 0; s < RI; ++s) {
        const int* it = item_s + (buf * RI + s) * 3;
        if (it[0] != b) continue;
        const int nk = it[2];
        if (!any) {
          m = pm_s[task];
          l = pl_s[task];
#pragma unroll
          for (int jd = 0; jd < DPL; ++jd) acc[jd] = d0 < Hd ? pacc_s[size_t(task) * Hd + d0 + jd] : 0.f;
          any = true;
        }
        // the key tile in the activation dtype (an int8 one as dequantized)
        const uint8_t* slot = KV8 ? smem + L.kvc + s * L.cslot
                                  : kv_s + size_t(buf * RI + s) * L.slot;
        const CT* ks = reinterpret_cast<const CT*>(slot);
        const CT* vs = reinterpret_cast<const CT*>(slot + (KV8 ? L.cslot_v : L.slot_v));
        const bool valid = lane < nk;
        float sc = 0.f;
        if (valid) {
          const CT* kr = ks + lane * Hd;
          int ch = lane % nc8;
          for (int jj = 0; jj < nc8; ++jj) {
            float k8[8], q8[8];
            load8(kr + ch * 8, k8);
            load8(qrow + ch * 8, q8);
#pragma unroll
            for (int e = 0; e < 8; ++e) sc = fmaf(q8[e], k8[e], sc);
            ch = ch + 1 == nc8 ? 0 : ch + 1;
          }
        }
        // online softmax; softcap before the mask, as the unfused path
        float xs = sc * p.scale;
        if (p.softcap > 0.f) xs = p.softcap * tanhf(xs / p.softcap);
        xs = valid ? xs : kNegInf;
        const float m_new = fmaxf(m, warp_max(xs));
        const float alpha = expf(m - m_new);
        const float pr = valid ? expf(xs - m_new) : 0.f;
        l = alpha * l + warp_sum(pr);
        m = m_new;
#pragma unroll
        for (int jd = 0; jd < DPL; ++jd) acc[jd] *= alpha;
        for (int key = 0; key < nk; ++key) {
          const float pk = __shfl_sync(0xffffffffu, pr, key);
          if (d0 < Hd) {
            float v[DPL];
            loadn<DPL>(vs + key * Hd + d0, v);
#pragma unroll
            for (int jd = 0; jd < DPL; ++jd) acc[jd] = fmaf(pk, v[jd], acc[jd]);
          }
        }
      }
      if (any) {
        if (lane == 0) {
          pm_s[task] = m;
          pl_s[task] = l;
        }
        if (d0 < Hd) {
#pragma unroll
          for (int jd = 0; jd < DPL; ++jd) pacc_s[size_t(task) * Hd + d0 + jd] = acc[jd];
        }
      }
    }
    __syncthreads();   // the buffer is free
    if (j + NB < rounds) {
      if (tid == kFill) fill(buf);
      __syncthreads();
      find_rows(buf, buf + 1);
      __syncthreads();
      load_round(buf);
    } else {
      cp_commit();   // an empty group keeps wait_group's count
    }
  }
  cluster.sync();

  // 5. each (b, r) merged over the cluster's partials in CTA order, then
  // the diagonal; the rounded output to every CTA
  for (int pr = crank + C * warp; pr < B * R; pr += C * kWarps) {
    const int b = pr / R, r = pr % R;
    float m = kNegInf;
    for (int c2 = 0; c2 < C; ++c2) m = fmaxf(m, *cluster.map_shared_rank(pm_s + pr, c2));
    float l = 0.f, acc[DPL];
#pragma unroll
    for (int jd = 0; jd < DPL; ++jd) acc[jd] = 0.f;
    for (int c2 = 0; c2 < C; ++c2) {
      const float f = expf(*cluster.map_shared_rank(pm_s + pr, c2) - m);
      l = fmaf(f, *cluster.map_shared_rank(pl_s + pr, c2), l);
      if (d0 < Hd) {
        float a[DPL];
        loadn<DPL>(cluster.map_shared_rank(pacc_s, c2) + size_t(pr) * Hd + d0, a);
#pragma unroll
        for (int jd = 0; jd < DPL; ++jd) acc[jd] = fmaf(f, a[jd], acc[jd]);
      }
    }
    const CT* qrow = qr_s + size_t(b) * RHd + r * Hd;
    const float* kd = kd_s + size_t(b) * Hd;
    const float* vd = vd_s + size_t(b) * Hd;
    float sd = 0.f;
    if (d0 < Hd) {
#pragma unroll
      for (int jd = 0; jd < DPL; ++jd) sd = fmaf(to_f(qrow[d0 + jd]), kd[d0 + jd], sd);
    }
    sd = warp_sum(sd) * p.scale;
    if (p.softcap > 0.f) sd = p.softcap * tanhf(sd / p.softcap);
    const float m_new = fmaxf(m, sd);
    const float alpha = expf(m - m_new), pd = expf(sd - m_new);
    const float inv = 1.f / (alpha * l + pd);
    if (d0 < Hd) {
      float o[DPL];
#pragma unroll
      for (int jd = 0; jd < DPL; ++jd) o[jd] = fmaf(alpha, acc[jd], pd * vd[d0 + jd]) * inv;
      for (int c2 = 0; c2 < C; ++c2)
        storen<DPL>(cluster.map_shared_rank(at_s, c2) + size_t(b) * as + r * Hd + d0, o);
    }
  }
  cluster.sync();   // no DSMEM access after this

  // 6. the CTA's slice of the O-projection over the head group's columns,
  // its weights loaded straight into the fragments (512-byte rows: too
  // short for bulk copies to keep pace): warp w takes the slice's 8-row n-blocks w, w + 16, ..., each
  // row's whole dot, into ws[g][b][row] (f32)
  float* wsg = p.ws + size_t(g) * B * D;
  const uint8_t* wo = static_cast<const uint8_t*>(p.w[3]);
  if constexpr (MMA) {
    const int ks_all = (RHd + 15) / 16;
    for (int nb = warp; nb * 8 < n1 - n0; nb += kWarps) {
      const int r = n0 + nb * 8 + g8;
      const uint8_t* wrow = wo + (size_t(r) * HHd + size_t(g) * RHd) * WB;
      const __nv_bfloat16* srow =
          Q8 ? p.s[3] + size_t(r) * (HHd / 32) + size_t(g) * (RHd / 32) : nullptr;
      for (int m0 = 0; m0 < B; m0 += 16) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s0 = 0; s0 < ks_all; s0 += 8) {
          uint32_t b0[8], b1[8];   // 8 k-steps of weights in flight
#pragma unroll
          for (int s = 0; s < 8; ++s)
            b_frag<Q8>(wrow, srow, RHd, 16 * (s0 + s) + 2 * t4, r < n1, b0[s], b1[s]);
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            uint32_t a0, a1, a2, a3;
            a_frag(reinterpret_cast<const __nv_bfloat16*>(at_s), as, B, RHd, m0 + g8,
                   16 * (s0 + s) + 2 * t4, a0, a1, a2, a3);
            mma_bf16(c, a0, a1, a2, a3, b0[s], b1[s]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = n0 + nb * 8 + 2 * t4 + (e & 1), b = m0 + g8 + (e >> 1) * 8;
          if (row < n1 && b < B) wsg[size_t(b) * D + row] = c[e];
        }
      }
    }
  } else {
    // two rows a unit, each lane 8 columns a step of 256
    const int nsl = chunks(RHd);
    for (int u = warp; 2 * u < n1 - n0; u += kWarps) {
      const int r = n0 + 2 * u;
      const bool two = r + 1 < n1;
      for (int b0 = 0; b0 < B; b0 += kBT) {
        float tot = 0.f;   // lane l: value l / 4 of each step's sums, steps in order
        for (int k = 0; k < nsl; ++k) {
          float acc[2 * kBT];
          unit_sums(wo + size_t(g) * RHd * WB, HHd * WB, r, two, k * 256 + lane * 8,
                    reinterpret_cast<const float*>(at_s), as, RHd, B, b0, lane, acc);
          tot = k == 0 ? acc[0] : tot + acc[0];
        }
        const int vi = lane / 4, j = vi / kBT, bb = vi % kBT;
        if (lane % 4 == 0 && (j == 0 || two) && b0 + bb < B)
          wsg[size_t(b0 + bb) * D + r + j] = tot;
      }
    }
  }

  // the last of the K CTAs of this slice sums the heads in order 0..K-1
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag_s = atomicAdd(p.counter + crank, 1u) == unsigned(K - 1);
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  CT* y = static_cast<CT*>(p.y);
  const int ns = n1 - n0;
  for (int o = tid; o < B * ns; o += kThreads) {
    const size_t i = size_t(o / ns) * D + n0 + o % ns;
    float sum = 0.f;
    for (int kh = 0; kh < K; ++kh) sum += __ldcg(p.ws + size_t(kh) * B * D + i);
    y[i] = from_f<CT>(to_f(x[i]) + round_to<CT>(sum));
  }
  if (tid == 0) p.counter[crank] = 0u;
}

// the launch, or with max_clusters the clusters the card can hold at once
template <int HDM, typename CT, bool Q8, typename KT>
cudaError_t launch(const Params& p, const Layout& L, cudaStream_t stream, int* max_clusters) {
  auto kernel = fused_decode_kernel<HDM, CT, Q8, KT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = unsigned(p.plan.cluster);
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(p.K * p.plan.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(L.total);
  cfg.stream = stream;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, L);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int HDM, typename CT, bool Q8>
cudaError_t dispatch_kv(const Params& p, const Layout& L, int kv_int8, cudaStream_t st,
                        int* mc) {
  return kv_int8 ? launch<HDM, CT, Q8, int8_t>(p, L, st, mc)
                 : launch<HDM, CT, Q8, CT>(p, L, st, mc);
}

template <int HDM>
cudaError_t dispatch_types(const Params& p, const Layout& L, int act_dtype, int w_q8,
                           int kv_int8, cudaStream_t st, int* mc) {
  if (act_dtype == 0) {
    if (w_q8) return cudaErrorInvalidValue;   // q8_0 weights serve bf16 only
    return dispatch_kv<HDM, float, false>(p, L, kv_int8, st, mc);
  }
  return w_q8 ? dispatch_kv<HDM, __nv_bfloat16, true>(p, L, kv_int8, st, mc)
              : dispatch_kv<HDM, __nv_bfloat16, false>(p, L, kv_int8, st, mc);
}

// the checks of both entries; the layout of a plan the kernel takes, else
// an error
inline cudaError_t checked_layout(int B, int D, int H, int K, int Hd, int act_dtype, int w_q8,
                                  int kv_int8, const Plan& pl, int smem, Layout& L) {
  if (B < 1 || Hd % 8 || Hd < 8 || Hd > 256 || D % 8 || K < 1 || H % K) return cudaErrorInvalidValue;
  const int R = H / K, RHd = R * Hd, NQ = RHd + 2 * Hd;
  if (w_q8 && (D % 32 || RHd % 32)) return cudaErrorInvalidValue;
  const int C = pl.cluster;
  if (C < 1 || C > kMaxCluster || pl.qkv_rows < 1 || pl.out_rows < 1 ||
      int64_t(pl.qkv_rows) * C < NQ || int64_t(pl.out_rows) * C < D || pl.qkv_tile < 1 ||
      pl.stages < 1 || pl.stages > kMaxStages || pl.stage_bytes % 16 ||
      pl.kv_round < 1 || pl.kv_round > kMaxRound || pl.kv_buffers < 1 || pl.kv_buffers > 2 ||
      pl.late_keys < 0 || pl.late_keys > 1)
    return cudaErrorInvalidValue;
  L = make_layout(B, D, R, Hd, act_dtype == 0 ? 4 : 2, w_q8 != 0, kv_int8 != 0, pl);
  if (pl.stage_bytes < L.qkv_need || L.total != smem ||
      L.total > kSmemLimit)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline cudaError_t dispatch(const Params& p, const Layout& L, int act_dtype, int w_q8,
                            int kv_int8, cudaStream_t st, int* mc) {
  if (p.Hd <= 64) return dispatch_types<64>(p, L, act_dtype, w_q8, kv_int8, st, mc);
  if (p.Hd <= 128) return dispatch_types<128>(p, L, act_dtype, w_q8, kv_int8, st, mc);
  return dispatch_types<256>(p, L, act_dtype, w_q8, kv_int8, st, mc);
}

}  // namespace dlp_fused

// act_dtype: 0 = float32, 1 = bfloat16 (x, norm_w, dense weights, outputs
// and a dense pool share it); w_q8: the four projections are q8_0 packs
// (bf16 only); kv_int8: int8 pools with f32 scales. counter: `cluster`
// device unsigneds that are 0 between launches (the kernel resets them);
// one stream at a time may use them. The plan (cluster .. late_keys) and
// its shared memory `smem` are ops/fused_decode.py `fused_plan`'s; the
// launch is refused unless smem is the kernel's layout of that plan.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_fused_decode(
    const void* x, const void* norm_w, const float* cos, const float* sin,
    const void* wq, const void* wq_s, const void* wk, const void* wk_s,
    const void* wv, const void* wv_s, const void* wo, const void* wo_s,
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* tables, const int* lengths, void* y,
    void* k_new, void* v_new, float* ws, unsigned* counter, int B, int D, int H,
    int K, int Hd, int NT, int bs, int act_dtype, int w_q8, int kv_int8,
    int rope_half, float eps, float scale, float softcap, int window,
    int cluster, int qkv_rows, int out_rows, int qkv_tile, int stages, int stage_bytes,
    int kv_round, int kv_buffers, int late_keys, int smem, void* stream) {
  using namespace dlp_fused;
  const Plan pl{cluster, qkv_rows, out_rows, qkv_tile, stages, stage_bytes, kv_round,
                kv_buffers, late_keys};
  Layout L;
  cudaError_t e = checked_layout(B, D, H, K, Hd, act_dtype, w_q8, kv_int8, pl, smem, L);
  if (e != cudaSuccess) return int(e);
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const Params p{x, norm_w, cos, sin, {wq, wk, wv, wo}, {bf(wq_s), bf(wk_s), bf(wv_s), bf(wo_s)},
                 k_pool, v_pool, k_scale, v_scale, tables, lengths, y, k_new, v_new, ws,
                 counter, B, D, H, K, Hd, NT, bs, rope_half, eps, scale, softcap, window, pl};
  return int(dispatch(p, L, act_dtype, w_q8, kv_int8, static_cast<cudaStream_t>(stream),
                      nullptr));
}

// cudaOccupancyMaxActiveClusters of the instantiation and plan a launch of
// these shapes would take, into *out; returns the cudaError_t
extern "C" int dlp_fused_decode_max_clusters(
    int B, int D, int H, int K, int Hd, int act_dtype, int w_q8, int kv_int8, int cluster,
    int qkv_rows, int out_rows, int qkv_tile, int stages, int stage_bytes, int kv_round,
    int kv_buffers, int late_keys, int smem, int* out) {
  using namespace dlp_fused;
  const Plan pl{cluster, qkv_rows, out_rows, qkv_tile, stages, stage_bytes, kv_round,
                kv_buffers, late_keys};
  Layout L;
  cudaError_t e = checked_layout(B, D, H, K, Hd, act_dtype, w_q8, kv_int8, pl, smem, L);
  if (e != cudaSuccess) return int(e);
  Params p = {};
  p.B = B; p.D = D; p.H = H; p.K = K; p.Hd = Hd;
  p.plan = pl;
  return int(dispatch(p, L, act_dtype, w_q8, kv_int8, nullptr, out));
}
