// Split-KV attention for Hopper (sm_90a): the one kernel template behind
// paged_attention.cu (K kv heads, n_rep = H / K), latent_attention.cu (one
// "kv head" of width r, n_rep = H) and flash_attention.cu (the dense cache).
//
// Contract: q [B,T,H,HD] attends the logical columns c of its batch row b;
// query t sees c iff c <= lens[b] + t and, when window > 0, lens[b] + t - c <
// window. Scores are scaled, soft-capped before the mask and soft-maxed in
// f32; the output [B,T,H,HD] has q's dtype. K/V are q's dtype, or int8 codes
// with one f32 scale per head vector, each value dequantized as
// (code * scale) and rounded to q's dtype before the dot. Where column c
// lives is the addressing policy, a template parameter:
// - PagedKV: physical block tables[b, c / bs] at offset c % bs of the pools
//   k, v [N,bs,K,HD] (scales [N,bs,K,1]).
// - DenseKV: k[b, c] of the cache k, v [B,S,K,HD] (scales [B,S,K,1]); no
//   table. Its "pages" are virtual runs of bs columns (NT = ceil(S / bs)),
//   so the host's split plan cuts the dense walk as it cuts a paged one, and
//   lens may be null, every row then at the scalar len0.
//
// Design (flash-decoding over pages):
// - GQA folds into query rows: the n_rep heads that share a kv head become
//   consecutive rows, row r at position lens[b] + r / n_rep.
// - The grid is (query tile, split, batch row x kv head). A split is a fixed
//   run of `pps` logical pages, chosen on the host from shapes alone
//   (ops/paged_attention.py split_plan). A paged block reads its pages'
//   table entries into shared memory once, then walks the columns the mask
//   needs inside its split in tiles of BC columns.
// - Tiles move into a ring of STAGES buffers with 16-byte cp.async, in their
//   stored type (bf16, f32, or int8 codes plus their f32 scales); tile i+1
//   (and i+2 where the ring has three stages) is in flight while tile i is
//   computed. Int8 tiles are dequantized into one q-typed tile after landing.
// - Each warp owns 16 query rows (one m16 tile) and a slice of DW output
//   dims; at head width 256 and 512 the DS = HD / 128 warps of a row tile
//   each compute the tile's scores (the same instructions on the same data,
//   so the same bits) and keep 128 output dims, which bounds the f32
//   accumulator at 64 registers a thread.
// - bf16: Q.K^T on tensor cores (mma.sync m16n8k16, bf16 in, f32 out).
//   P.V keeps P in f32 as the TPU kernels do: P is split into two bf16
//   terms, hi = bf16(P) and lo = bf16(P - hi), and both go through the
//   tensor cores against V (exact in bf16), so P is carried to about 16
//   bits of mantissa (relative error ~2^-17, far below the output's bf16
//   rounding). The dense policy splits P into three terms (hi, then mid and
//   lo of the exact residual: all of f32's 24 bits), one more MMA a tile:
//   it serves the one-stream path, whose output is held against the plain
//   f32 attention, and with two terms 0.1-0.24% of its outputs round the
//   other way from an f32 P.V, with three 0.02-0.16% (PERF.md). f32: the
//   same fragments computed with f32 FMA, no TF32.
// - A split writes its rows' running max m, sum l and unnormalised f32
//   accumulator to a workspace; a split with no visible column writes
//   m = -1e30, l = 0 and exits. combine_kernel merges the splits of each
//   row in split order (no atomics: the result is the same bits every run).
//   With one split the kernel writes the output itself.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlp_paged {
// Internal linkage: paged_attention.cu, latent_attention.cu and
// flash_attention.cu instantiate the same templates into three libraries
// that one process loads. With the default linkage GCC makes a template's
// function-local static (launch's `attr`) one process-wide symbol, so a
// second library would find it set and launch without raising its own
// kernel's shared-memory limit.
namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' masked-score fill

// The tiling of a head width, defined here only: the host's split plan reads
// it through each library's *_geometry entry (geometry below).
constexpr int kMaxWarps = 4;                                     // warps a block
__host__ __device__ constexpr int warp_dims(int hd) { return hd < 128 ? hd : 128; }
__host__ __device__ constexpr int tile_cols(int hd) { return hd <= 128 ? 32 : 16; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// compile-time geometry of one instantiation
template <int HD, typename QT, typename KT>
struct Geo {
  static constexpr bool BF16 = sizeof(QT) == 2;
  static constexpr bool Q8 = sizeof(KT) == 1;
  static constexpr int DW = warp_dims(HD);  // output dims per warp
  static constexpr int DS = HD / DW;        // warps per row tile
  static constexpr int BC = tile_cols(HD);  // columns per staged tile
  static constexpr int NB = BC / 8;               // n8 score tiles per tile
  static constexpr int KLD = HD * int(sizeof(KT)) + 16;  // stored row bytes (padded)
  static constexpr int QLD = HD * int(sizeof(QT)) + 16;  // q-typed row bytes (padded)
  static constexpr int STAGE = 2 * BC * KLD + (Q8 ? 2 * BC * 4 : 0);
  static constexpr int STAGES = STAGE <= 20 * 1024 ? 3 : 2;
  static constexpr int CONV = Q8 ? 2 * BC * QLD : 0;  // dequantized K and V tile

  static size_t smem_bytes(int mt, int pps) {
    return size_t(STAGES) * STAGE + CONV + size_t(16 * mt) * QLD +
           ((size_t(pps) * 4 + 15) / 16) * 16;
  }
};

// ---------------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------------------------------- fragment arithmetic
//
// Fragments follow mma.m16n8k16: lane = 4 g + tg holds, of a 16 x 8 f32
// tile, rows g (elements 0, 1) and g + 8 (2, 3) at columns 2 tg and 2 tg + 1.

// s[n] = Q[rows] . K[8n .. 8n+7]^T over all HD dims (bf16, tensor cores)
template <int HD, int NB>
__device__ __forceinline__ void scores_bf16(float (&s)[NB][4], const unsigned char* qs,
                                            int qld, const unsigned char* ks, int kld,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < HD; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, qs + (lane % 16) * qld + (k0 + (lane / 16) * 8) * 2);
#pragma unroll
    for (int n0 = 0; n0 < NB * 8; n0 += 16) {
      uint32_t b[4];
      ldsm_x4(b, ks + (n0 + (lane / 16) * 8 + lane % 8) * kld +
                     (k0 + ((lane / 8) & 1) * 8) * 2);
      mma_bf16(s[n0 / 8], a, b[0], b[1]);
      mma_bf16(s[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

// (x, y) -> three bf16 pairs, hi = bf16(x, y), mid = bf16 of the (exact)
// residual, lo = bf16 of what mid leaves: hi + mid + lo carries x and y to
// f32's 24 bits
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  split_bf16(rx, ry, mid, lo);
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

// acc[dn] += P . V[:, d0 + 8dn ..] with P = hi + lo (TERMS = 2) or hi + mid
// + lo (TERMS = 3), each term bf16 on the tensor cores
template <int DW, int NB, int TERMS>
__device__ __forceinline__ void pv_bf16(float (&acc)[DW / 8][4], const float (&p)[NB][4],
                                        const unsigned char* vs, int vld, int d0,
                                        int lane) {
  static_assert(TERMS == 2 || TERMS == 3, "P as two or three bf16 terms");
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t t[TERMS][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = p[2 * kk + i / 2][2 * (i % 2)], y = p[2 * kk + i / 2][2 * (i % 2) + 1];
      if constexpr (TERMS == 2) {
        split_bf16(x, y, t[0][i], t[1][i]);
      } else {
        split3_bf16(x, y, t[0][i], t[1][i], t[2][i]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < DW / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (16 * kk + ((lane / 8) & 1) * 8 + lane % 8) * vld +
                       (d0 + 8 * dn + (lane / 16) * 8) * 2);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) mma_bf16(acc[dn], t[j], b[0], b[1]);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) mma_bf16(acc[dn + 1], t[j], b[2], b[3]);
    }
  }
}

// the same fragments in f32 on the CUDA cores
template <int HD, int NB>
__device__ __forceinline__ void scores_f32(float (&s)[NB][4], const unsigned char* qs,
                                           int qld, const unsigned char* ks, int kld,
                                           int lane) {
  const int g = lane / 4, tg = lane % 4;
  const float4* q0 = reinterpret_cast<const float4*>(qs + g * qld);
  const float4* q1 = reinterpret_cast<const float4*>(qs + (g + 8) * qld);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float4* k0 = reinterpret_cast<const float4*>(ks + (8 * n + 2 * tg) * kld);
    const float4* k1 = reinterpret_cast<const float4*>(ks + (8 * n + 2 * tg + 1) * kld);
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD / 4; ++d) {
      const float4 x0 = q0[d], x1 = q1[d], y0 = k0[d], y1 = k1[d];
      a00 = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z, fmaf(x0.w, y0.w, a00))));
      a01 = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z, fmaf(x0.w, y1.w, a01))));
      a10 = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z, fmaf(x1.w, y0.w, a10))));
      a11 = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z, fmaf(x1.w, y1.w, a11))));
    }
    s[n][0] = a00;
    s[n][1] = a01;
    s[n][2] = a10;
    s[n][3] = a11;
  }
}

template <int DW, int NB>
__device__ __forceinline__ void pv_f32(float (&acc)[DW / 8][4], const float (&p)[NB][4],
                                       const unsigned char* vs, int vld, int d0, int lane) {
  const int tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    // the quad's probabilities of its two rows for keys 16 kk .. 16 kk + 15
    float pr[2][16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int src = (lane & ~3) | ((j & 7) >> 1);
      pr[0][j] = __shfl_sync(0xffffffffu, p[2 * kk + j / 8][j & 1], src);
      pr[1][j] = __shfl_sync(0xffffffffu, p[2 * kk + j / 8][2 + (j & 1)], src);
    }
#pragma unroll
    for (int dn = 0; dn < DW / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 8 * dn + 2 * tg + e;
        float x0 = acc[dn][e], x1 = acc[dn][2 + e];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float vv = reinterpret_cast<const float*>(vs + (16 * kk + j) * vld)[d];
          x0 = fmaf(pr[0][j], vv, x0);
          x1 = fmaf(pr[1][j], vv, x1);
        }
        acc[dn][e] = x0;
        acc[dn][2 + e] = x1;
      }
    }
  }
}

// 16 int8 codes (one 16-byte chunk) times their vector's scale, rounded to
// q's dtype and stored at dst (16-byte aligned)
__device__ __forceinline__ void dequant16(const int4 raw, float sc, float* dst) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 o;
    o.x = float(int8_t(w[i] & 0xff)) * sc;
    o.y = float(int8_t((w[i] >> 8) & 0xff)) * sc;
    o.z = float(int8_t((w[i] >> 16) & 0xff)) * sc;
    o.w = float(int8_t((w[i] >> 24) & 0xff)) * sc;
    reinterpret_cast<float4*>(dst)[i] = o;
  }
}

__device__ __forceinline__ void dequant16(const int4 raw, float sc, __nv_bfloat16* dst) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = w[i / 2] >> (16 * (i % 2));
    const __nv_bfloat162 h = __floats2bfloat162_rn(float(int8_t(x & 0xff)) * sc,
                                                   float(int8_t((x >> 8) & 0xff)) * sc);
    o[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// ------------------------------------------------------------------ kernels

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* tables;  // [B, NT]
  const int* lens;    // [B]
  void* out;          // [B, T, H, HD]
  float* ws_acc;      // [splits, B, T, H, HD] f32 (splits > 1)
  float* ws_ml;       // [splits, B, T, H, 2] f32 (splits > 1)
  int B, T, H, K, NT, bs, n_rep;
  int rpb;     // folded query rows per block
  int pps;     // logical pages per split
  int splits;  // ceil(NT / pps)
  float scale, softcap;
  int window;
  int S;       // DenseKV: the cache's columns (NT = ceil(S / bs))
  int len0;    // DenseKV: every row's length when lens is null
};

// The addressing policies: where column c of batch row b, kv head kvh lives,
// as the index of its head vector (K/V at vec * HD, scales at vec).
// kPvTerms: the bf16 terms P is split into for P.V (see pv_bf16).
struct PagedKV {
  static constexpr bool kTables = true;
  static constexpr int kPvTerms = 2;
};
struct DenseKV {
  static constexpr bool kTables = false;
  static constexpr int kPvTerms = 3;
};

// (no __launch_bounds__: with them ptxas held one instantiation at 128
// registers and spilled; blocks have at most 4 warps, so 255 registers fit)
template <int HD, typename QT, typename KT, class Addr>
__global__ void split_kernel(const Params p) {
  using G = Geo<HD, QT, KT>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* conv = ring + G::STAGES * G::STAGE;
  unsigned char* qs = conv + G::CONV;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / G::DS, d0 = (warp % G::DS) * G::DW;
  const int MT = nthr / (32 * G::DS);
  int* tbl_s = reinterpret_cast<int*>(qs + 16 * MT * G::QLD);

  const int b = blockIdx.z / p.K, kvh = blockIdx.z % p.K, split = blockIdx.y;
  const int Tq = p.T * p.n_rep;
  const int q0 = blockIdx.x * p.rpb;
  const int q_end = min(q0 + p.rpb, Tq);
  const int S = Addr::kTables ? p.NT * p.bs : p.S;
  const size_t R = size_t(p.B) * p.T * p.H;  // output rows

  // the split's table entries and the block's query rows (rows past q_end
  // are zeros) go out first; lens[b] is read while they are in flight
  const int p0 = split * p.pps, n_pages = min(p.NT - p0, p.pps);
  if constexpr (Addr::kTables) {
    for (int i = tid; i < n_pages; i += nthr)
      cp_async4(tbl_s + i, p.tables + size_t(b) * p.NT + p0 + i, 4);
  }
  {
    constexpr int CPR = HD * int(sizeof(QT)) / 16;
    const unsigned char* qg = static_cast<const unsigned char*>(p.q);
    for (int i = tid; i < 16 * MT * CPR; i += nthr) {
      const int rr = i / CPR, part = i % CPR, r = q0 + rr;
      const bool ok = r < q_end;
      size_t off = 0;
      if (ok) {
        const int t = r / p.n_rep, h = kvh * p.n_rep + r % p.n_rep;
        off = ((size_t(b) * p.T + t) * p.H + h) * HD * sizeof(QT) + part * 16;
      }
      cp_async16(qs + rr * G::QLD + part * 16, qg + off, ok ? 16 : 0);
    }
  }
  cp_async_commit();
  int cl;
  if constexpr (Addr::kTables) {
    cl = p.lens[b];
  } else {
    cl = p.lens ? p.lens[b] : p.len0;
  }

  // the columns this block needs: inside its split, from the first one in the
  // window of its first row to the last one its last row sees causally (a
  // parked row's position may pass S: the walk stops at S)
  const int kv_end = min(S, cl + (q_end - 1) / p.n_rep + 1);
  const int kv_begin = p.window > 0 ? max(0, cl + q0 / p.n_rep - p.window + 1) : 0;
  const int lo = max(kv_begin, p0 * p.bs);
  const int hi = min(kv_end, (p0 + n_pages) * p.bs);
  cp_async_wait<0>();

  if (lo >= hi) {
    // nothing visible here: an empty partial for each row, or, with one
    // split (a row that sees no column at all), a zero output
    for (int r = q0 + tid; r < q_end; r += nthr) {
      const size_t row = (size_t(b) * p.T + r / p.n_rep) * p.H + kvh * p.n_rep + r % p.n_rep;
      if (p.splits > 1) {
        p.ws_ml[(split * R + row) * 2] = kNegInf;
        p.ws_ml[(split * R + row) * 2 + 1] = 0.f;
      } else {
        for (int d = 0; d < HD; ++d) static_cast<QT*>(p.out)[row * HD + d] = from_f32<QT>(0.f);
      }
    }
    return;
  }
  __syncthreads();  // tbl_s and the query rows

  const bool pow2 = (p.bs & (p.bs - 1)) == 0;
  const int bs_shift = __ffs(p.bs) - 1;
  const unsigned char* kg = static_cast<const unsigned char*>(p.k);
  const unsigned char* vg = static_cast<const unsigned char*>(p.v);
  // the head vector of visible column c (lo <= c < hi)
  auto column_vec = [&](int c) -> size_t {
    if constexpr (Addr::kTables) {
      const int pg = pow2 ? c >> bs_shift : c / p.bs;
      return (size_t(tbl_s[pg - p0]) * p.bs + (c - pg * p.bs)) * p.K + kvh;
    } else {
      return (size_t(b) * p.S + c) * p.K + kvh;
    }
  };

  // stage tile `it` (columns lo + it BC ..) into ring buffer `slot`
  auto load_tile = [&](int it, int slot) {
    constexpr int CPC = HD * int(sizeof(KT)) / 16;  // 16-byte chunks per column
    unsigned char* kb = ring + slot * G::STAGE;
    unsigned char* vb = kb + G::BC * G::KLD;
    const int c0 = lo + it * G::BC;
    for (int i = tid; i < G::BC * CPC; i += nthr) {
      const int j = i / CPC, part = i % CPC, c = c0 + j;
      const bool ok = c < hi;
      const size_t off = ok ? column_vec(c) * HD * sizeof(KT) + part * 16 : 0;
      cp_async16(kb + j * G::KLD + part * 16, kg + off, ok ? 16 : 0);
      cp_async16(vb + j * G::KLD + part * 16, vg + off, ok ? 16 : 0);
    }
    if constexpr (G::Q8) {
      float* ksb = reinterpret_cast<float*>(vb + G::BC * G::KLD);
      for (int j = tid; j < G::BC; j += nthr) {
        const int c = c0 + j;
        const bool ok = c < hi;
        const size_t vec = ok ? column_vec(c) : 0;
        cp_async4(ksb + j, p.ks + vec, ok ? 4 : 0);
        cp_async4(ksb + G::BC + j, p.vs + vec, ok ? 4 : 0);
      }
    }
  };

  const int n_tiles = (hi - lo + G::BC - 1) / G::BC;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of its warp's tile); -1: padding
  const int g = lane / 4, tg = lane % 4;
  const int rbase = q0 + 16 * mt;
  const bool active = rbase < q_end;
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + g + 8 * i;
    pos[i] = r < q_end ? cl + r / p.n_rep : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[G::DW / 8][4];
#pragma unroll
  for (int dn = 0; dn < G::DW / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // tile it landed for every thread; tile it-1 is consumed
    if (it + G::STAGES - 1 < n_tiles) load_tile(it + G::STAGES - 1, (it + G::STAGES - 1) % G::STAGES);
    cp_async_commit();

    const unsigned char* kt = ring + (it % G::STAGES) * G::STAGE;
    const unsigned char* vt = kt + G::BC * G::KLD;
    int ld = G::KLD;
    if constexpr (G::Q8) {
      // dequantize: code * scale, rounded to q's dtype (kv_value's rule)
      const float* ksb = reinterpret_cast<const float*>(vt + G::BC * G::KLD);
      constexpr int CPC = HD / 16;
      for (int i = tid; i < 2 * G::BC * CPC; i += nthr) {
        const int side = i / (G::BC * CPC), j = (i / CPC) % G::BC, part = i % CPC;
        const int4 raw = *reinterpret_cast<const int4*>((side ? vt : kt) + j * G::KLD + part * 16);
        dequant16(raw, ksb[side * G::BC + j],
                  reinterpret_cast<QT*>(conv + (side * G::BC + j) * G::QLD) + part * 16);
      }
      __syncthreads();
      kt = conv;
      vt = conv + G::BC * G::QLD;
      ld = G::QLD;
    }
    if (!active) continue;

    float s[G::NB][4];
    const unsigned char* qw = qs + 16 * mt * G::QLD;
    if constexpr (G::BF16) {
      scores_bf16<HD, G::NB>(s, qw, G::QLD, kt, ld, lane);
    } else {
      scores_f32<HD, G::NB>(s, qw, G::QLD, kt, ld, lane);
    }

    // online softmax in f32; softcap applies before the mask, as on the TPU
    const int c0 = lo + it * G::BC;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < G::NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * n + 2 * tg + (e & 1), ps = pos[e / 2];
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool vis = c < hi && c <= ps && (p.window == 0 || ps - c < p.window);
        s[n][e] = vis ? x : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < G::NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is kNegInf; where the whole row is masked so far
        // m is kNegInf too and exp(0) = 1 must not count: test the score
        const float x = s[n][e];
        s[n][e] = x > 0.5f * kNegInf ? expf(x - m[e / 2]) : 0.f;
        l[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < G::DW / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    if constexpr (G::BF16) {
      pv_bf16<G::DW, G::NB, Addr::kPvTerms>(acc, s, vt, ld, d0, lane);
    } else {
      pv_f32<G::DW, G::NB>(acc, s, vt, ld, d0, lane);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + g + 8 * i;
    if (r >= q_end) continue;
    const size_t row = (size_t(b) * p.T + r / p.n_rep) * p.H + kvh * p.n_rep + r % p.n_rep;
    if (p.splits > 1) {
      float* w = p.ws_acc + (split * R + row) * HD + d0 + 2 * tg;
#pragma unroll
      for (int dn = 0; dn < G::DW / 8; ++dn)
        *reinterpret_cast<float2*>(w + 8 * dn) = make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]);
      if (d0 == 0 && tg == 0) {
        p.ws_ml[(split * R + row) * 2] = m[i];
        p.ws_ml[(split * R + row) * 2 + 1] = l[i];
      }
    } else {
      QT* o = static_cast<QT*>(p.out) + row * HD + d0 + 2 * tg;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int dn = 0; dn < G::DW / 8; ++dn) {
        o[8 * dn] = from_f32<QT>(acc[dn][2 * i] * inv);
        o[8 * dn + 1] = from_f32<QT>(acc[dn][2 * i + 1] * inv);
      }
    }
  }
}

// out[row] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits
// with l_s > 0, in split order. A row takes HD / 128 warps (one below 128
// dims), each lane up to 4 dims. Lane j reads the (m, l) of splits j, j + 32,
// ..; the accumulators of 16 consecutive splits are loaded before any is
// summed, so their latencies overlap, then summed in split order.
template <int HD>
struct Comb {
  static constexpr int DPW = HD < 128 ? HD : 128;  // dims per warp
  static constexpr int WPR = HD / DPW;             // warps per row
  static constexpr int ROWS = 4 / WPR;             // rows per 4-warp block
  static constexpr int V = DPW / 32;               // dims per lane
  static constexpr int CH = 16;                    // splits loaded at once
};

template <int HD, typename QT>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
               QT* __restrict__ out, int rows, int splits) {
  using C = Comb<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * C::ROWS + warp / C::WPR;
  if (row >= rows) return;
  const int d0 = (warp % C::WPR) * C::DPW + lane;
  float M = kNegInf;
  for (int s = lane; s < splits; s += 32) {
    const float2 ml = *reinterpret_cast<const float2*>(ws_ml + (size_t(s) * rows + row) * 2);
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f, acc[C::V];
#pragma unroll
  for (int v = 0; v < C::V; ++v) acc[v] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    // lane j: split s0 + j's weight e^(m - M) (0 when empty or past the end)
    float f = 0.f, lv = 0.f;
    if (s0 + lane < splits) {
      const float2 ml =
          *reinterpret_cast<const float2*>(ws_ml + (size_t(s0 + lane) * rows + row) * 2);
      if (ml.y > 0.f) {
        f = expf(ml.x - M);
        lv = ml.y;
      }
    }
    for (int c0 = 0; c0 < 32 && s0 + c0 < splits; c0 += C::CH) {
      float buf[C::CH][C::V];
#pragma unroll
      for (int k = 0; k < C::CH; ++k) {
        const bool live = __shfl_sync(0xffffffffu, f, c0 + k) != 0.f;
        const float* a = ws_acc + (size_t(s0 + c0 + k) * rows + row) * HD + d0;
#pragma unroll
        for (int v = 0; v < C::V; ++v) buf[k][v] = live ? a[32 * v] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < C::CH; ++k) {
        const float fk = __shfl_sync(0xffffffffu, f, c0 + k);
        L = fmaf(fk, __shfl_sync(0xffffffffu, lv, c0 + k), L);
#pragma unroll
        for (int v = 0; v < C::V; ++v) acc[v] = fmaf(fk, buf[k][v], acc[v]);
      }
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
  for (int v = 0; v < C::V; ++v)
    out[size_t(row) * HD + d0 + 32 * v] = from_f32<QT>(acc[v] * inv);
}

// -------------------------------------------------------------------- launch

template <int HD, typename QT, typename KT, class Addr>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using G = Geo<HD, QT, KT>;
  const int mt = (p.rpb + 15) / 16;
  if (p.rpb < 1 || mt * G::DS > kMaxWarps || p.pps < 1 || p.splits < 1 ||
      p.splits != (p.NT + p.pps - 1) / p.pps || (p.splits > 1 && !(p.ws_acc && p.ws_ml)))
    return cudaErrorInvalidValue;
  if (!Addr::kTables && (p.S < 1 || p.NT != (p.S + p.bs - 1) / p.bs))
    return cudaErrorInvalidValue;
  auto kernel = split_kernel<HD, QT, KT, Addr>;
  static cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  const int rows = p.T * p.n_rep;
  const dim3 grid((rows + p.rpb - 1) / p.rpb, p.splits, p.B * p.K);
  kernel<<<grid, 32 * mt * G::DS, G::smem_bytes(mt, Addr::kTables ? p.pps : 0), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int out_rows = p.B * p.T * p.H;
  combine_kernel<HD, QT><<<(out_rows + Comb<HD>::ROWS - 1) / Comb<HD>::ROWS, 128, 0, stream>>>(
      p.ws_acc, p.ws_ml, static_cast<QT*>(p.out), out_rows, p.splits);
  return cudaGetLastError();
}

// out = {columns per staged tile, warps sharing a 16-row query tile, warps a
// block may have} at head width hd: what ops/paged_attention.py's split plan
// cuts by
inline void geometry(int hd, int* out) {
  out[0] = tile_cols(hd);
  out[1] = hd / warp_dims(hd);
  out[2] = kMaxWarps;
}

// q_dtype: 0 = float32, 1 = bfloat16 (K/V share it unless kv_int8 = 1)
template <int HD, class Addr = PagedKV>
cudaError_t dispatch_dtype(int q_dtype, int kv_int8, const Params& p, cudaStream_t st) {
  if (q_dtype == 0)
    return kv_int8 ? launch<HD, float, int8_t, Addr>(p, st)
                   : launch<HD, float, float, Addr>(p, st);
  return kv_int8 ? launch<HD, __nv_bfloat16, int8_t, Addr>(p, st)
                 : launch<HD, __nv_bfloat16, __nv_bfloat16, Addr>(p, st);
}

}  // namespace
}  // namespace dlp_paged
