// Weight decoders of the W8A8 kernels (w8a8_matmul.cu; int8_matmul.cu takes
// quantize_group for its activations): the Q8_0, int8, Q6_K, Q4_K, Q5_KS, Q2_KS
// and Q3_KS packs and the byte-code Q4_K8, Q5_K and Q6_K8 packs of tp > 1
// meshes, of ops/quant_matmul.py and ops/kquant_matmul.py, laid out
// out-features-major, [F, .].
//
// A decoder of w8a8_kernel (int8, and the byte codes at a D the GEMV does
// not take) maps (output row f, logical contraction row d0, a multiple of
// 16) to the 16 int8 codes of rows d0 .. d0+15, written to w[0..3] as four
// 32-bit words of four bytes in row order (signed for Q8_0, int8 and
// Q6_K8, unsigned and below 128 for Q4_K8 and Q5_K, so all read as signed
// bytes), and to the scale those rows share (bf16, f32 for int8). The
// weight is code * scale, less the bf16 offset of the sub-block for an
// affine decoder (AFFINE, offset_at). Each kernel takes a decoder as a
// template argument, so one kernel body serves every format.
//
// Every decoder but int8's gives the span view of the persistent GEMV
// (w8a8_matmul.cu, gemv_kernel), which stages whole rows of the pack in
// shared memory and reads each packed byte once for all its bands. A span
// is 64 logical rows in BANDS sub-blocks ("bands") of 64 / BANDS rows, each
// CH 16-byte chunks of codes, so a row has D / 64 spans. Where the pack
// interleaves bands (Q6_K, Q4_K, Q5_KS, Q2_KS, Q3_KS), span s holds the
// packed positions [s * 64 / BANDS, (s + 1) * 64 / BANDS) of every band:
// band k is the sub-block from column k * D / BANDS + s * 64 / BANDS on (its
// scale and offset at index k * D / 64 + s). A byte-code pack (one plane)
// has no bands: span s is the columns [64 s, 64 s + 64), band k the
// sub-block from 64 s + k * SUB. `col` gives that column map. The decoder
// names its fields (FIELDS, field, field_bytes: the bytes one row of the
// pack holds in each, [F, .] each, so the fields of a run of rows are
// contiguous), loads span s of a staged row into registers once
// (span_bytes: every byte of the span, all bands), and decodes band k's
// codes from those registers (band_codes) and reads its scale and offset
// (band_scale). A lane takes the span's four chunks in the order j ^ h, h =
// order(lane): its band k is then the sub-block k ^ (h / CH), chunk c of it
// the codes of the x columns at 16 * (c ^ (h % CH)) from the sub-block's
// column, so that the 16-byte loads of a quarter warp fall in distinct
// banks (Q4_K's and Q5_KS's lanes 32 bytes apart swap their two chunks by
// one lane bit, the byte codes' lanes 64 bytes apart permute four by two;
// Q6_K's, Q2_KS's and Q3_KS's lanes 16 bytes apart keep their order).
// ROWS(MT) is the rows of a tile one lane takes at MT register rows of x:
// each load of x serves that many rows, as the registers allow
// (ops/quant_matmul.py `gemv_lane_rows` mirrors it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlp_quant {

// one int8 code per logical row [F, D] and one bf16 scale per SUB_ rows:
// Q8_0 (32) and the Q6_K8 byte codes (16)
template <int SUB_>
struct ByteCodes {
  static constexpr int SUB = SUB_;  // rows per scale
  static constexpr bool AFFINE = false;
  const int8_t* qs;
  const __nv_bfloat16* scale;
  int D;

  // w8a8_kernel's view (a D the GEMV does not take)
  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int4 v = *reinterpret_cast<const int4*>(qs + size_t(f) * D + d0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(scale[size_t(f) * (D / SUB) + d0 / SUB]);
  }

  // the span view: 64 contiguous codes, 64 / SUB sub-blocks
  static constexpr int BANDS = 64 / SUB, CH = SUB / 16;
  static constexpr int FIELDS = 2;  // qs, scale
  __host__ __device__ static constexpr int ROWS(int /*MT*/) { return 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D : D / SUB * 2;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(qs) : static_cast<const void*>(scale);
  }
  __device__ __forceinline__ static int col(int s, int k, int /*D*/) { return 64 * s + SUB * k; }
  // lanes 64 bytes apart: lane bits 1..2 order the four chunks
  __device__ __forceinline__ static int order(int lane) { return (lane >> 1) & 3; }
  struct Span {
    int4 v[4];  // v[j]: the span's chunk j ^ h
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int /*rows*/, int r, int D,
                                                    int s, int h) {
    const uint8_t* p = st + size_t(r) * D + 64 * s;
    Span sp;
#pragma unroll
    for (int j = 0; j < 4; ++j) sp.v[j] = *reinterpret_cast<const int4*>(p + 16 * (j ^ h));
    return sp;
  }
  // band k's SUB codes, chunk by chunk
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      w[4 * c] = sp.v[k * CH + c].x;
      w[4 * c + 1] = sp.v[k * CH + c].y;
      w[4 * c + 2] = sp.v[k * CH + c].z;
      w[4 * c + 3] = sp.v[k * CH + c].w;
    }
  }
  // the scales of a staged row r (and, past them, an affine pack's offsets)
  __device__ __forceinline__ static const __nv_bfloat16* staged_scale(const uint8_t* st, int rows,
                                                                      int r, int D) {
    return reinterpret_cast<const __nv_bfloat16*>(st + size_t(rows) * D) + size_t(r) * (D / SUB);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    sc = __bfloat162float(staged_scale(st, rows, r, D)[s * BANDS + k]);
    off = 0.f;
  }
};

using Q8_0 = ByteCodes<32>;
using Q6K8 = ByteCodes<16>;

// the affine byte codes, Q4_K8 and Q5_K: ByteCodes<32> with a bf16 offset
// per 32 rows
struct AffineBytes : ByteCodes<32> {
  static constexpr bool AFFINE = true;
  const __nv_bfloat16* b;

  __device__ __forceinline__ float offset_at(int f, int d0) const {
    return __bfloat162float(b[size_t(f) * (D / SUB) + d0 / SUB]);
  }

  static constexpr int FIELDS = 3;  // q, a, b (field_bytes: b's as a's)
  __host__ __device__ const void* field(int i) const {
    return i == 2 ? static_cast<const void*>(b) : ByteCodes<32>::field(i);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* ar = staged_scale(st, rows, r, D);
    sc = __bfloat162float(ar[s * BANDS + k]);
    off = __bfloat162float(ar[size_t(rows) * (D / SUB) + s * BANDS + k]);
  }
};

using Q4K8 = AffineBytes;
using Q5K = AffineBytes;

struct Int8 {
  static constexpr int SUB = 32;
  static constexpr bool AFFINE = false;
  const int8_t* qs;
  const float* gs;
  int D;
  int group;

  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int4 v = *reinterpret_cast<const int4*>(qs + size_t(f) * D + d0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return gs[size_t(f) * (D / group) + d0 / group];
  }
};

struct Q6K {
  static constexpr int SUB = 16;
  static constexpr bool AFFINE = false;
  const int8_t* ql;
  const int8_t* qh;
  const __nv_bfloat16* s;
  int D;

  // four codes of one word: the nibble at nsh of each byte of `lw` and the
  // two bits at hsh of each byte of `hw`, minus 32 bytewise
  __device__ __forceinline__ static int decode4(int lw, int hw, int nsh, int hsh) {
    const unsigned lo = (unsigned(lw) >> nsh) & 0x0F0F0F0Fu;
    const unsigned hi = ((unsigned(hw) >> hsh) & 0x03030303u) << 4;
    return int(__vsub4(lo | hi, 0x20202020u));
  }
  // the span view: 16 packed positions, one 16-row sub-block of each of the
  // four bands, from 16 bytes of ql at 16 s (bands 0 and 2, low and high
  // nibble), 16 at D / 4 + 16 s (bands 1 and 3) and 16 of qh (two bits a
  // band): each byte read once for all its bands
  static constexpr int BANDS = 4, CH = 1;
  static constexpr int FIELDS = 3;  // ql, qh, s
  __host__ __device__ static constexpr int ROWS(int /*MT*/) { return 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D / 2 : i == 1 ? D / 4 : D / 8;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(ql)
           : i == 1 ? static_cast<const void*>(qh)
                    : static_cast<const void*>(s);
  }
  __device__ __forceinline__ static int col(int s, int k, int D) { return k * (D / 4) + 16 * s; }
  __device__ __forceinline__ static int order(int /*lane*/) { return 0; }
  struct Span {
    int4 la, lb, hq;
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int rows, int r, int D,
                                                    int s, int /*h*/) {
    const uint8_t* l = st + size_t(r) * (D / 2) + 16 * s;
    return {*reinterpret_cast<const int4*>(l), *reinterpret_cast<const int4*>(l + D / 4),
            *reinterpret_cast<const int4*>(st + size_t(rows) * (D / 2) + size_t(r) * (D / 4) +
                                           16 * s)};
  }
  // band k's 16 codes
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
    const int4& l = k & 1 ? sp.lb : sp.la;
    const int nsh = (k >> 1) * 4, hsh = 2 * k;
    w[0] = decode4(l.x, sp.hq.x, nsh, hsh);
    w[1] = decode4(l.y, sp.hq.y, nsh, hsh);
    w[2] = decode4(l.z, sp.hq.z, nsh, hsh);
    w[3] = decode4(l.w, sp.hq.w, nsh, hsh);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(
                                  st + size_t(rows) * (D / 2 + D / 4)) + size_t(r) * (D / 16);
    sc = __bfloat162float(sr[k * (D / 64) + s]);
    off = 0.f;
  }
};

struct Q4K {
  static constexpr int SUB = 32;
  static constexpr bool AFFINE = true;
  const int8_t* qs;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int D;

  // the span view: 32 packed positions, one 32-row sub-block of each band
  // (the low and the high nibble), from 32 bytes of qs: Q5KS's layout
  // without its fifth-bit plane
  static constexpr int BANDS = 2, CH = 2;
  static constexpr int FIELDS = 3;  // qs, a, b
  __host__ __device__ static constexpr int ROWS(int /*MT*/) { return 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D / 2 : D / 16;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(qs)
           : i == 1 ? static_cast<const void*>(a)
                    : static_cast<const void*>(b);
  }
  __device__ __forceinline__ static int col(int s, int k, int D) { return k * (D / 2) + 32 * s; }
  // lanes 32 bytes apart: lane bit 2 orders the two chunks (as Q5KS)
  __device__ __forceinline__ static int order(int lane) { return (lane >> 2) & 1; }
  struct Span {
    int4 va, vb;  // the qs chunks at 16h and 16(1 - h)
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int /*rows*/, int r, int D,
                                                    int s, int h) {
    const uint8_t* n = st + size_t(r) * (D / 2) + 32 * s;
    return {*reinterpret_cast<const int4*>(n + 16 * h),
            *reinterpret_cast<const int4*>(n + 16 * (h ^ 1))};
  }
  // band k's 32 codes, chunk by chunk: the nibble at 4k of each byte
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
    const int sh = 4 * k;
    w[0] = int((unsigned(sp.va.x) >> sh) & 0x0F0F0F0Fu);
    w[1] = int((unsigned(sp.va.y) >> sh) & 0x0F0F0F0Fu);
    w[2] = int((unsigned(sp.va.z) >> sh) & 0x0F0F0F0Fu);
    w[3] = int((unsigned(sp.va.w) >> sh) & 0x0F0F0F0Fu);
    w[4] = int((unsigned(sp.vb.x) >> sh) & 0x0F0F0F0Fu);
    w[5] = int((unsigned(sp.vb.y) >> sh) & 0x0F0F0F0Fu);
    w[6] = int((unsigned(sp.vb.z) >> sh) & 0x0F0F0F0Fu);
    w[7] = int((unsigned(sp.vb.w) >> sh) & 0x0F0F0F0Fu);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* ar =
        reinterpret_cast<const __nv_bfloat16*>(st + size_t(rows) * (D / 2)) + size_t(r) * (D / 32);
    sc = __bfloat162float(ar[k * (D / 64) + s]);
    off = __bfloat162float(ar[size_t(rows) * (D / 32) + k * (D / 64) + s]);
  }
};

struct Q5KS {
  static constexpr int SUB = 32;
  static constexpr bool AFFINE = true;
  const int8_t* q5n;
  const int8_t* q5h;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int D;

  // bit i (0..3) of `bits` to bit 4 of byte i: the product places copies of
  // the four bits 7 apart, so bit i of the copy shifted by 7i lands at 8i,
  // with no carries (the copies do not overlap); the mask keeps those four
  __device__ __forceinline__ static unsigned fifth_bits(unsigned bits) {
    return ((bits * 0x00204081u) & 0x01010101u) << 4;
  }
  // the span view: 32 packed positions, one 32-row sub-block of each band,
  // from 32 bytes of q5n and 8 of q5h
  static constexpr int BANDS = 2, CH = 2;
  static constexpr int FIELDS = 4;  // q5n, q5h, a, b
  __host__ __device__ static constexpr int ROWS(int /*MT*/) { return 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D / 2 : i == 1 ? D / 8 : D / 16;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(q5n)
           : i == 1 ? static_cast<const void*>(q5h)
           : i == 2 ? static_cast<const void*>(a)
                    : static_cast<const void*>(b);
  }
  __device__ __forceinline__ static int col(int s, int k, int D) { return k * (D / 2) + 32 * s; }
  // lanes 32 bytes apart: lane bit 2 orders the two chunks
  __device__ __forceinline__ static int order(int lane) { return (lane >> 2) & 1; }
  // a span's bytes: the q5n chunks at 16h (va) and 16(1 - h) (vb), the four
  // q5h bytes of each (ha, hb; byte i holds positions 4i .. 4i + 3, band 0
  // in bits 0..3, band 1 in bits 4..7)
  struct Span {
    int4 va, vb;
    unsigned ha, hb;
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int rows, int r, int D,
                                                    int s, int h) {
    const uint8_t* n = st + size_t(r) * (D / 2) + 32 * s;
    const uint2 hw =
        *reinterpret_cast<const uint2*>(st + size_t(rows) * (D / 2) + size_t(r) * (D / 8) + 8 * s);
    return {*reinterpret_cast<const int4*>(n + 16 * h),
            *reinterpret_cast<const int4*>(n + 16 * (h ^ 1)), h ? hw.y : hw.x, h ? hw.x : hw.y};
  }
  __device__ __forceinline__ static int code4(int v, unsigned hb, int i, int k) {
    return int(((unsigned(v) >> (4 * k)) & 0x0F0F0F0Fu) | fifth_bits((hb >> (8 * i + 4 * k)) & 0xFu));
  }
  // band k's 32 codes, chunk by chunk: w[0..3] from va, w[4..7] from vb
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
    w[0] = code4(sp.va.x, sp.ha, 0, k);
    w[1] = code4(sp.va.y, sp.ha, 1, k);
    w[2] = code4(sp.va.z, sp.ha, 2, k);
    w[3] = code4(sp.va.w, sp.ha, 3, k);
    w[4] = code4(sp.vb.x, sp.hb, 0, k);
    w[5] = code4(sp.vb.y, sp.hb, 1, k);
    w[6] = code4(sp.vb.z, sp.hb, 2, k);
    w[7] = code4(sp.vb.w, sp.hb, 3, k);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* ar = reinterpret_cast<const __nv_bfloat16*>(
                                  st + size_t(rows) * (D / 2 + D / 8)) + size_t(r) * (D / 32);
    sc = __bfloat162float(ar[k * (D / 64) + s]);
    off = __bfloat162float(ar[size_t(rows) * (D / 32) + k * (D / 64) + s]);
  }
};

struct Q2KS {
  static constexpr int SUB = 16;
  static constexpr bool AFFINE = true;
  const int8_t* q2l;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int D;

  // the span view: 16 packed positions, one 16-row sub-block of each of the
  // four bands, from 16 bytes of q2l
  static constexpr int BANDS = 4, CH = 1;
  static constexpr int FIELDS = 3;  // q2l, a, b
  __host__ __device__ static constexpr int ROWS(int MT) { return MT <= 8 ? 4 : 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D / 4 : D / 8;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(q2l)
           : i == 1 ? static_cast<const void*>(a)
                    : static_cast<const void*>(b);
  }
  __device__ __forceinline__ static int col(int s, int k, int D) { return k * (D / 4) + 16 * s; }
  __device__ __forceinline__ static int order(int /*lane*/) { return 0; }
  struct Span {
    int4 v;  // rows r .. r + 15 of every band
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int /*rows*/, int r, int D,
                                                    int s, int /*h*/) {
    return {*reinterpret_cast<const int4*>(st + size_t(r) * (D / 4) + 16 * s)};
  }
  // band k's 16 codes: bits 2k..2k+1 of each byte
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
    w[0] = int((unsigned(sp.v.x) >> (2 * k)) & 0x03030303u);
    w[1] = int((unsigned(sp.v.y) >> (2 * k)) & 0x03030303u);
    w[2] = int((unsigned(sp.v.z) >> (2 * k)) & 0x03030303u);
    w[3] = int((unsigned(sp.v.w) >> (2 * k)) & 0x03030303u);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* ar = reinterpret_cast<const __nv_bfloat16*>(
                                  st + size_t(rows) * (D / 4)) + size_t(r) * (D / 16);
    sc = __bfloat162float(ar[k * (D / 64) + s]);
    off = __bfloat162float(ar[size_t(rows) * (D / 16) + k * (D / 64) + s]);
  }
};

struct Q3KS {
  static constexpr int SUB = 16;
  static constexpr bool AFFINE = false;
  const int8_t* q3l;
  const int8_t* q3h;
  const __nv_bfloat16* s;
  int D;

  // four codes of one word: the two bits at sh of each byte of `lw`, the
  // third bits of the same four rows from two bytes of the bit plane (`hw`
  // holds them in its low 16 bits: rows 4i, 4i+1 in bits sh, sh+1 of its
  // low byte, rows 4i+2, 4i+3 in its high byte), minus 4 bytewise
  __device__ __forceinline__ static int decode4(unsigned lw, unsigned hw, int sh) {
    const unsigned lo = (lw >> sh) & 0x03030303u;
    const unsigned bits = ((hw >> sh) & 3u) | (((hw >> (8 + sh)) & 3u) << 2);
    // bit i (0..3) of `bits` to bit 2 of byte i (see Q5KS::fifth_bits)
    const unsigned hi = ((bits * 0x00204081u) & 0x01010101u) << 2;
    return int(__vsub4(lo | hi, 0x04040404u));
  }
  // the span view: 16 packed positions, one 16-row sub-block of each of the
  // four bands, from 16 bytes of q3l (Q2KS's plane) and the 8 bytes of q3h
  // that hold their third bits: each byte read once for all its bands
  static constexpr int BANDS = 4, CH = 1;
  static constexpr int FIELDS = 3;  // q3l, q3h, s
  __host__ __device__ static constexpr int ROWS(int MT) { return MT <= 8 ? 4 : 2; }
  __host__ __device__ static constexpr int field_bytes(int i, int D) {
    return i == 0 ? D / 4 : D / 8;
  }
  __host__ __device__ const void* field(int i) const {
    return i == 0 ? static_cast<const void*>(q3l)
           : i == 1 ? static_cast<const void*>(q3h)
                    : static_cast<const void*>(s);
  }
  __device__ __forceinline__ static int col(int s, int k, int D) { return k * (D / 4) + 16 * s; }
  __device__ __forceinline__ static int order(int /*lane*/) { return 0; }
  struct Span {
    int4 l;   // rows r .. r + 15 of every band, two bits each
    uint2 h;  // their third bits: two rows of every band a byte
  };
  __device__ __forceinline__ static Span span_bytes(const uint8_t* st, int rows, int r, int D,
                                                    int s, int /*h*/) {
    return {*reinterpret_cast<const int4*>(st + size_t(r) * (D / 4) + 16 * s),
            *reinterpret_cast<const uint2*>(st + size_t(rows) * (D / 4) + size_t(r) * (D / 8) +
                                            8 * s)};
  }
  // band k's 16 codes: word i's third bits are q3h bytes 2i and 2i + 1
  __device__ __forceinline__ static void band_codes(const Span& sp, int k, int* w) {
    w[0] = decode4(unsigned(sp.l.x), sp.h.x, 2 * k);
    w[1] = decode4(unsigned(sp.l.y), sp.h.x >> 16, 2 * k);
    w[2] = decode4(unsigned(sp.l.z), sp.h.y, 2 * k);
    w[3] = decode4(unsigned(sp.l.w), sp.h.y >> 16, 2 * k);
  }
  __device__ __forceinline__ static void band_scale(const uint8_t* st, int rows, int r, int D,
                                                    int s, int k, float& sc, float& off) {
    const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(
                                  st + size_t(rows) * (D / 4 + D / 8)) + size_t(r) * (D / 16);
    sc = __bfloat162float(sr[k * (D / 64) + s]);
    off = 0.f;
  }
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One warp quantizes the `group` (<= 256) values of x from element `base`
// as the reference's quantize_acts does: xs = amax * f32(1/127), inv = xs >
// 0 ? 1 / max(xs, 1e-30) : 0, code = clamp(rint(x * inv), -127, 127) into
// xq[0 .. group). A lane loads its (at most 8) values once, all before their
// use. Returns xs (every lane).
__device__ __forceinline__ float quantize_group(const void* __restrict__ x, bool x_bf16,
                                                size_t base, int group, int8_t* xq) {
  const int lane = threadIdx.x % 32;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < group ? load_f32(x, base + i, x_bf16) : 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_max(amax);
  const float xs = amax * (1.0f / 127.0f);
  const float inv = xs > 0.f ? 1.0f / fmaxf(xs, 1e-30f) : 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    if (i < group) xq[i] = int8_t(fminf(fmaxf(rintf(v[k] * inv), -127.f), 127.f));
  }
  return xs;
}

__device__ __forceinline__ void store_f32(void* p, size_t i, float v, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

}  // namespace dlp_quant
