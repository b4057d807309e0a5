// Weight decoders of the W8A8 kernels (w8a8_matmul.cu; int8_matmul.cu takes
// load_f32 for its activations): the Q8_0, int8, Q6_K, Q4_K, Q5_KS, Q2_KS
// and Q3_KS packs and the byte-code Q4_K8, Q5_K and Q6_K8 packs of tp > 1
// meshes, of ops/quant_matmul.py and ops/kquant_matmul.py, laid out
// out-features-major, [F, .].
//
// A decoder maps (output row f, logical contraction row d0, a multiple of 16)
// to the 16 int8 codes of rows d0 .. d0+15, written to w[0..3] as four 32-bit
// words of four bytes in row order (signed for Q8_0, int8, Q6_K and Q3_KS,
// unsigned and below 128 for Q4_K, Q5_KS and Q2_KS, so all read as signed
// bytes), and to the scale those rows share (bf16, f32 for int8). The weight
// is code * scale, less the bf16 offset of the sub-block for an affine
// decoder (AFFINE, offset_at). Each kernel takes a decoder as a template
// argument, so one kernel body serves every format.
//
//   Q8_0  qs int8 [F, D], scale bf16 [F, D/32]        (sub-block 32)
//   Q6_K8 q6 int8 [F, D] in [-32, 31], s bf16 [F, D/16] (sub-block 16)
//   Q4_K8 q4 int8 [F, D] in [0, 15], a, b bf16 [F, D/32] (sub-block 32)
//   Q5_K  q5 int8 [F, D] in [0, 31], a, b bf16 [F, D/32] (sub-block 32)
//         (the byte codes: one code per logical row, weight a * code - b)
//   int8  qs int8 [F, D], gs f32 [F, D/g]             (sub-block 32; the scale
//         of rows d is gs[f, d / g], g = 256, 128, 64 or 32)
//   Q6_K  ql int8 [F, D/2], qh int8 [F, D/4], s bf16 [F, D/16]   (sub-block 16)
//         row d of band k = d / (D/4): low 4 bits from the nibble k >> 1 of
//         ql[d % (D/2)], top 2 bits from bits 2k..2k+1 of qh[d % (D/4)],
//         code = bits - 32.
//   Q4_K  qs int8 [F, D/2], a bf16 [F, D/32], b bf16 [F, D/32]   (sub-block 32)
//         row d of band k = d / (D/2): the nibble 4k of qs[d % (D/2)],
//         code in [0, 15], weight a * code - b.
//   Q5_KS q5n int8 [F, D/2], q5h int8 [F, D/8], a, b as Q4_K     (sub-block 32)
//         low 4 bits as Q4_K from q5n; the fifth bit is bit 4k + d % 4 of
//         q5h[(d % (D/2)) / 4]; code in [0, 31], weight a * code - b.
//   Q2_KS q2l int8 [F, D/4], a bf16 [F, D/16], b bf16 [F, D/16] (sub-block 16)
//         row d of band k = d / (D/4): bits 2k..2k+1 of q2l[d % (D/4)],
//         code in [0, 3], weight a * code - b.
//   Q3_KS q3l int8 [F, D/4], q3h int8 [F, D/8], s bf16 [F, D/16] (sub-block 16)
//         low 2 bits as Q2_KS from q3l; the third bit of row r = d % (D/4)
//         is bit 2k + r % 2 of q3h[r / 2]; code = bits - 4 in [-4, 3].

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
  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int D4 = D / 4, band = d0 / D4;
    const int4 l = *reinterpret_cast<const int4*>(ql + size_t(f) * (D / 2) + d0 % (D / 2));
    const int4 h = *reinterpret_cast<const int4*>(qh + size_t(f) * D4 + d0 % D4);
    const int nsh = (band >> 1) * 4, hsh = 2 * band;
    w[0] = decode4(l.x, h.x, nsh, hsh);
    w[1] = decode4(l.y, h.y, nsh, hsh);
    w[2] = decode4(l.z, h.z, nsh, hsh);
    w[3] = decode4(l.w, h.w, nsh, hsh);
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(s[size_t(f) * (D / SUB) + d0 / SUB]);
  }
};

struct Q4K {
  static constexpr int SUB = 32;
  static constexpr bool AFFINE = true;
  const int8_t* qs;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int D;

  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int D2 = D / 2, sh = (d0 / D2) * 4;
    const int4 v = *reinterpret_cast<const int4*>(qs + size_t(f) * D2 + d0 % D2);
    w[0] = int((unsigned(v.x) >> sh) & 0x0F0F0F0Fu);
    w[1] = int((unsigned(v.y) >> sh) & 0x0F0F0F0Fu);
    w[2] = int((unsigned(v.z) >> sh) & 0x0F0F0F0Fu);
    w[3] = int((unsigned(v.w) >> sh) & 0x0F0F0F0Fu);
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(a[size_t(f) * (D / SUB) + d0 / SUB]);
  }
  __device__ __forceinline__ float offset_at(int f, int d0) const {
    return __bfloat162float(b[size_t(f) * (D / SUB) + d0 / SUB]);
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
  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int D2 = D / 2, r = d0 % D2, sh = (d0 / D2) * 4;
    const int4 v = *reinterpret_cast<const int4*>(q5n + size_t(f) * D2 + r);
    // bytes r/4 .. r/4 + 3 of the bit plane: byte k holds rows r + 4k ..
    const unsigned h = *reinterpret_cast<const unsigned*>(q5h + size_t(f) * (D / 8) + r / 4);
    w[0] = int(((unsigned(v.x) >> sh) & 0x0F0F0F0Fu) | fifth_bits((h >> sh) & 0xFu));
    w[1] = int(((unsigned(v.y) >> sh) & 0x0F0F0F0Fu) | fifth_bits((h >> (8 + sh)) & 0xFu));
    w[2] = int(((unsigned(v.z) >> sh) & 0x0F0F0F0Fu) | fifth_bits((h >> (16 + sh)) & 0xFu));
    w[3] = int(((unsigned(v.w) >> sh) & 0x0F0F0F0Fu) | fifth_bits((h >> (24 + sh)) & 0xFu));
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(a[size_t(f) * (D / SUB) + d0 / SUB]);
  }
  __device__ __forceinline__ float offset_at(int f, int d0) const {
    return __bfloat162float(b[size_t(f) * (D / SUB) + d0 / SUB]);
  }
};

struct Q2KS {
  static constexpr int SUB = 16;
  static constexpr bool AFFINE = true;
  const int8_t* q2l;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int D;

  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int D4 = D / 4, sh = 2 * (d0 / D4);
    const int4 v = *reinterpret_cast<const int4*>(q2l + size_t(f) * D4 + d0 % D4);
    w[0] = int((unsigned(v.x) >> sh) & 0x03030303u);
    w[1] = int((unsigned(v.y) >> sh) & 0x03030303u);
    w[2] = int((unsigned(v.z) >> sh) & 0x03030303u);
    w[3] = int((unsigned(v.w) >> sh) & 0x03030303u);
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(a[size_t(f) * (D / SUB) + d0 / SUB]);
  }
  __device__ __forceinline__ float offset_at(int f, int d0) const {
    return __bfloat162float(b[size_t(f) * (D / SUB) + d0 / SUB]);
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
  __device__ __forceinline__ void codes16(int f, int d0, int* w) const {
    const int D4 = D / 4, r = d0 % D4, sh = 2 * (d0 / D4);
    const int4 l = *reinterpret_cast<const int4*>(q3l + size_t(f) * D4 + r);
    // bytes r/2 .. r/2 + 7 of the bit plane: rows r .. r + 15 of the band
    const uint2 h = *reinterpret_cast<const uint2*>(q3h + size_t(f) * (D / 8) + r / 2);
    w[0] = decode4(unsigned(l.x), h.x, sh);
    w[1] = decode4(unsigned(l.y), h.x >> 16, sh);
    w[2] = decode4(unsigned(l.z), h.y, sh);
    w[3] = decode4(unsigned(l.w), h.y >> 16, sh);
  }
  __device__ __forceinline__ float scale_at(int f, int d0) const {
    return __bfloat162float(s[size_t(f) * (D / SUB) + d0 / SUB]);
  }
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f32(void* p, size_t i, float v, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

}  // namespace dlp_quant
