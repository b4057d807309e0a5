// Weight decoders shared by the quantized matmul kernels (dequant_matmul.cu,
// w8a8_matmul.cu): the Q8_0 and Q6_K packs of ops/quant_matmul.py and
// ops/kquant_matmul.py, laid out out-features-major, [F, .].
//
// A decoder maps (output row f, logical contraction row d0, a multiple of 16)
// to the 16 signed int8 codes of rows d0 .. d0+15, written to w[0..3] as
// four 32-bit words of four bytes in row order, and to the bf16 scale those
// rows share; the weight is code * scale. Each kernel takes a decoder as a template argument, so one
// kernel body serves both formats.
//
//   Q8_0  qs int8 [F, D], scale bf16 [F, D/32]        (sub-block 32)
//   Q6_K  ql int8 [F, D/2], qh int8 [F, D/4], s bf16 [F, D/16]   (sub-block 16)
//         row d of band k = d / (D/4): low 4 bits from the nibble k >> 1 of
//         ql[d % (D/2)], top 2 bits from bits 2k..2k+1 of qh[d % (D/4)],
//         code = bits - 32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlp_quant {

struct Q8_0 {
  static constexpr int SUB = 32;  // rows per scale
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

struct Q6K {
  static constexpr int SUB = 16;
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

// byte i (0..3) of a code word as a signed value
__device__ __forceinline__ int code_byte(int w, int i) {
  return int(int8_t(unsigned(w) >> (8 * i)));
}

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
