// Fused-dequant matmul of bf16 activations against a Q8_0, Q6_K, Q4_K or
// Q5_K (byte-code) pack, for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels `q8_0_matmul_pallas` (distributed_llm_pipeline_
// tpu/ops/quant_matmul.py, `_q8_kernel`), `q6_k_matmul_pallas`,
// `q4_k_matmul_pallas` and `q5_k_matmul_pallas` (ops/kquant_matmul.py,
// `_q6k_kernel`, `_q4k_kernel`, `_q5k_kernel`). Same contract:
//   out [M, F] = x [M, D] @ W^T, W [F, D] = code * scale as the pack's
//   decoder gives it, each weight value dequantized in the activation dtype
//   -- the f32 product code * scale rounded once to bf16, as the TPU kernels
//   dequantize in x.dtype -- and the products accumulated in f32. An affine
//   pack (Q4_K, Q5_K: weight = code * scale - offset per 32 rows) does not
//   fold the offset into the weight, which would round code * scale - offset
//   once more: as `_q4k_kernel` and `_q5k_kernel`, it subtracts
//   bf16(sum of x over each 32 columns) * offset, accumulated in f32 with
//   the rest. Output in f32 or bf16.
//
// Every pack runs kquant_gemm.cuh's GEMM (k-steps through a TMA ring, wgmma
// with the decoded weights in registers, split-K from the host's plan); its
// header has the design. A tensor-parallel row shard of a Q5_K weight, and a
// Q8_0 weight whose D 128 does not divide (D = 2080), end in a ragged k-step.

#include "kquant_gemm.cuh"

// The GEMM (kquant_gemm.cuh): x bfloat16 [M, D]; out_bf16: 1 = bfloat16
// output, 0 = float32. xs: bf16 workspace of M * (D/32 rounded up to 32)
// values for the affine packs' block sums (null for Q6_K and Q8_0); part:
// f32 workspace of splits * M * F values when splits > 1 (may be null
// otherwise); maps: the pack's tensor maps (the *_pack_maps entries)
// in host memory; bm (64 or 128 rows of x a block), splits and
// steps_per_split come from the host's plan. Returns the cudaError_t of the
// launches.
extern "C" int dlp_dequant_matmul_q4_k(const void* x, const void* maps, void* out, void* xs,
                                       void* part, int out_bf16, int M, int D, int F, int bm,
                                       int splits, int steps_per_split, void* stream) {
  return int(dlp_kgemm::launch<dlp_kgemm::Q4K>(x, xs, maps, part, out, out_bf16, M, D, F, bm,
                                               splits, steps_per_split,
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" int dlp_dequant_matmul_q6_k(const void* x, const void* maps, void* out, void* xs,
                                       void* part, int out_bf16, int M, int D, int F, int bm,
                                       int splits, int steps_per_split, void* stream) {
  return int(dlp_kgemm::launch<dlp_kgemm::Q6K>(x, xs, maps, part, out, out_bf16, M, D, F, bm,
                                               splits, steps_per_split,
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" int dlp_dequant_matmul_q5_k(const void* x, const void* maps, void* out, void* xs,
                                       void* part, int out_bf16, int M, int D, int F, int bm,
                                       int splits, int steps_per_split, void* stream) {
  return int(dlp_kgemm::launch<dlp_kgemm::Q5K>(x, xs, maps, part, out, out_bf16, M, D, F, bm,
                                               splits, steps_per_split,
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" int dlp_dequant_matmul_q8_0(const void* x, const void* maps, void* out, void* xs,
                                       void* part, int out_bf16, int M, int D, int F, int bm,
                                       int splits, int steps_per_split, void* stream) {
  return int(dlp_kgemm::launch<dlp_kgemm::Q8>(x, xs, maps, part, out, out_bf16, M, D, F, bm,
                                              splits, steps_per_split,
                                              static_cast<cudaStream_t>(stream)));
}

// A pack's tensor maps into `out` (dlp_dequant_matmul_pack_maps_bytes bytes),
// encoded once for each placement of the pack: Q4_K's fields (qs, a, b),
// Q6_K's (ql, qh, s), Q5_K's (q5, and a, b with rows padded to a multiple
// of 8 values) or Q8_0's (qs, and scale with rows so padded), the dense
// shape D, F. Returns cudaErrorInvalidValue when they cannot be encoded.
extern "C" int dlp_dequant_matmul_q4_k_pack_maps(const void* qs, const void* a, const void* b,
                                                 void* out, int D, int F) {
  return int(dlp_kgemm::encode_pack<dlp_kgemm::Q4K>(qs, a, b, D, F, out));
}

extern "C" int dlp_dequant_matmul_q6_k_pack_maps(const void* ql, const void* qh, const void* s,
                                                 void* out, int D, int F) {
  return int(dlp_kgemm::encode_pack<dlp_kgemm::Q6K>(ql, qh, s, D, F, out));
}

extern "C" int dlp_dequant_matmul_q5_k_pack_maps(const void* q5, const void* a, const void* b,
                                                 void* out, int D, int F) {
  return int(dlp_kgemm::encode_pack<dlp_kgemm::Q5K>(q5, a, b, D, F, out));
}

extern "C" int dlp_dequant_matmul_q8_0_pack_maps(const void* qs, const void* scale, void* out,
                                                  int D, int F) {
  return int(dlp_kgemm::encode_pack<dlp_kgemm::Q8>(qs, scale, nullptr, D, F, out));
}

extern "C" int dlp_dequant_matmul_pack_maps_bytes() {
  return int(sizeof(dlp_kgemm::PackMaps));
}

// The GEMM's tiling over bm rows of x a block (dlp_kgemm::geometry: rows of
// x and of W a block, packed positions a k-step, bands, offset columns a
// k-step, stages, threads, shared memory, blocks an SM holds, the multiple
// of which D must be) for the host's plan. Returns the cudaError_t of the
// queries.
extern "C" int dlp_dequant_matmul_q4_k_geometry(int bm, int* out) {
  return int(dlp_kgemm::geometry<dlp_kgemm::Q4K>(bm, out));
}

extern "C" int dlp_dequant_matmul_q6_k_geometry(int bm, int* out) {
  return int(dlp_kgemm::geometry<dlp_kgemm::Q6K>(bm, out));
}

extern "C" int dlp_dequant_matmul_q5_k_geometry(int bm, int* out) {
  return int(dlp_kgemm::geometry<dlp_kgemm::Q5K>(bm, out));
}

extern "C" int dlp_dequant_matmul_q8_0_geometry(int bm, int* out) {
  return int(dlp_kgemm::geometry<dlp_kgemm::Q8>(bm, out));
}
