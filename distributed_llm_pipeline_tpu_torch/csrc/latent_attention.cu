// Absorbed latent attention over paged latent pools for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the TPU kernel `latent_flash_attention` (distributed_llm_
// pipeline_tpu/ops/latent_attention.py, `_latent_kernel`). Same contract:
//   absorbed queries qa [B,T,H,r] (bf16 or f32) against one latent stream
//   per batch row in pools ck, cv [N,bs,1,r] (like qa, or int8 codes with
//   f32 scales [N,bs,1,1]) through int32 tables [B,NT] and lengths [B]:
//   logical column c of row b lives in physical block tables[b, c / bs] at
//   offset c % bs and attends token t iff c <= lengths[b] + t and, when
//   window > 0, lengths[b] + t - c < window. Scores are scaled by the
//   caller's scale (the original head dim's, never r^-0.5: the absorbed
//   score is the dense q.k), soft-capped before the mask, soft-maxed in f32.
//   Output [B,T,H,r] in qa's dtype, still in latent space: the caller
//   up-projects it once per step. rk == rv (one factorization rank).
//
// Design. A latent pool is a paged pool with one "kv head" of width r that
// every query head reads, so this is attention_tile.cuh's kernel with the
// paged addressing policy at K = 1 and n_rep = H: all H heads of a token
// fold into consecutive query rows (row = t*H + h), exactly the TPU
// kernel's fold. One block owns one batch row and a tile of folded rows
// (32 at r = 128, 16 at r = 512), walks the 32-column latent tiles the mask
// needs (the causal edge and the window bound the walk), stages each in
// shared memory as f32 and keeps an online softmax in f32 registers. At
// r = 512 a K and a V tile of 32 x 516 floats plus 16 query rows take
// 165 KB of the 227 KB a block may use.
//
// What bounds it. Bytes: each needed latent block once (2 r elements a
// token, 4x fewer than the dense pool's 2 K Hd at the default rank K Hd/4),
// plus qa and the output. It is far from that bound for the reasons
// flash_attention.cu gives (scalar f32 FMA, no tensor cores, exposed load
// latency); at decode T*H/rows blocks per batch row run. PERF.md has the
// measurements.

#include "attention_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (the pools share it unless kv_int8 = 1).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_latent_attention(const void* qa, const void* ck_pool,
                                    const void* cv_pool, const float* k_scale,
                                    const float* v_scale, const int* tables,
                                    const int* lengths, void* out, int B, int T,
                                    int NT, int bs, int H, int r, int q_dtype,
                                    int kv_int8, float scale, float softcap,
                                    int window, void* stream) {
  const dlp_attn::Args<dlp_attn::PagedKV> a{
      qa, ck_pool, cv_pool, k_scale, v_scale, dlp_attn::PagedKV{tables, NT, bs},
      NT * bs, lengths, 0, out, B, T, H, /*K=*/1, scale, softcap, window,
      static_cast<cudaStream_t>(stream)};
  return dlp_attn::dispatch<true>(r, q_dtype, kv_int8, a);
}
