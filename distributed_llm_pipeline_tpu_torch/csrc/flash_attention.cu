// Causal-over-cache GQA flash attention for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel `flash_attention` (distributed_llm_pipeline_tpu/
// ops/flash_attention.py, `_flash_kernel`). Same contract:
//   q [B,T,H,Hd] against k, v [B,S,K,Hd] (bf16 or f32 like q, or int8 codes
//   with f32 scales [B,S,K,1]); key c attends query t iff
//   c <= cache_len[b] + t and, when window > 0, cache_len[b] + t - c < window.
//   Output [B,T,H,Hd] in q's dtype.
//
// Design. The kernel is attention_tile.cuh's, shared with the paged layout
// (paged_attention.cu), with the dense addressing policy: column c of row b
// is k[b, c]. GQA is folded into query rows as on the TPU; one block owns
// one (batch row, KV head) pair and a tile of folded query rows, walks the
// 32-key KV tiles the mask needs, stages each in shared memory and keeps an
// online softmax in f32 registers.
//
// What bounds it. At the main path's shapes the work is below the card's
// ridge point, so the least time is set by the bytes: Q, the live K/V and O.
// This first version is far from that bound. It is scalar f32 FMA work with
// no tensor cores, one block of 4 warps per (row, KV head, query tile), and
// one query row per warp at decode. Each 32-key tile then costs microseconds
// of latency: exposed HBM latency, plus the serial warp shuffles of the
// online softmax. At decode only B*K blocks run (PERF.md has the
// measurements). The planned fast version splits decode's KV walk across
// blocks, pipelines the tile loads with TMA, and runs QK^T and PV on wgmma.

#include "attention_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (k/v share it unless kv_int8 = 1).
// cache_lens: device int32 [B], or null to use cache_len_scalar for every row.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_flash_attention(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale,
                                   const int* cache_lens, int cache_len_scalar,
                                   void* out, int B, int T, int S, int H, int K,
                                   int Hd, int q_dtype, int kv_int8, float scale,
                                   float softcap, int window, void* stream) {
  const dlp_attn::Args<dlp_attn::DenseKV> a{
      q, k, v, k_scale, v_scale, dlp_attn::DenseKV{S}, S, cache_lens,
      cache_len_scalar, out, B, T, H, K, scale, softcap, window,
      static_cast<cudaStream_t>(stream)};
  // head widths up to 512: the single-stream latent path runs this kernel
  // at head dim r over its [B, S, 1, r] latent cache
  return dlp_attn::dispatch<true>(Hd, q_dtype, kv_int8, a);
}
