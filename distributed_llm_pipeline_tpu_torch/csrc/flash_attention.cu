// Causal-over-cache GQA flash attention over the dense KV cache for Hopper
// (sm_90a), plain C ABI.
//
// Replaces the TPU kernel `flash_attention` (distributed_llm_pipeline_tpu/
// ops/flash_attention.py, `_flash_kernel`). Same contract:
//   q [B,T,H,Hd] against k, v [B,S,K,Hd] (bf16 or f32 like q, or int8 codes
//   with f32 scales [B,S,K,1]); key c attends query t iff
//   c <= cache_len[b] + t and, when window > 0, cache_len[b] + t - c < window.
//   Output [B,T,H,Hd] in q's dtype.
//
// What bounds it. Bytes at decode: Q and O once, and the live K/V columns
// once -- about 1 MiB for one stream at Llama-3.2-1B widths and 1000 cached
// tokens, a third of a microsecond at the card's 3.35 TB/s. Operations at a
// long prefill (4 Hd flops per head and visible pair, on the tensor cores).
// What costs time at decode is parallelism and latency: one stream has
// only K (row, kv head) pairs, 8 at Llama-3.2-1B, against 132 SMs, and a
// pair's columns read one tile after another expose the memory latency of
// each.
//
// Design: paged_tile.cuh's split-KV kernel with its dense addressing policy
// (DenseKV: column c of row b is k[b, c]; no table). The host cuts the
// cache into virtual pages of `bs` columns and plans the launch from shapes
// alone with the paged kernel's split plan (ops/flash_attention.py), so a
// one-stream decode launches at least one block per SM, each walking a
// short run of columns through a cp.async ring in the stored type; Q.K^T
// and P.V run on the tensor cores in bf16 (P as three bf16 terms: all of
// its f32 bits), f32 instantiations on the CUDA cores; a second small
// kernel merges the runs' partial softmaxes in run order. Head widths 64,
// 128, 256 and 512 (the single-stream latent path runs this kernel at head
// dim r over its [B, S, 1, r] latent cache). PERF.md has the measurements.

#include "paged_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (k/v share it unless kv_int8 = 1).
// cache_lens: device int32 [B], or null to use cache_len_scalar for every
// row. ws: f32 workspace of splits * B * T * H * (Hd + 2) values when
// splits > 1 (the partial accumulators, then each row's (m, l)); may be null
// otherwise. bs (the virtual page), rows_per_block, pages_per_split and
// splits come from the host's plan over NT = ceil(S / bs) pages. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int dlp_flash_attention(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale,
                                   const int* cache_lens, int cache_len_scalar,
                                   void* out, float* ws, int B, int T, int S, int H,
                                   int K, int Hd, int q_dtype, int kv_int8, float scale,
                                   float softcap, int window, int bs, int rows_per_block,
                                   int pages_per_split, int splits, void* stream) {
  if (K < 1 || H % K || bs < 1) return int(cudaErrorInvalidValue);
  const size_t acc_n = size_t(splits) * B * T * H * Hd;
  const dlp_paged::Params p{
      q, k, v, k_scale, v_scale, /*tables=*/nullptr, cache_lens, out, ws,
      ws ? ws + acc_n : nullptr, B, T, H, K, (S + bs - 1) / bs, bs, H / K,
      rows_per_block, pages_per_split, splits, scale, softcap, window, S,
      cache_len_scalar};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using dlp_paged::DenseKV;
  switch (Hd) {
    case 64:
      return int(dlp_paged::dispatch_dtype<64, DenseKV>(q_dtype, kv_int8, p, st));
    case 128:
      return int(dlp_paged::dispatch_dtype<128, DenseKV>(q_dtype, kv_int8, p, st));
    case 256:
      return int(dlp_paged::dispatch_dtype<256, DenseKV>(q_dtype, kv_int8, p, st));
    case 512:
      return int(dlp_paged::dispatch_dtype<512, DenseKV>(q_dtype, kv_int8, p, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The kernel's tiling at head width Hd (dlp_paged::geometry: columns per
// staged tile, warps per 16-row query tile, warps per block) for the host's
// split plan. Returns cudaErrorInvalidValue for a width it does not take.
extern "C" int dlp_flash_attention_geometry(int Hd, int* out) {
  if (Hd != 64 && Hd != 128 && Hd != 256 && Hd != 512) return int(cudaErrorInvalidValue);
  dlp_paged::geometry(Hd, out);
  return 0;
}
