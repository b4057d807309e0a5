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
// What bounds it. Bytes at decode: each needed latent block once (2 r
// elements a token, 4x fewer than the dense pool's 2 K Hd at the default
// rank K Hd/4), plus qa and the output: well under a microsecond at B = 4.
// Every head reads the same latents, so a decode step's work is B streams
// of 32 folded rows, and mixed and prefill steps 2 r flops a (row, column)
// on every one of T * H rows: the tensor cores' work.
//
// Design: paged_tile.cuh's split-KV kernel with one "kv head" of width r
// and n_rep = H: all H heads of a token fold into consecutive query rows
// (row = t*H + h), the TPU kernel's fold, so the folded rows fill m16 tiles
// at every T and Q.K^T and P.V (P as two bf16 terms) run on the tensor
// cores. The host's split plan (ops/paged_attention.py `split_plan`) cuts
// the pages into runs and, where B runs of pages still leave SMs idle (one
// or four streams at decode), the 32 rows of a token into narrower query
// tiles, so a decode step launches at least one block per SM. At r = 512
// four warps share a row tile, each keeping 128 of the output dims. A
// second small kernel merges the runs in run order. PERF.md has the
// measurements.

#include "paged_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (the pools share it unless kv_int8 = 1).
// ws: f32 workspace of splits * B * T * H * (r + 2) values when splits > 1;
// may be null otherwise. rows_per_block, pages_per_split and splits come
// from the host's plan. Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_latent_attention(const void* qa, const void* ck_pool,
                                    const void* cv_pool, const float* k_scale,
                                    const float* v_scale, const int* tables,
                                    const int* lengths, void* out, float* ws,
                                    int B, int T, int NT, int bs, int H, int r,
                                    int q_dtype, int kv_int8, float scale,
                                    float softcap, int window, int rows_per_block,
                                    int pages_per_split, int splits, void* stream) {
  const size_t acc_n = size_t(splits) * B * T * H * r;
  const dlp_paged::Params p{
      qa, ck_pool, cv_pool, k_scale, v_scale, tables, lengths, out, ws,
      ws ? ws + acc_n : nullptr, B, T, H, /*K=*/1, NT, bs, /*n_rep=*/H,
      rows_per_block, pages_per_split, splits, scale, softcap, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 64:
      return int(dlp_paged::dispatch_dtype<64>(q_dtype, kv_int8, p, st));
    case 128:
      return int(dlp_paged::dispatch_dtype<128>(q_dtype, kv_int8, p, st));
    case 256:
      return int(dlp_paged::dispatch_dtype<256>(q_dtype, kv_int8, p, st));
    case 512:
      return int(dlp_paged::dispatch_dtype<512>(q_dtype, kv_int8, p, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The kernel's tiling at head width r (dlp_paged::geometry: columns per
// staged tile, warps per 16-row query tile, warps per block) for the host's
// split plan. Returns cudaErrorInvalidValue for a width it does not take.
extern "C" int dlp_latent_attention_geometry(int r, int* out) {
  if (r != 64 && r != 128 && r != 256 && r != 512) return int(cudaErrorInvalidValue);
  dlp_paged::geometry(r, out);
  return 0;
}
