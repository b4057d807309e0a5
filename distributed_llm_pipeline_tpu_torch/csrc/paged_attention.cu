// Causal-over-cache GQA attention over a paged KV pool for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the TPU kernel `paged_flash_attention` (distributed_llm_pipeline_
// tpu/ops/paged_attention.py, `_paged_kernel`). Same contract:
//   q [B,T,H,Hd] against pools k, v [N,bs,K,Hd] (bf16 or f32 like q, or int8
//   codes with f32 scales [N,bs,K,1]) through int32 tables [B,NT] and int32
//   lengths [B]: logical column c of row b lives in physical block
//   tables[b, c / bs] at offset c % bs, and attends query t iff
//   c <= lengths[b] + t and, when window > 0, lengths[b] + t - c < window.
//   Output [B,T,H,Hd] in q's dtype. Unmapped table entries are 0, the
//   sentinel block, which is a real block and legal to read. A parked row
//   (lengths[b] = max_seq) sees every column up to NT * bs and no further.
//
// What bounds it. Bytes: Q and O once, and the K/V of the pages the masks
// reach, once. A decode step moves a few MB at most, microseconds at the
// card's 3.35 TB/s, so what costs time is parallelism and latency: B * K
// (row, kv head) pairs (32 at Llama-3.2-1B, B = 4) cannot fill 132 SMs, and
// a row's pages read one after another expose the memory latency of each.
//
// Design: paged_tile.cuh's split-KV kernel at K kv heads, n_rep = H / K.
// The host's split plan (ops/paged_attention.py `split_plan`, shapes only)
// cuts each row's NT pages into runs, one block per (query tile, run, row,
// kv head), so a B = 4 decode launches hundreds of blocks and the longest
// row's walk is a few pages; a block reads its pages' table entries once and
// keeps two or three 16-byte cp.async tiles in flight in the stored type;
// scores and P.V run on the tensor cores in bf16 (P as two bf16 terms); a
// second small kernel merges the runs' partial softmaxes in run order. Shared
// blocks (a prefix hit) are only read here, so rows whose tables name one
// physical block need nothing special. The online softmax is the classic one
// in f32; the TPU kernel's integer-exponent (AMLA) rescale agrees with it to
// f32 rounding. PERF.md has the measurements.

#include "paged_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (the pools share it unless kv_int8 = 1).
// ws: f32 workspace of splits * B * T * H * (Hd + 2) values when splits > 1
// (the partial accumulators, then each row's (m, l)); may be null otherwise.
// rows_per_block, pages_per_split and splits come from the host's plan.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const float* k_scale,
                                   const float* v_scale, const int* tables,
                                   const int* lengths, void* out, float* ws,
                                   int B, int T, int NT, int bs, int H, int K,
                                   int Hd, int q_dtype, int kv_int8, float scale,
                                   float softcap, int window, int rows_per_block,
                                   int pages_per_split, int splits, void* stream) {
  if (K < 1 || H % K) return int(cudaErrorInvalidValue);
  const size_t acc_n = size_t(splits) * B * T * H * Hd;
  const dlp_paged::Params p{
      q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, ws,
      ws ? ws + acc_n : nullptr, B, T, H, K, NT, bs, H / K, rows_per_block,
      pages_per_split, splits, scale, softcap, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hd) {
    case 64:
      return int(dlp_paged::dispatch_dtype<64>(q_dtype, kv_int8, p, st));
    case 128:
      return int(dlp_paged::dispatch_dtype<128>(q_dtype, kv_int8, p, st));
    case 256:
      return int(dlp_paged::dispatch_dtype<256>(q_dtype, kv_int8, p, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The kernel's tiling at head width Hd (dlp_paged::geometry: columns per
// staged tile, warps per 16-row query tile, warps per block) for the host's
// split plan. Returns cudaErrorInvalidValue for a width it does not take.
extern "C" int dlp_paged_attention_geometry(int Hd, int* out) {
  if (Hd != 64 && Hd != 128 && Hd != 256) return int(cudaErrorInvalidValue);
  dlp_paged::geometry(Hd, out);
  return 0;
}
