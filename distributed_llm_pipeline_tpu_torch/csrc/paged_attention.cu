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
// Design. The kernel is attention_tile.cuh's, shared with the dense layout
// (flash_attention.cu), with the paged addressing policy. One block owns one
// (batch row, KV head) pair and a tile of folded query rows. It walks the
// logical columns in 32-column tiles from the first one inside the window to
// the last one the causal mask needs (the TPU kernel's `_tbl_index` clamp:
// blocks past the causal edge and blocks wholly before the window are never
// read). For each column it stages in shared memory, the block reads that
// column's table entry itself; there is no scalar prefetch. Shared blocks (a prefix hit) are only
// read here, so rows whose tables name one physical block need nothing
// special. The online softmax is the classic one in f32; the TPU kernel's
// integer-exponent (AMLA) rescale agrees with it to f32 rounding.
//
// What bounds it. Bytes: the K/V of the blocks the mask needs, once, plus Q
// and O. The design reads only those blocks, and each block once per query
// tile. It is far from the bound for the reasons flash_attention.cu gives
// (scalar f32 FMA, no tensor cores, only B*K blocks at decode, exposed
// load latency); PERF.md has the measurements.

#include "attention_tile.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (the pools share it unless kv_int8 = 1).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const float* k_scale,
                                   const float* v_scale, const int* tables,
                                   const int* lengths, void* out, int B, int T,
                                   int NT, int bs, int H, int K, int Hd,
                                   int q_dtype, int kv_int8, float scale,
                                   float softcap, int window, void* stream) {
  const dlp_attn::Args<dlp_attn::PagedKV> a{
      q, k_pool, v_pool, k_scale, v_scale, dlp_attn::PagedKV{tables, NT, bs},
      NT * bs, lengths, 0, out, B, T, H, K, scale, softcap, window,
      static_cast<cudaStream_t>(stream)};
  return dlp_attn::dispatch(Hd, q_dtype, kv_int8, a);
}
