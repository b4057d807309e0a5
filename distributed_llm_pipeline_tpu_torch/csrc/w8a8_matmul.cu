// W8A8 integer-dot matmul of few activation rows against a Q8_0, int8, Q6_K,
// Q4_K, Q5_KS, Q2_KS or Q3_KS pack or a Q4_K8, Q5_K or Q6_K8 byte-code pack,
// for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels `gw8a8_matmul_pallas` (distributed_llm_pipeline_
// tpu/ops/quant_matmul.py, math in `gw8a8_band_accum`) on Q8_0 packs,
// `int8_matmul_pallas` (`_int8_kernel`) on int8 packs at M <= 4 (int8's
// larger M runs int8_matmul.cu), `q6_k_w8a8_matmul_pallas`
// (ops/kquant_matmul.py, `_q6k_w8a8_kernel`) on Q6_K packs,
// `q4_k_w8a8_matmul_pallas` / `q5_ks_w8a8_matmul_pallas` /
// `q2_ks_w8a8_matmul_pallas` (`_q4k_w8a8_kernel`, `_q5ks_w8a8_kernel`,
// `_q2ks_w8a8_kernel`) on the affine Q4_K, Q5_KS and Q2_KS packs, and
// `q3_ks_w8a8_matmul_pallas` (`_q3ks_w8a8_kernel`) on Q3_KS packs, and
// `gw8a8_matmul_pallas` again on the byte-code Q4_K8, Q5_K (affine) and
// Q6_K8 packs of tp > 1 meshes (ops/kquant_matmul.py, the `q4_k8`, `q5_k`
// and `q6_k8` routes of `kquant_matmul`). Same
// contract, with the activation quantization folded in:
//   x [M, D] (f32 or bf16, M <= 32) is quantized per (row, group of `group`
//   columns): xs = amax * f32(1/127) (the reference's amax / 127 as XLA
//   compiles it), inv = xs > 0 ? 1 / max(xs, 1e-30) : 0 (IEEE division),
//   xq = clamp(rint(x * inv), -127, 127) -- the reference's `quantize_acts`,
//   bit for bit. Then out[m, f] = sum over groups g of
//   xs[m, g] * sum over sub-blocks s of g of float(P[m, s, f]) * scale[f, s],
//   where P is the exact int32 dot of xq and the weight codes over the
//   sub-block's SUB rows (32 for Q8_0, int8, Q4_K, Q5_KS, Q4_K8 and Q5_K,
//   16 for Q6_K, Q2_KS, Q3_KS and Q6_K8; int8's f32 scale is its group's, shared by the group's
//   sub-blocks). An affine pack (weight = code * scale - offset) subtracts
//   sum over s of (float(S[m, s]) * xs[m, g(s)]) * offset[f, s], S the exact
//   sum of xq over the sub-block. Output [M, F] in f32 or bf16.
//
// Two kernels serve the contract.
//
// gemv_kernel, the persistent GEMV, serves the Q6_K, Q4_K, Q5_KS, Q2_KS,
// Q3_KS and Q8_0 packs and the byte codes Q4_K8, Q5_K and Q6_K8 (every
// entry but int8; a byte-code pack only at D % 256 == 0, below). What
// bounds it: a decode step's projection is a GEMV over the weight bytes,
// 0.5 B a weight for Q2_KS and Q3_KS, 0.625 for Q4_K, 0.75 for Q5_KS,
// 0.875 for Q6_K, 1.0625 for Q8_0 and Q6_K8 and 1.125 for Q4_K8 and Q5_K
// with their bf16 scales and offsets (Llama-3.2-1B's gate_up, 2048 x 8192:
// 8.4 to 18.9 MB, 2.5 to 5.6 us at 3.35 TB/s), with M <= 32 rows of x
// reused against each code. So the design
// moves each weight byte once, keeps enough of them in flight, and spends
// per code only what grows with M:
//
// - x quantized once, not once a block. A small launch ahead of the GEMV
//   (gemv_acts_kernel, one warp a group of x) writes each pass's image of the
//   GEMV's x region to an L2-resident workspace: xq, xs, and for an affine
//   pack -(float(S) * xs) of each sub-block's integer sum S, rows past M
//   zero. The GEMV is launched as its programmatic dependent: its blocks
//   start, and issue their first weight copies, while x is quantized;
//   griddepcontrol.wait then holds only the x image's one bulk copy into
//   shared memory.
// - A persistent grid, cut by the host (ops/quant_matmul.py `gemv_plan`,
//   shapes only): about the SM count times the blocks an SM holds (two
//   where shared memory allows), each block a run of contiguous output
//   rows, walked in tiles of rows_per_tile rows. Where the rows of x do not
//   fit beside the ring, the block takes them m_slice rows a pass and
//   streams its weight rows once a pass (the later passes mostly from L2):
//   each output's sum is then the same, in the same order, as in one pass.
// - An asynchronous ring of `stages` stages (~64-96 KB a block, no more
//   than the block's tiles). The pack's fields are [F, .], so a tile's rows
//   of each field are one contiguous span: one thread fills a stage with
//   one 1-D bulk copy a field (cp.async.bulk into an mbarrier that counts
//   the bytes) and refills it once every warp has left it (the tile's
//   closing barrier).
// - Each packed byte read once for all its bands (quant_tile.cuh, the span
//   view): a lane takes a span (64 weights) of ROWS rows of the tile: 16
//   bytes of q2l a row (four 16-row sub-blocks, one a band), 16 of q3l and
//   8 of q3h (Q3_KS: the same four, with their third bits), 32 of qs (Q4_K:
//   one 32-row sub-block of each of the two bands), 32 of q5n and 8 of q5h
//   (Q5_KS: the same two), 32 of ql and 16 of qh (Q6_K: one 16-row
//   sub-block of each of four bands), or 64 codes of a byte-code pack (two
//   or four sub-blocks of one plane). It
//   holds those bytes in registers and decodes each sub-block's codes from
//   them, then runs dp4a against the sub-block's columns of xq: 16-byte
//   shared loads with neighbouring lanes on neighbouring spans, the chunks
//   of a span taken in an order swizzled by lane bits where lanes lie 32 or
//   64 bytes apart (Q4_K, Q5_KS, the byte codes), so a quarter warp hits
//   distinct banks; each load serves the lane's ROWS rows. The shared loads
//   of x, not the dp4a, set the pace at M >= 4: ROWS is 4 for Q2_KS and
//   Q3_KS (2 past 8 rows of x, for the registers) and 2 for the others
//   (Q4_K at 4 rows up to 4 rows of x: 0.91-0.98x the time on gate_up,
//   down and the head, 1.02-1.13x on wq_wo and wk_wv, a served step within
//   2%; 2 rows also fit the ring at every D: PERF.md).
// - Per-row accumulators, no per-sub-block shuffle: each sub-block's term
//   goes straight into the lane's f32 accumulator of (row, m): float(P)
//   from the bits 0x4B400000 + P (the dot's initial value) less 1.5 * 2^23,
//   exact for |P| < 2^22, times a in one fma (the product P * a rounded
//   once), acc = fma(xs, P * a, acc), then acc = fma(-(float(S) * xs), b,
//   acc). Rows of x are taken 8 at a time (MC) and padded to a power of two
//   with zeros, so no branch stands between the loads of x and their use.
//   At the tile's end the lane's ROWS x MC sums are reduced across the warp
//   (a transposed butterfly: ROWS x MC - 1 shuffles, not 5 a value, each sum
//   bit for bit the butterfly's), and the warps of a row (warps_per_row,
//   where a row has more than 32 spans) are summed in order through shared
//   memory: no atomics, a relaunch gives the same bits. This sums in
//   another f32 order than the plain version's group-then-scale one: one
//   bf16 ulp holds both (chip_smoke.py), and tests/test_torch_w8a8_gemv.py
//   holds a mirror of this order against the JAX kernels.
//
// w8a8_kernel serves int8 (at M <= 4) and a byte-code pack whose D is no
// multiple of 256 (a tp shard's edge; the host routes by shape). One warp
// owns one output row f; lane j takes sub-block s0 + j of the chunk, loads
// its 16-byte codes into registers (quant_tile.cuh) and runs SUB/4 dp4a per
// activation row. The group sum over the sub-blocks of one group is a
// butterfly over the group's adjacent lanes; each group's sum times xs goes
// into a per-lane f32 accumulator, summed across the warp at the end. Each
// block (8 warps, 8 output rows) quantizes x itself, 1024 columns at a time
// into shared memory: no separate launch per projection, at the price of
// re-reading x from L2 once per block (cheap at decode's M, dominant at M =
// 32 against narrow F). For an affine pack the prologue also stores each
// row's sums S over every SUB columns (dp4a against ones), and each lane
// subtracts its sub-block's offset term.

#include <type_traits>

#include "kquant_gemm.cuh"
#include "quant_tile.cuh"

namespace {

using namespace dlp_quant;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;  // columns of x quantized into shared memory at a time

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// MT: activation rows the registers hold (M <= MT); xq_out / xs_out, when not
// null, receive block 0's quantized activations
template <class Dec, int MT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(Dec dec, const void* __restrict__ x, bool x_bf16, void* __restrict__ out,
            bool out_bf16, int M, int D, int F, int group, int8_t* __restrict__ xq_out,
            float* __restrict__ xs_out) {
  constexpr int SUB = Dec::SUB;
  constexpr int WORDS = SUB / 4;  // code words per sub-block
  __shared__ __align__(16) int8_t xq_s[MT][kChunk];
  __shared__ float xs_s[MT][kChunk / 32];
  __shared__ int ss_s[Dec::AFFINE ? MT : 1][kChunk / SUB];  // per-SUB sums of xq
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * kWarps + warp;
  const int spg = group / SUB;  // sub-blocks per group: 1 to 16 lanes
  const bool dump = xq_out != nullptr && blockIdx.x == 0;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int len = min(kChunk, D - c0);
    const int ng = len / group;
    __syncthreads();  // the previous chunk is consumed
    // quantize x[:, c0 : c0 + len], one warp per (row, group)
    for (int pr = warp; pr < M * ng; pr += kWarps) {
      const int m = pr / ng, g = pr % ng;
      const size_t base = size_t(m) * D + c0 + size_t(g) * group;
      float amax = 0.f;
      for (int i = lane; i < group; i += 32) amax = fmaxf(amax, fabsf(load_f32(x, base + i, x_bf16)));
      amax = warp_max(amax);
      const float xs = amax * (1.0f / 127.0f);
      const float inv = xs > 0.f ? 1.0f / fmaxf(xs, 1e-30f) : 0.f;
      for (int i = lane; i < group; i += 32) {
        const float q = fminf(fmaxf(rintf(load_f32(x, base + i, x_bf16) * inv), -127.f), 127.f);
        xq_s[m][g * group + i] = int8_t(q);
        if (dump) xq_out[base + i] = int8_t(q);
      }
      if (lane == 0) {
        xs_s[m][g] = xs;
        if (dump) xs_out[size_t(m) * (D / group) + c0 / group + g] = xs;
      }
      if constexpr (Dec::AFFINE) {
        __syncwarp();  // the group's codes are in shared memory
        for (int sb = lane; sb < group / SUB; sb += 32) {
          const int* xw = reinterpret_cast<const int*>(&xq_s[m][g * group + sb * SUB]);
          int sum = 0;
#pragma unroll
          for (int i = 0; i < WORDS; ++i) sum = __dp4a(xw[i], 0x01010101, sum);
          ss_s[m][g * group / SUB + sb] = sum;
        }
      }
    }
    __syncthreads();
    if (f >= F) continue;  // a ragged last block: no row, but it keeps the barriers

    const int nsb = len / SUB;
    for (int s0 = 0; s0 < nsb; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < nsb;  // a whole group is live or not: 32 % spg == 0
      int w[WORDS];
      float sc = 0.f, off = 0.f;
#pragma unroll
      for (int i = 0; i < WORDS; ++i) w[i] = 0;
      if (live) {
#pragma unroll
        for (int h = 0; h < SUB / 16; ++h) dec.codes16(f, c0 + s * SUB + 16 * h, w + 4 * h);
        sc = dec.scale_at(f, c0 + s * SUB);
        if constexpr (Dec::AFFINE) off = dec.offset_at(f, c0 + s * SUB);
      }
      const int col = live ? s * SUB : 0;
      const int g = col / group;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const int* xw = reinterpret_cast<const int*>(&xq_s[m][col]);
          int p = 0;
#pragma unroll
          for (int i = 0; i < WORDS; ++i) p = __dp4a(w[i], xw[i], p);
          float t = float(p) * sc;  // the sub-block's term
          for (int o = 1; o < spg; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
          if (live && lane % spg == 0) acc[m] += t * xs_s[m][g];  // group sum, times xs
          if constexpr (Dec::AFFINE) {  // sub-block s is sum s
            if (live) acc[m] -= float(ss_s[m][s]) * xs_s[m][g] * off;
          }
        }
      }
    }
  }
  if (f >= F) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float v = warp_sum(acc[m]);
      if (lane == 0) store_f32(out, size_t(m) * F + f, v, out_bf16);
    }
  }
}

template <class Dec, int MT>
cudaError_t launch_mt(const Dec& dec, const void* x, int x_bf16, void* out, int out_bf16,
                      int M, int D, int F, int group, int8_t* xq_out, float* xs_out,
                      cudaStream_t stream) {
  const dim3 grid((F + kWarps - 1) / kWarps);
  w8a8_kernel<Dec, MT><<<grid, kThreads, 0, stream>>>(dec, x, x_bf16 != 0, out, out_bf16 != 0,
                                                      M, D, F, group, xq_out, xs_out);
  return cudaGetLastError();
}

template <class Dec>
int launch(const Dec& dec, const void* x, int8_t* xq_out, float* xs_out, void* out,
           int x_bf16, int out_bf16, int M, int D, int F, int group, void* stream) {
  if (M < 1 || M > 32 || F < 1 || group < Dec::SUB || group % Dec::SUB || D % group ||
      kChunk % group || 32 % (group / Dec::SUB))
    return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = [&](auto mt) {
    return int(launch_mt<Dec, decltype(mt)::value>(dec, x, x_bf16, out, out_bf16, M, D, F,
                                                   group, xq_out, xs_out, st));
  };
  if (M <= 1) return a(std::integral_constant<int, 1>{});
  if (M <= 2) return a(std::integral_constant<int, 2>{});
  if (M <= 4) return a(std::integral_constant<int, 4>{});
  if (M <= 8) return a(std::integral_constant<int, 8>{});
  if (M <= 16) return a(std::integral_constant<int, 16>{});
  return a(std::integral_constant<int, 32>{});
}

// ---------------------------------------------------------------------------
// the persistent GEMV (every pack but int8)

using dlp_kgemm::mbar_arrive_tx;
using dlp_kgemm::mbar_init;
using dlp_kgemm::mbar_wait;
using dlp_kgemm::smem_u32;

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvMaxStages = 8;
constexpr int kGemvSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kGemvMaxM = 32;

// `bytes` (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The block's shared memory, in bytes from its start: the ring (stages x
// rows_per_tile rows of each field in turn), then for MT rows of x (the
// register rows m_slice takes; rows past the pass's are zero): xq [MT][D]
// int8, xs [MT][D / group] f32, nsx [MT][D / SUB] f32 (affine packs:
// -(float(S) * xs)), then the warps' sums of two tiles, red [2][8 R][MT]
// f32 (a tile's (row, slice) pairs, R = ROWS(MT)), and one mbarrier a stage
// and one for x. The x region [xq, red) is also the image gemv_acts_kernel
// writes for each pass. The host computes it once a launch and passes it to
// gemv_kernel (a parameter: no register holds it). ops/quant_matmul.py
// `gemv_smem` and `gemv_plan` compute the same sizes; gemv_launch refuses a
// plan whose smem differs.
struct GemvLayout {
  int row, stage, xq, xs, sx, red, bars, total;
  int ngr, nsub;  // a row's entries of xs (D / group) and of nsx (D / SUB)
};

__host__ __device__ constexpr int gemv_mt(int m_slice) {
  return m_slice <= 1 ? 1 : m_slice <= 2 ? 2 : m_slice <= 4 ? 4 : m_slice <= 8 ? 8
         : m_slice <= 16 ? 16 : 32;
}

template <class Dec>
__host__ __device__ inline GemvLayout gemv_layout(int D, int group, int rows_per_tile, int stages,
                                                  int m_slice) {
  const int mt = gemv_mt(m_slice);
  GemvLayout L;
  L.row = 0;
  for (int i = 0; i < Dec::FIELDS; ++i) L.row += Dec::field_bytes(i, D);
  L.stage = rows_per_tile * L.row;
  L.xq = stages * L.stage;
  L.xs = L.xq + mt * D;
  L.sx = L.xs + (mt * (D / group) * 4 + 15) / 16 * 16;
  L.red = L.sx + (Dec::AFFINE ? mt * (D / Dec::SUB) * 4 : 0);
  L.bars = L.red + 2 * kGemvWarps * Dec::ROWS(mt) * mt * 4;
  L.total = L.bars + 8 * (stages + 1);
  L.ngr = D / group;
  L.nsub = D / Dec::SUB;
  return L;
}

// -(float(S) * xs) of the SUB codes at xw (16-byte aligned), S their exact
// sum: an affine sub-block's offset factor
template <int SUB>
__device__ __forceinline__ float neg_sub_sum(const int8_t* xw, float xs) {
  int S = 0;
#pragma unroll
  for (int c = 0; c < SUB / 16; ++c) {
    const int4 v = reinterpret_cast<const int4*>(xw)[c];
    S = __dp4a(v.x, 0x01010101, S);
    S = __dp4a(v.y, 0x01010101, S);
    S = __dp4a(v.z, 0x01010101, S);
    S = __dp4a(v.w, 0x01010101, S);
  }
  return -(float(S) * xs);
}

// The activations as the GEMV's x region holds them, for every pass: warp
// w of block (pass p, row m, chunk c) quantizes group 8 c + w of x row p *
// m_slice + m (quantize_group, as int8_matmul.cu's quantize launch does)
// and writes it to the pass's image at ws + p * (image bytes): xq [MT][D],
// xs [MT][D / group] and, for an affine pack, nsx [MT][D / SUB] =
// -(float(S) * xs); rows past the pass's, or past M, are zero. One group a
// warp keeps every load of x in flight at once. xq_out / xs_out, when not
// null, receive the activations. It lets its dependent GEMV start at once
// (griddepcontrol), so the GEMV's weight copies are in flight while x is
// quantized.
template <class Dec>
__global__ void __launch_bounds__(kGemvThreads)
gemv_acts_kernel(const void* __restrict__ x, bool x_bf16, uint8_t* __restrict__ ws, int M, int D,
                 int group, int m_slice, int8_t* __restrict__ xq_out,
                 float* __restrict__ xs_out) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int SUB = Dec::SUB;
  __shared__ __align__(16) int8_t xq_s[kGemvWarps][256];  // a warp's group (group <= 256)
  const int ngr = D / group, chunks = (ngr + kGemvWarps - 1) / kGemvWarps;
  const int mt = gemv_mt(m_slice), pm = blockIdx.x / chunks;
  const int pass = pm / mt, m = pm % mt, row = pass * m_slice + m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x % chunks * kGemvWarps + warp;
  if (g >= ngr) return;
  const GemvLayout L = gemv_layout<Dec>(D, group, 1, 1, m_slice);
  uint8_t* img = ws + size_t(pass) * (L.red - L.xq);
  int4* xq = reinterpret_cast<int4*>(img + size_t(m) * D + size_t(g) * group);
  float* xs = reinterpret_cast<float*>(img + (L.xs - L.xq)) + m * ngr + g;
  float* nsx = reinterpret_cast<float*>(img + (L.sx - L.xq)) + m * (D / SUB) + g * (group / SUB);
  int8_t* q = xq_s[warp];
  const bool live = m < m_slice && row < M;
  float s = 0.f;
  if (live) {
    s = quantize_group(x, x_bf16, size_t(row) * D + size_t(g) * group, group, q);
  } else {
    for (int i = lane; i < group; i += 32) q[i] = 0;
  }
  __syncwarp();
  for (int o = lane; o < group / 16; o += 32) xq[o] = reinterpret_cast<const int4*>(q)[o];
  if (lane == 0) *xs = s;
  if constexpr (Dec::AFFINE) {
    for (int sb = lane; sb < group / SUB; sb += 32)
      nsx[sb] = live ? neg_sub_sum<SUB>(q + sb * SUB, s) : 0.f;
  }
  if (live && xq_out != nullptr) {
    for (int i = lane; i < group; i += 32) xq_out[size_t(row) * D + size_t(g) * group + i] = q[i];
    if (lane == 0) xs_out[size_t(row) * ngr + g] = s;
  }
}

// N <= 32 values a lane summed across the warp, each as the butterfly (xor
// 16, 8, 4, 2, 1) sums it, bit for bit: at each of the first log2(N) steps a
// lane keeps half of its values (the upper half where its bit o is set) and
// adds its partner's copy of that half (the same two operands as the
// butterfly's add, which commutes); the rest are butterfly steps. Lane l
// ends with value l / (32 / N) in v[0].
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  static_assert(N <= 32 && (N & (N - 1)) == 0, "a power of two up to 32 values");
  int n = N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        if (j < n / 2) {
          const float keep = up ? v[j + n / 2] : v[j];
          const float send = up ? v[j] : v[j + n / 2];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// MT: the register rows of x (m_slice <= MT), taken MC at a time. Block b
// owns output rows [b * rows_per_block, min(F, (b + 1) * rows_per_block));
// step i of its walk is tile i % tiles of pass i / tiles, in ring stage i %
// stages. A tile's row t is taken by warps (t % (8 / wpr)) * wpr + slice,
// slice < wpr, as their lane-row t / (8 / wpr) of R. The lanes compute
// every lane-row and every row of x (past a ragged tile's rows on stale
// bytes, past the pass's rows of x on zeros) and write only the real ones:
// no branch stands between the loads of x and their use.
template <class Dec, int MT>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_kernel(Dec dec, const GemvLayout L, const uint8_t* __restrict__ ws, void* __restrict__ out,
            bool out_bf16, int M, int D, int F, int group, int rows_per_block, int rows_per_tile,
            int stages, int m_slice) {
  constexpr int BANDS = Dec::BANDS, SUB = Dec::SUB, CH = Dec::CH;
  constexpr int R = Dec::ROWS(MT);          // rows of a tile a lane takes
  constexpr int MC = MT < 8 ? MT : 8;       // rows of x a lane's sums hold at once
  constexpr int N = R * MC;
  static_assert(CH * 16 * BANDS == 64, "a span is 64 weights");
  extern __shared__ __align__(128) uint8_t smem[];
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem + L.xq);
  float* xs_s = reinterpret_cast<float*>(smem + L.xs);
  float* nsx_s = reinterpret_cast<float*>(smem + L.sx);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const uint32_t bar0 = smem_u32(smem + L.bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f_begin = blockIdx.x * rows_per_block;
  const int f_end = min(F, f_begin + rows_per_block);
  const int tiles = (f_end - f_begin + rows_per_tile - 1) / rows_per_tile;
  const int steps = (M + m_slice - 1) / m_slice * tiles;
  const int ngr = L.ngr, nsub = L.nsub, n_span = D / 64;
  const int wpr = kGemvWarps * R / rows_per_tile;  // warps a row
  const int rstep = kGemvWarps / wpr;               // the tile rows of lane-row 0
  const int row0 = warp / wpr, slice = warp % wpr;
  const int h = Dec::order(lane);  // the lane's chunk order

  // step i's rows of every field into its stage (thread 0)
  const auto issue = [&](int i) {
    const int r0 = f_begin + (i % tiles) * rows_per_tile;
    const int nr = min(rows_per_tile, f_end - r0);
    const uint32_t st = smem_u32(smem + (i % stages) * L.stage);
    const uint32_t bar = bar0 + 8 * (i % stages);
    mbar_arrive_tx(bar, nr * L.row);
    int off = 0;
#pragma unroll
    for (int j = 0; j < Dec::FIELDS; ++j) {
      const int fb = Dec::field_bytes(j, D);
      bulk_load(st + off, static_cast<const uint8_t*>(dec.field(j)) + size_t(r0) * fb, nr * fb,
                bar);
      off += rows_per_tile * fb;
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(stages, steps); ++i) issue(i);  // before x: under the acts launch
  }
  __syncthreads();

  for (int i = 0; i < steps; ++i) {
    const int t = i % tiles;
    const int m0 = i / tiles * m_slice, mrows = min(m_slice, M - m0);
    if (t == 0) {  // a pass begins: its image of x, by one bulk copy (the last
                   // tile's barrier freed the x region)
      const uint32_t xbar = bar0 + 8 * stages;
      if (tid == 0) {
        if (i == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the acts kernel's
        const int bytes = L.red - L.xq;
        mbar_arrive_tx(xbar, bytes);
        bulk_load(smem_u32(smem + L.xq), ws + size_t(i / tiles) * bytes, bytes, xbar);
      }
      mbar_wait(xbar, (i / tiles) & 1);
    }
    const int slot = i % stages;
    mbar_wait(bar0 + 8 * slot, (i / stages) & 1);
    const int r0 = f_begin + t * rows_per_tile, nr = min(rows_per_tile, f_end - r0);
    // the warp's rows of this tile: row0 + rstep * j for j < nrow
    const int nrow = min(R, max(0, (nr - row0 + rstep - 1) / rstep));
    float* red_i = red + (i & 1) * kGemvWarps * R * MT;
    if (nrow > 0) {
      const uint8_t* st = smem + slot * L.stage;
#pragma unroll 1
      for (int mc = 0; mc < MT; mc += MC) {
        float acc[N];  // acc[j * MC + mi]: lane-row j, row mc + mi of x
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = 0.f;
        for (int s = slice * 32 + lane; s < n_span; s += 32 * wpr) {
          typename Dec::Span sp[R];
#pragma unroll
          for (int j = 0; j < R; ++j)
            sp[j] = Dec::span_bytes(st, rows_per_tile, row0 + rstep * j, D, s, h);
#pragma unroll
          for (int k = 0; k < BANDS; ++k) {
            const int kb = k ^ (h / CH);  // the sub-block the lane takes k-th
            const int col = Dec::col(s, kb, D);
            int w[R][4 * CH];
            float sc[R], off[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
              Dec::band_codes(sp[j], k, w[j]);
              Dec::band_scale(st, rows_per_tile, row0 + rstep * j, D, s, kb, sc[j], off[j]);
            }
#pragma unroll
            for (int mi = 0; mi < MC; ++mi) {
              const int m = mc + mi;
              const int8_t* xr = xq_s + size_t(m) * D + col;
              int4 xv[CH];
#pragma unroll
              for (int c = 0; c < CH; ++c)
                xv[c] = *reinterpret_cast<const int4*>(xr + 16 * (c ^ (h % CH)));
              const float xs = xs_s[m * ngr + col / group];
              const float nsx = Dec::AFFINE ? nsx_s[m * nsub + col / SUB] : 0.f;
#pragma unroll
              for (int j = 0; j < R; ++j) {
                // P from the bits 0x4B400000 + P: 1.5 * 2^23 + P exactly
                int p = 0x4B400000;
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                  p = __dp4a(w[j][4 * c], xv[c].x, p);
                  p = __dp4a(w[j][4 * c + 1], xv[c].y, p);
                  p = __dp4a(w[j][4 * c + 2], xv[c].z, p);
                  p = __dp4a(w[j][4 * c + 3], xv[c].w, p);
                }
                // float(P) * a, rounded once (1.5 * 2^23 * a is exact: a
                // has 8 significant bits)
                const float pa = fmaf(__int_as_float(p), sc[j], -12582912.0f * sc[j]);
                float& a = acc[j * MC + mi];
                a = fmaf(xs, pa, a);
                if constexpr (Dec::AFFINE) a = fmaf(nsx, off[j], a);
              }
            }
          }
        }
        warp_sums(acc, lane);
        // lane l holds value l / (32 / N); the first of those lanes writes it
        const int idx = lane / (32 / N), j = idx / MC, m = mc + idx % MC;
        if (lane % (32 / N) == 0 && j < nrow && m < mrows)
          red_i[((row0 + rstep * j) * wpr + slice) * MT + m] = acc[0];
      }
    }
    __syncthreads();  // every warp is done with the stage and has its sums in red_i
    if (tid == 0 && i + stages < steps) issue(i + stages);
    for (int o = tid; o < nr * mrows; o += kGemvThreads) {  // a row's warps, in order
      const int m = o / nr, rr = o % nr;
      float v = red_i[rr * wpr * MT + m];
      for (int sl = 1; sl < wpr; ++sl) v += red_i[(rr * wpr + sl) * MT + m];
      store_f32(out, size_t(m0 + m) * F + r0 + rr, v, out_bf16);
    }
  }
}

// x quantized once into the workspace, then the GEMV as its programmatic
// dependent (its blocks start, and issue their weight copies, under the
// activations' kernel; griddepcontrol.wait holds the x image's copy)
template <class Dec, int MT>
cudaError_t gemv_launch_mt(const Dec& dec, const void* x, int x_bf16, void* out, int out_bf16,
                           int M, int D, int F, int group, int grid, int rows_per_block,
                           int rows_per_tile, int stages, int m_slice, const GemvLayout& L,
                           int8_t* xq_out, float* xs_out, uint8_t* ws, cudaStream_t stream) {
  // the tile: 8 / wpr rows of lane-row 0, R lane-rows (wpr warps a row)
  constexpr int R = Dec::ROWS(MT);
  if (rows_per_tile % R || (kGemvWarps * R) % rows_per_tile) return cudaErrorInvalidValue;
  static const cudaError_t opted = cudaFuncSetAttribute(
      gemv_kernel<Dec, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmemMax);
  if (opted != cudaSuccess) return opted;
  const int passes = (M + m_slice - 1) / m_slice;
  const int chunks = (D / group + kGemvWarps - 1) / kGemvWarps;
  gemv_acts_kernel<Dec><<<passes * MT * chunks, kGemvThreads, 0, stream>>>(
      x, x_bf16 != 0, ws, M, D, group, m_slice, xq_out, xs_out);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = size_t(L.total);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<Dec, MT>, dec, L, static_cast<const uint8_t*>(ws),
                            out, out_bf16 != 0, M, D, F, group, rows_per_block, rows_per_tile,
                            stages, m_slice);
}

// the host's plan (grid, rows_per_block, rows_per_tile, stages, m_slice and
// the shared memory it computed), checked against what the kernel takes
template <class Dec>
int gemv_launch(const Dec& dec, const void* x, int8_t* xq_out, float* xs_out, void* ws,
                void* out, int x_bf16, int out_bf16, int M, int D, int F, int group, int grid,
                int rows_per_block, int rows_per_tile, int stages, int m_slice, int smem,
                void* stream) {
  const bool pow2_group = group >= 16 && group <= 256 && (group & (group - 1)) == 0;
  if (ws == nullptr || M < 1 || M > kGemvMaxM || F < 1 || D < 256 || D % 256 || !pow2_group ||
      group % Dec::SUB || D % group || grid < 1 || rows_per_block < 1 || rows_per_tile < 1 ||
      stages < 1 || stages > kGemvMaxStages || m_slice < 1 || m_slice > M ||
      int64_t(grid) * rows_per_block < F || int64_t(grid - 1) * rows_per_block >= F)
    return int(cudaErrorInvalidValue);
  const GemvLayout L = gemv_layout<Dec>(D, group, rows_per_tile, stages, m_slice);
  if (L.total != smem || L.total > kGemvSmemMax) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = [&](auto mt) {
    return int(gemv_launch_mt<Dec, decltype(mt)::value>(dec, x, x_bf16, out, out_bf16, M, D, F,
                                                        group, grid, rows_per_block,
                                                        rows_per_tile, stages, m_slice, L, xq_out,
                                                        xs_out,
                                                        static_cast<uint8_t*>(ws), st));
  };
  switch (gemv_mt(m_slice)) {
    case 1: return a(std::integral_constant<int, 1>{});
    case 2: return a(std::integral_constant<int, 2>{});
    case 4: return a(std::integral_constant<int, 4>{});
    case 8: return a(std::integral_constant<int, 8>{});
    case 16: return a(std::integral_constant<int, 16>{});
    default: return a(std::integral_constant<int, 32>{});
  }
}

// A byte-code pack at a D the GEMV does not take (D % 256 != 0: a tp
// shard's D = 1056, Q8_0 at D = 2080, whose rows of scales are no multiple
// of 16 bytes and whose 64-column spans do not tile D) runs w8a8_kernel:
// the host, which routes by shape alone (ops/quant_matmul.py `gemv_takes`),
// then passes no workspace. Every other launch is the GEMV's.
template <class Dec>
int byte_launch(const Dec& dec, const void* x, int8_t* xq_out, float* xs_out, void* ws, void* out,
                int x_bf16, int out_bf16, int M, int D, int F, int group, int grid,
                int rows_per_block, int rows_per_tile, int stages, int m_slice, int smem,
                void* stream) {
  if (ws == nullptr)
    return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

}  // namespace

// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32. xq_out / xs_out may be null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dlp_w8a8_int8(const void* x, const void* qs, const void* gs, void* out,
                             int8_t* xq_out, float* xs_out, int x_bf16, int out_bf16, int M,
                             int D, int F, int group, void* stream) {
  const Int8 dec{static_cast<const int8_t*>(qs), static_cast<const float*>(gs), D, group};
  return launch(dec, x, xq_out, xs_out, out, x_bf16, out_bf16, M, D, F, group, stream);
}

// The persistent GEMV's entries take a workspace for the activations'
// images (ws, gemv_plan's ws_bytes; null only for a byte-code pack at a D
// the GEMV does not take, above) and the host's plan (ops/quant_matmul.py gemv_plan)
// after the shapes: grid, rows_per_block, rows_per_tile, stages, m_slice and
// smem, the shared memory bytes the plan computed (a launch whose smem
// differs from gemv_layout's is refused).
extern "C" int dlp_w8a8_q5_ks(const void* x, const void* q5n, const void* q5h, const void* a,
                              const void* b, void* out, int8_t* xq_out, float* xs_out, void* ws,
                              int x_bf16, int out_bf16, int M, int D, int F, int group,
                              int grid, int rows_per_block, int rows_per_tile, int stages,
                              int m_slice, int smem, void* stream) {
  const Q5KS dec{static_cast<const int8_t*>(q5n), static_cast<const int8_t*>(q5h),
                 static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), D};
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q2_ks(const void* x, const void* q2l, const void* a, const void* b,
                              void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                              int out_bf16, int M, int D, int F, int group, int grid,
                              int rows_per_block, int rows_per_tile, int stages, int m_slice,
                              int smem, void* stream) {
  const Q2KS dec{static_cast<const int8_t*>(q2l), static_cast<const __nv_bfloat16*>(a),
                 static_cast<const __nv_bfloat16*>(b), D};
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q4_k(const void* x, const void* qs, const void* a, const void* b,
                             void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                             int out_bf16, int M, int D, int F, int group, int grid,
                             int rows_per_block, int rows_per_tile, int stages, int m_slice,
                             int smem, void* stream) {
  const Q4K dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), D};
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q3_ks(const void* x, const void* q3l, const void* q3h, const void* s,
                              void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                              int out_bf16, int M, int D, int F, int group, int grid,
                              int rows_per_block, int rows_per_tile, int stages, int m_slice,
                              int smem, void* stream) {
  const Q3KS dec{static_cast<const int8_t*>(q3l), static_cast<const int8_t*>(q3h),
                 static_cast<const __nv_bfloat16*>(s), D};
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q6_k(const void* x, const void* ql, const void* qh, const void* s,
                             void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                             int out_bf16, int M, int D, int F, int group, int grid,
                             int rows_per_block, int rows_per_tile, int stages, int m_slice,
                             int smem, void* stream) {
  const Q6K dec{static_cast<const int8_t*>(ql), static_cast<const int8_t*>(qh),
                static_cast<const __nv_bfloat16*>(s), D};
  return gemv_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q8_0(const void* x, const void* qs, const void* scale, void* out,
                             int8_t* xq_out, float* xs_out, void* ws, int x_bf16, int out_bf16,
                             int M, int D, int F, int group, int grid, int rows_per_block,
                             int rows_per_tile, int stages, int m_slice, int smem, void* stream) {
  const Q8_0 dec{static_cast<const int8_t*>(qs), static_cast<const __nv_bfloat16*>(scale), D};
  return byte_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q4_k8(const void* x, const void* q4, const void* a, const void* b,
                              void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                              int out_bf16, int M, int D, int F, int group, int grid,
                              int rows_per_block, int rows_per_tile, int stages, int m_slice,
                              int smem, void* stream) {
  const Q4K8 dec{{static_cast<const int8_t*>(q4), static_cast<const __nv_bfloat16*>(a), D},
                 static_cast<const __nv_bfloat16*>(b)};
  return byte_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q5_k(const void* x, const void* q5, const void* a, const void* b,
                             void* out, int8_t* xq_out, float* xs_out, void* ws, int x_bf16,
                             int out_bf16, int M, int D, int F, int group, int grid,
                             int rows_per_block, int rows_per_tile, int stages, int m_slice,
                             int smem, void* stream) {
  const Q5K dec{{static_cast<const int8_t*>(q5), static_cast<const __nv_bfloat16*>(a), D},
                static_cast<const __nv_bfloat16*>(b)};
  return byte_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}

extern "C" int dlp_w8a8_q6_k8(const void* x, const void* q6, const void* s, void* out,
                              int8_t* xq_out, float* xs_out, void* ws, int x_bf16, int out_bf16,
                              int M, int D, int F, int group, int grid, int rows_per_block,
                              int rows_per_tile, int stages, int m_slice, int smem, void* stream) {
  const Q6K8 dec{static_cast<const int8_t*>(q6), static_cast<const __nv_bfloat16*>(s), D};
  return byte_launch(dec, x, xq_out, xs_out, ws, out, x_bf16, out_bf16, M, D, F, group, grid,
                     rows_per_block, rows_per_tile, stages, m_slice, smem, stream);
}
