#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and exits non-zero, nothing is swallowed:

1. The card: its name and power limit (as nvidia-smi prints them) and the
   torch/CUDA versions. TF32 is switched off for matmuls and cuDNN, so f32
   products are full f32.
2. Build: every kernel source of the paths (``cuda_build.SOURCES``) with
   nvcc for sm_90a, one process per source, all started together. The
   split-KV kernels, the fused-dequant GEMM (``kgemm_kernel``), the int8
   GEMM (``int8_gemm_kernel``) and the persistent W8A8 GEMV
   (``gemv_kernel``) print their ptxas reports and may not spill; the GEMV
   has instantiations of every pack kind's decoder, and ``w8a8_kernel``
   none of Q4_K's or Q3_KS's.
3. Kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the main path's shapes and the contract's corner cases. For
   flash_attention: GQA and MHA, T=1 and T>1, per-row cache lengths, a
   ragged KV tail, window + softcap + scale, int8 KV. For
   paged_flash_attention: decode over per-row lengths, rows sharing
   physical blocks, a mixed step with a parked row, a prefill into fresh
   blocks, int8 pools, gemma2-9b geometry, block size 16. For
   latent_flash_attention (absorbed queries of all heads against one
   [N, bs, 1, r] latent stream per row): r = 128 and 512 at Llama-3.2-1B,
   a B = 4 decode step and a 64-lane mixed step, bf16 and q8_0 pools, and
   gemma2-9b geometry (H 16, r 512, softcap, window); flash_attention also
   at head dim r (a latent prefill at 128, a decode at 512). For
   fused_decode_attn (one layer's whole decode attention half): Llama-3.2-1B
   at B = 1 and 4 with 512 cached, dense or q8_0 weights × bf16 or q8_0
   pools, and llama3-8b geometry (Hd 128) with half rope, a window and
   per-row lengths; x is drawn at 0.01 so that y is the attention half, and
   y is held to 4 bf16 ulp of its largest value, k_new / v_new to one; the
   served unfused attention half is held to the plain version too (4 ulp,
   8 over W8A8's q8_0 weights) and timed beside it; each case relaunches
   for the same bits and prints its plan (CTAs a kv head, CTAs, the
   clusters the card holds at once), and any spill of the kernel's 18
   instantiations fails the run. Four more cases at the largest batches
   that fuse (f32 Llama-3.2-1B at 20 and 22 rows, f32 llama3-8b at 9, bf16
   Llama-3.2-1B with q8_0 weights at 39), whose plans put the key tiles in
   the ring's place, some with one-row ring tiles, are held to the plain
   version (f32 within ``FUSED_F32_REL`` of the largest |value|) and
   relaunched for the same bits.
   One JSON line per case: the max abs error and its tolerance, the
   kernel's (cold and warm L2), the plain version's and the library call's
   time, and the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, whichever is larger). The three split-KV
   kernels (flash_attention over the dense cache, paged and latent) also
   print each case's split plan, grid and the split and merge kernels' µs,
   relaunch once with host syncs turned into errors for the same bits, and
   hold the share of outputs over half a bf16 ulp from the plain version
   in f32; their decode cases launch at least one block per SM, and a few
   f32 cases of each are held at ``SPLIT_F32_TOL``. The quantized matmul kernels (W8A8 over
   Q8_0, Q6_K, Q4_K, Q5_KS, Q2_KS and Q3_KS packs, fused dequant over Q8_0,
   Q6_K, Q4_K and Q5_K packs, int8 over int8 packs, of random codes, scales and
   offsets) run at Llama-3.2-1B's five (D, F) pairs, the head's with f32
   output: W8A8 at M = 1, 4, 16, 32, fused dequant at M = 33, 256, 512, int8
   at all seven; plus an odd F, activation groups 32 and 128 and an
   all-zero activation row. The byte-code packs of tp meshes (Q5_K, Q4_K8,
   Q6_K8) run at the tp = 2 shard shapes of the same model (and the whole
   head, at M = 1 and 4 only): their W8A8 forms at M = 1, 4, 16, 32 and
   ``q5_k_matmul`` (held
   against ``q5_k_matmul_plain``) at M = 33, 64, 256, 512, plus a D that
   only 32 divides. The W8A8 and int8 kernels' own quantized
   activations must equal ``quantize_acts`` bit for bit. Their yardstick is
   ``F.linear`` on the dense bf16 weight the pack represents (and, for int8
   at M >= 256, ``torch._int_mm`` on the same int8 operands, which applies
   no scales), and their bound counts int8 operations at 1979 TOP/s. Q5_KS,
   Q2_KS and Q3_KS at M > 32 run no kernel (dequant, then ``F.linear``, as
   the reference's einsum): that route is timed once each. The Q4_K, Q6_K,
   Q5_K and Q8_0 GEMM's cases also print their split plan and grid and
   relaunch once with host syncs turned into errors, for the same bits, and
   so do the W8A8 cases of the persistent GEMV (``qm.gemv_takes``: Q6_K,
   Q4_K, Q5_KS, Q2_KS, Q3_KS, Q8_0 and the byte codes at D % 256 == 0; the
   byte codes' other D, the group-32 edges D = 2080 and 1056, and int8 run
   ``w8a8_kernel``), which print their
   ``gemv_plan`` (grid, rows a block, tile, stages, rows of x a pass; the
   library refuses a launch whose shared memory is not the plan's); the
   int8 GEMM's cases (M > 4) print their plan, grid and tiling, must equal
   ``int8_matmul_plain`` bit for bit, relaunch the same way, and at M >=
   256 print the quantize and GEMM launches' µs apart. x = I (M = D = 2048)
   through all five must give the plain version's f32 output bit for bit
   (the Q8_0 and int8 packs holding every byte value, -128 included); and
   a view of x one bf16 past a 16-byte boundary (and a pack field so
   placed) must make ``dequant_matmul`` (Q4_K and Q8_0), ``w8a8_matmul``
   and ``int8_matmul`` raise ValueError, as a misaligned q must make
   ``flash_attention``, the CUDA context still usable after.
4. Serve, single stream: a GGUF of Llama-3.2-1B geometry (bf16 weights
   random from --seed, a synthetic 128256-token SPM vocab) goes through the
   port's Engine, which first runs the three requests once directly (the
   first request after boot pays lazy kernel loading). Then the port's
   ChatServer, on a free localhost port, answers the same three as POST
   /chat (one greedy, two sampled). The SSE events are checked, TTFT and
   decode tok/s printed, and the attention kernel must have launched
   exactly n_layers times per model forward. A profiled decode step at 512
   cached tokens then gives wall and device time per step, the device's busy
   share and the top kernels.
5. Serve, slots: ChatServer(parallel=4) over the same engine answers four
   concurrent POST /chat: two greedy requests sharing a ~480-token prefix
   (the second sent once the first streams, so it finds the prefix in the
   pool), a ~1000-token prompt fed through chunked-prefill mixed steps
   while the others decode, and a short sampled one. Every stream must end
   in its done summary, the pool must have served a prefix hit and a mixed
   step, and the paged kernel must have launched exactly n_layers times per
   paged forward. Per-request TTFT, per-stream and aggregate decode tok/s,
   and a profiled B=4 paged decode step are printed.
6. Logits: one 512-token prefill and four decode steps with the kernel and
   with the plain attention on the card: max abs logit error within a bf16
   tolerance and the same argmax. Then the same prompt through the paged
   forward on the pool against the dense forward, held the same way.
7. Serve quantized: a Q6_K GGUF of the same geometry (projections and
   token_embd in Q6_K, norms in F32) served with ``Engine(quant="native")``
   through ChatServer with the phase-4 requests, and the bf16 GGUF served
   with ``Engine(quant="q8_0")`` through ChatServer(parallel=4) with the
   phase-5 requests. Each packed projection must launch exactly one quant
   kernel per forward, W8A8 where the forward's M = B·T ≤ 32 and fused
   dequant above (7 × 16 per forward, +1 for a packed head, which sees M =
   B). Load and pack times, TTFT, decode tok/s and a profiled quantized
   decode step are printed; then each engine's logits with the kernels
   against the plain versions, held as in phase 6.
8. Serve Q4_K and Q5_K: a GGUF with llama.cpp's Q4_K_M assignment (attn_v
   and ffn_down in Q6_K on the ``use_more_bits`` layers, the other
   projections in Q4_K, token_embd in Q6_K) served with
   ``Engine(quant="native")`` single-stream (its mixed attn_v and ffn_down
   stacks load dense, as in the reference), and a bf16 GGUF of 8 of the
   model's 16 layers (the widths unchanged: the cut keeps the whole run
   under 900 s) with ``Engine(quant="q5_k")`` on 4 slots, held and printed
   as phase 7. Q5_KS forwards of M > 32 count their dequant + F.linear
   calls in place of a kernel launch.
9. Serve int8, Q3_K and Q2_K, at 8 of the model's 16 layers (the widths
   unchanged; the cut keeps the whole run under 900 s): a bf16 GGUF with
   ``Engine(quant="int8")``
   single-stream (the int8 kernel at every M: its GEMM at the 512 prefill
   bucket, the W8A8 route at decode), a Q3_K GGUF (projections in Q3_K,
   token_embd in Q6_K, norms F32) with ``Engine(quant="native")``
   single-stream, and the bf16 GGUF with ``Engine(quant="q2_k")`` on 4
   slots, held and printed as phase 7.
10. ``--kv-quant q8_0``, fused decode and latent KV over the bf16 GGUF:
   ``Engine(kv_quant="q8_0")`` single-stream (the phase-4 requests; its
   int8 cache through flash_attention); ``DLP_FUSED_DECODE=1`` with
   ChatServer(parallel=4) (the phase-5 requests) on bf16 weights and pools,
   then on ``quant="q8_0"`` weights with ``kv_quant="q8_0"`` pools: every
   T = 1 decode forward launches fused_decode_attn once per layer (one
   launch: the cross-head sum is a last-block reduction) and no paged
   attention, logits fused against unfused, a profiled fused decode step;
   ``DLP_KV_LATENT=1`` at the default rank 128, single-stream (flash_attention
   at head dim r) and on 4 slots over q8_0 latent pools
   (latent_flash_attention once per layer and paged forward), logits
   kernel against plain; then full rank (512) against the dense engine.
   Each logit comparison of this phase is held over four prompts.
11. The mesh (``parallel/``): ``ShardedEngine`` runs every rank as a
   process of its own on this one card, its collectives on gloo through
   host memory. ``--mesh 2x2`` over the bf16 GGUF answers the phase-4
   requests through ChatServer; ``--mesh 1x2 --parallel 4 --quant q5_k``
   over the 8-layer bf16 GGUF the phase-5 requests (its mixed steps are 4
   x 16 = 64 lanes:
   q5_k_matmul; decode the q5_k W8A8 form); ``--mesh 1x2 --quant native``
   over the Q4_K_M GGUF (its Q4_K stacks as q4_k8 byte codes; its mixed
   attn_v / ffn_down stacks load dense) and over the Q6_K GGUF (q6_k8), one
   stream each. Every rank's launches are held to its chunk forwards
   (flash_attention once per local layer, each packed projection once, by
   route), a decode step is profiled per rank (device time, busy share,
   time in collectives), on slots rank 0 is traced through the serve for
   its quantized GEMM's device time a mixed step, and the logits of a 512-token prefill and four
   decode steps, over four prompts, are held against the single-device
   engine's of phases 6-8 prefilling the same way, in chunks of 16 tokens
   (``MESH_LOGIT_TOL`` in bf16, ``QUANT_LOGIT_TOL`` quantized); the gap to its
   one-shot prefill is printed beside, for the mesh and for the
   single-device engine's own chunked run. Requests generate 16 tokens
   here.
12. The llama-server / OpenAI routes, run between phases 6 and 7 on the
   engine of phases 4-5 (no model is loaded for them): /apply-template
   renders the chat prompt, /chat answers it greedy, and
   /v1/chat/completions, whole and streamed, must give the same text.
   /completion with n_probs 5 and a streamed /v1/completions with
   logprobs 5 must give, for each greedy token, top logprobs that are
   sorted and <= 0 with the token on top; a /completion that bans the
   first eight distinct greedy tokens (logit_bias false) may not generate
   any of them; a sampled typical_p 0.9 and a mirostat 2 request end in
   their done summary, and mirostat's μ is finite. flash_attention must
   launch n_layers times per forward of these requests. Then
   ChatServer(parallel=4) answers two logprob requests beside the biased
   one, all at once, held the same way, with paged_flash_attention at
   n_layers launches per paged forward. Each route prints its client-side
   TTFT (streamed) and tok/s with the card.
13. The total wall time, the kernels line (one JSON object), the card line,
   and last the ok line. Each phase, and each served path of phases 7-9
   and 11, prints its seconds on a line of its own as it ends.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor-core peak
INT8_OP_S = 1979e12          # H100 SXM dense int8 tensor-core peak
KERNEL_TOL = 2e-2            # bf16 output: a few ulp of values of order 1
LOGIT_TOL = 0.1              # bf16 model, 16 layers: logits of std ~1
# quantized engines: a one-ulp bf16 difference in front of the int8
# activation quantizer moves x / xs by up to half a code, so kernel and plain
# runs drift further apart through 16 layers (0.31 measured on the H100)
QUANT_LOGIT_TOL = 0.5
# phase 10's comparisons over bf16 weights each add a rounding a layer to
# the kernel-against-plain drift LOGIT_TOL holds: the fused step keeps
# attention, the O-projection and the residual sum in f32 where the unfused
# one rounds each to bf16; a latent engine rounds its attention output in
# latent space, where one ulp is wider after the unprojection; an int8 KV
# cache moves a code (1/127 of the vector's amax) where a bf16 one moves an
# ulp. Measured on the H100 over four prompts: 0.085-0.106 fused, 0.093-0.114
# latent, 0.085-0.101 int8 KV, 0.103-0.111 q8_0 latent pools
KV_MODE_LOGIT_TOL = 0.15
# fused against unfused over q8_0 weights: the unfused attention half runs
# its four projections W8A8 (h and the attention output quantized to 127
# levels a row) where the fused kernel multiplies the dequantized weights,
# noise on one side only on top of the drift QUANT_LOGIT_TOL holds (0.367-
# 0.450 over four prompts on the H100)
FUSED_QUANT_LOGIT_TOL = 0.6
# phase 11 holds a bf16 mesh against the single-device engine prefilled in
# chunks of 16, as the mesh prefills: the tp split still reorders every
# projection's sums (other GEMM shapes, row-parallel partial sums), one
# more rounding order a layer, the drift phase 10's KV_MODE_LOGIT_TOL holds.
# Measured on the H100 over four prompts: --mesh 2x2 0.090-0.103, beside the
# single-device engine's own chunked against one-shot prefill 0.084-0.103
MESH_LOGIT_TOL = 0.15
# phases 10 and 11 hold each logit comparison over this many prompts (seeds
# --seed, --seed + 1, ...): one prompt's reading says little of the margin
LOGIT_PROMPTS = 4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps: int, flush: torch.Tensor | None) -> float:
    """Median device time of one call, the L2 flushed before each unless
    ``flush`` is None (the served path streams the whole model between two
    calls on one layer, so it finds the L2 cold). A spin kernel ahead of
    the start event keeps the card busy while the host enqueues the call,
    so the host's own time per call is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)   # ~1 ms of spinning at H100 clocks
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# the kernels split_kernel_us reports, by a piece of their names: the
# split-KV kernel and its merge, or int8_matmul's quantize and GEMM launches
SPLIT_KERNELS = {"split_kernel": "split_kernel", "combine_kernel": "combine_kernel"}
INT8_KERNELS = {"quantize_kernel": "quantize_us", "int8_gemm_kernel": "gemm_us"}


def split_kernel_us(fn, reps: int, flush: torch.Tensor,
                    kernels: dict[str, str] = SPLIT_KERNELS) -> dict[str, float]:
    """Device µs per call of each kernel ``fn`` launches whose name holds a
    key of ``kernels`` (reported under its value): by default the split-KV
    kernel and, where it runs, the merge. From torch.profiler over ``reps``
    calls with the L2 flushed before each (the flush is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for piece, name in kernels.items():
            if piece in e.name:
                us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return us


def host_us(fn, reps: int = 200) -> float:
    """Mean host time to enqueue one call (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)      # keep the card busy: nothing blocks
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


# --------------------------------------------------------------------------
# phase 3: flash_attention against its plain version

ATTN_CASES = [
    # Llama-3.2-1B geometry (H=32, K=8, Hd=64): the served path's shapes
    dict(name="prefill", B=1, T=512, S=2048, H=32, K=8, Hd=64, cache_len=0),
    dict(name="decode", B=1, T=1, S=2048, H=32, K=8, Hd=64, cache_len=1000),
    dict(name="decode_per_row", B=4, T=1, S=2048, H=32, K=8, Hd=64,
         cache_len=[1000, 37, 1500, 2047]),
    dict(name="chunk_ragged_tail", B=1, T=100, S=2000, H=32, K=8, Hd=64,
         cache_len=700),
    dict(name="mha_n_rep_1", B=1, T=64, S=1024, H=32, K=32, Hd=64, cache_len=200),
    dict(name="int8_decode", B=1, T=1, S=2048, H=32, K=8, Hd=64, cache_len=1000,
         quant=True),
    dict(name="int8_window_per_row", B=2, T=64, S=2048, H=32, K=8, Hd=64,
         cache_len=[300, 1500], window=256, quant=True),
    # gemma2-9b geometry: window, softcap and explicit scale, Hd=256
    dict(name="gemma2_window_softcap", B=1, T=128, S=5000, H=16, K=8, Hd=256,
         cache_len=4500, window=4096, softcap=50.0, scale=256 ** -0.5),
    # llama3-8b geometry: Hd=128
    dict(name="llama3_8b_hd128", B=1, T=256, S=4096, H=32, K=8, Hd=128,
         cache_len=1024),
    # the single-stream latent path at Llama-3.2-1B: absorbed queries of all
    # 32 heads against one [S, 1, r] latent stream at the head-dim scale, a
    # 512 prefill at the default rank 128 and a decode step at full rank 512
    dict(name="latent_r128_prefill", B=1, T=512, S=2048, H=32, K=1, Hd=128,
         cache_len=0, scale=64 ** -0.5),
    dict(name="latent_r512_decode", B=1, T=1, S=2048, H=32, K=1, Hd=512,
         cache_len=1000, scale=64 ** -0.5),
]


def attn_bound(c: dict) -> tuple[float, str]:
    """Least time for the work these inputs need: Q and O once, the live K/V
    columns (the union of what the rows attend) once; 4·Hd operations per
    head per visible (query, key) pair."""
    B, T, S, H, K, Hd = (c[k] for k in ("B", "T", "S", "H", "K", "Hd"))
    lens = c["cache_len"] if isinstance(c["cache_len"], list) else [c["cache_len"]] * B
    window, quant = c.get("window", 0), c.get("quant", False)
    col_bytes = 2 * K * Hd * (1 if quant else 2) + (2 * K * 4 if quant else 0)
    n_bytes = 2 * B * T * H * Hd * 2
    flops = 0
    for cl in lens:
        lo = max(0, cl - window + 1) if window else 0
        n_bytes += (min(S, cl + T) - lo) * col_bytes
        for t in range(T):
            pos = cl + t
            first = max(0, pos - window + 1) if window else 0
            flops += 4 * H * Hd * (min(pos, S - 1) - first + 1)
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the dense cases a one-stream decode step runs: each launches at least one
# block per SM
DENSE_DECODE_CASES = ("decode", "decode_per_row", "int8_decode", "latent_r512_decode")
# the dense kernel's f32 instantiations, held as the split-KV ones are
DENSE_F32_CASES = ("decode_per_row", "int8_window_per_row", "gemma2_window_softcap")


def attn_inputs(c: dict, kv_quantize, gen: torch.Generator, dtype=torch.bfloat16):
    """q, k, v (int8 codes with their scales for a quant case), cache_len
    (an int, or an int32 tensor for a per-row case) and the call's keywords."""
    B, T, S, H, K, Hd = (c[k] for k in ("B", "T", "S", "H", "K", "Hd"))
    q = torch.randn(B, T, H, Hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, K, Hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, K, Hd, generator=gen, device="cuda").to(dtype)
    ks = vs = None
    if c.get("quant"):
        (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
    cl = c["cache_len"]
    cache_len = torch.tensor(cl, dtype=torch.int32, device="cuda") \
        if isinstance(cl, list) else cl
    kw = dict(scale=c.get("scale", 0.0), softcap=c.get("softcap", 0.0),
              window=c.get("window", 0), k_scale=ks, v_scale=vs)
    return q, k, v, cache_len, kw


def check_attention(fa, pa, kv_quantize, seed: int, flush: torch.Tensor) -> list[dict]:
    """The dense cache's kernel against its plain version, one JSON line per
    case with the launch's split plan (from the library's tiling), grid and
    the split and merge kernels' µs. A second launch made with host syncs
    turned into errors must give the same bits; the share of outputs more
    than half a bf16 ulp from the plain version in f32 must stay within
    ``PV_HALF_ULP_TOL``; the decode cases launch at least one block per SM.
    Then the f32 instantiations of ``DENSE_F32_CASES`` at
    ``SPLIT_F32_TOL``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = pa.sm_count(torch.cuda.current_device())
    rows = []
    for c in ATTN_CASES:
        B, T, S, H, K, Hd = (c[k] for k in ("B", "T", "S", "H", "K", "Hd"))
        q, k, v, cache_len, kw = attn_inputs(c, kv_quantize, gen)
        cl = c["cache_len"]
        n_rep = H // K
        got = fa.flash_attention(q, k, v, cache_len, n_rep, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = fa.flash_attention(q, k, v, cache_len, n_rep, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not torch.equal(got, again):
            fail(f"flash_attention case {c['name']}: two launches on the same inputs differ")
        ref = fa.flash_attention_plain(q, k, v, cache_len, n_rep, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(got.float()).all()):
            fail(f"flash_attention case {c['name']}: max abs err {err} > {KERNEL_TOL}")
        # the same bf16 values in f32 (int8 codes dequantized and rounded to
        # bf16, as the kernel rounds them)
        k32, v32 = ((x.float() * sc).bfloat16().float() if sc is not None else x.float()
                    for x, sc in ((k, kw["k_scale"]), (v, kw["v_scale"])))
        ref32 = fa.flash_attention_plain(q.float(), k32, v32, cache_len, n_rep,
                                         scale=kw["scale"], softcap=kw["softcap"],
                                         window=kw["window"])
        share = half_ulp_share(got, ref32)
        if share > PV_HALF_ULP_TOL:
            fail(f"flash_attention case {c['name']}: {share} of outputs over half a bf16 "
                 f"ulp from the f32 plain version > {PV_HALF_ULP_TOL}")
        plan = fa.dense_plan(B, T, H, K, S, pa.tile_geometry("flash_attention", Hd), sms)
        grid = [plan.q_tiles, plan.splits, B * K]
        blocks = grid[0] * grid[1] * grid[2]
        if c["name"] in DENSE_DECODE_CASES and blocks < sms:
            fail(f"flash_attention case {c['name']}: {blocks} blocks < {sms} SMs")
        library_ms = None
        if not c.get("quant") and not c.get("softcap"):
            # the same function as one PyTorch call: SDPA with the mask
            lens = torch.as_tensor(cl, device="cuda").reshape(-1, 1, 1)
            qpos = lens + torch.arange(T, device="cuda")[None, :, None]
            kpos = torch.arange(S, device="cuda")[None, None, :]
            mask = kpos <= qpos
            if kw["window"]:
                mask &= qpos - kpos < kw["window"]
            mask = mask.expand(B, T, S)[:, None]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"] or None,
                enable_gqa=n_rep > 1).transpose(1, 2)
            lib_err = (lib.float() - ref.float()).abs().max().item()
            if lib_err > KERNEL_TOL:
                fail(f"SDPA yardstick disagrees on {c['name']}: {lib_err}")
            library_ms = event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"] or None,
                enable_gqa=n_rep > 1), 20, flush)
        bound_ms, bound_by = attn_bound(c)

        def kernel():
            return fa.flash_attention(q, k, v, cache_len, n_rep, **kw)

        row = {"case": c["name"], "kernel": "flash_attention",
               "shape": {k: c[k] for k in c if k != "name"},
               "plan": plan._asdict(), "grid": grid, "blocks": blocks,
               "threads": 32 * plan.warps, "bit_equal_relaunch": True,
               "max_abs_err": err, "tol": KERNEL_TOL,
               "over_half_ulp_f32": share,
               "mean_abs_err_f32": (got.float() - ref32).abs().mean().item(),
               "half_ulp_tol": PV_HALF_ULP_TOL,
               "kernel_ms": event_ms(kernel, 50, flush),
               "kernel_warm_l2_ms": event_ms(kernel, 50, None),
               "device_us": split_kernel_us(kernel, 20, flush),
               "kernel_host_us": host_us(kernel),
               "plain_ms": event_ms(lambda: fa.flash_attention_plain(
                   q, k, v, cache_len, n_rep, **kw), 10, flush),
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
    cases = {c["name"]: c for c in ATTN_CASES}
    for name in DENSE_F32_CASES:
        c = cases[name]
        q, k, v, cache_len, kw = attn_inputs(c, kv_quantize, gen, torch.float32)
        args = (q, k, v, cache_len, c["H"] // c["K"])
        got = fa.flash_attention(*args, **kw)
        torch.cuda.synchronize()
        err = (got - fa.flash_attention_plain(*args, **kw)).abs().max().item()
        if not (err <= SPLIT_F32_TOL and torch.isfinite(got).all()):
            fail(f"flash_attention f32 case {name}: max abs err {err} > {SPLIT_F32_TOL}")
        print(json.dumps({"f32_case": name, "kernel": "flash_attention",
                          "max_abs_err": err, "tol": SPLIT_F32_TOL}), flush=True)
    return rows


# --------------------------------------------------------------------------
# phase 3: paged_flash_attention against its plain version

# Llama-3.2-1B geometry (H=32, K=8, Hd=64) over the serving pool's default
# geometry (bs=64 at max_seq 2048, so NT=32) unless noted
PAGED_CASES = [
    dict(name="decode_per_row", B=4, T=1, lengths=[1000, 37, 1500, 2047]),
    dict(name="decode_shared_prefix", B=4, T=1, lengths=[1000, 37, 1500, 2047],
         shared=8),
    # the mixed step of chunked prefill: T = prefill_chunk lanes per row;
    # row 3 is parked at max_seq (a free slot) and maps no block
    dict(name="mixed_step_parked", B=4, T=64, lengths=[448, 900, 1300, 2048],
         parked=3),
    dict(name="prefill_fresh_blocks", B=1, T=512, lengths=[0]),
    dict(name="int8_decode", B=4, T=1, lengths=[1000, 37, 1500, 2047],
         quant=True),
    # gemma2-9b geometry: window, softcap and explicit scale, Hd=256, bs=32
    dict(name="gemma2_window_softcap", B=2, T=1, lengths=[4500, 300], H=16,
         Hd=256, bs=32, max_seq=5120, window=4096, softcap=50.0,
         scale=256 ** -0.5),
    dict(name="block_size_16", B=4, T=1, lengths=[1000, 37, 1500, 2047], bs=16),
    # one long row: the step split-KV serves most (one stream's decode)
    dict(name="decode_single_long", B=1, T=1, lengths=[2047]),
]
# the timed decode cases each launch at least one block per SM
SPLIT_DECODE_CASES = ("decode_per_row", "decode_single_long", "r128_decode",
                      "r128_decode_single_long")


def paged_geometry(c: dict) -> dict:
    g = dict(H=32, K=8, Hd=64, bs=64, max_seq=2048, window=0, softcap=0.0,
             scale=0.0, quant=False, shared=0, parked=None)
    g.update(c)
    g["NT"] = -(-g["max_seq"] // g["bs"])
    return g


def paged_inputs(g: dict, gen: torch.Generator) -> dict:
    """Pools, tables and lengths for a case: each row maps the blocks its
    columns need to distinct physical blocks in shuffled order; the rest
    of its table is 0 (the sentinel). ``shared`` makes rows 0 and 1 name
    the same first blocks; the ``parked`` row maps nothing."""
    B, T, K, Hd, bs, NT = (g[k] for k in ("B", "T", "K", "Hd", "bs", "NT"))
    need = [0 if b == g["parked"] else min(NT, -(-(g["lengths"][b] + T) // bs))
            for b in range(B)]
    N = 1 + sum(need)
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(1)) + 1).tolist()
    tables = torch.zeros(B, NT, dtype=torch.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = perm.pop()
    if g["shared"]:
        tables[1, :g["shared"]] = tables[0, :g["shared"]]
    q = torch.randn(B, T, g["H"], Hd, generator=gen, device="cuda").bfloat16()
    kp = torch.randn(N, bs, K, Hd, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(N, bs, K, Hd, generator=gen, device="cuda").bfloat16()
    return dict(q=q, kp=kp, vp=vp, tables=tables.cuda(),
                lengths=torch.tensor(g["lengths"], dtype=torch.int32, device="cuda"))


def paged_bound(g: dict, tables: torch.Tensor) -> tuple[float, str]:
    """Least time for the work these inputs need: Q and O once, and once
    each physical K/V column (with its scales) that some row's mask
    reaches, so the columns of a shared prefix count once; 4·Hd operations
    per head per visible (query, column) pair."""
    B, T, H, K, Hd, bs, NT = (g[k] for k in ("B", "T", "H", "K", "Hd", "bs", "NT"))
    window, S = g["window"], NT * bs
    col_bytes = 2 * K * Hd * (1 if g["quant"] else 2) + (2 * K * 4 if g["quant"] else 0)
    tbl = tables.tolist()
    cols, flops = set(), 0
    for b, cl in enumerate(g["lengths"]):
        lo = max(0, cl - window + 1) if window else 0
        cols.update(tbl[b][c // bs] * bs + c % bs for c in range(lo, min(S, cl + T)))
        for t in range(T):
            pos = cl + t
            first = max(0, pos - window + 1) if window else 0
            flops += 4 * H * Hd * (min(pos, S - 1) - first + 1)
    n_bytes = 2 * B * T * H * Hd * 2 + len(cols) * col_bytes
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# P.V keeps P in f32 as two bf16 terms (hi + lo): against the plain version
# computed in f32 from the same bf16 inputs, the share of outputs more than
# half a bf16 ulp off read 0.0005-0.0023 over phase 3's bf16 cases; a build
# with the lo term dropped (P rounded to bf16) read 0.150-0.383 (PERF.md)
PV_HALF_ULP_TOL = 0.02


def half_ulp_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of ``got``'s values more than half a bf16 ulp from the f32
    ``ref``: 0 where ``got`` is ``ref`` rounded to bf16."""
    _, e = torch.frexp(ref)
    ulp = torch.exp2((e - 8).float())
    return ((got.float() - ref).abs() > 0.5 * ulp).float().mean().item()


def check_paged(pa, kv_quantize, seed: int, flush: torch.Tensor) -> list[dict]:
    return check_paged_cases(pa.paged_flash_attention, pa.paged_attention_plain,
                             "paged_flash_attention", "paged_attention",
                             PAGED_CASES, pa, kv_quantize, seed, flush)


def check_paged_cases(kernel, plain, kname: str, lib: str, cases: list[dict], pa,
                      kv_quantize, seed: int, flush: torch.Tensor) -> list[dict]:
    """Attention over pools through block tables, kernel against plain
    version, one JSON line per case (the paged kernel, and the latent kernel
    over [N, bs, 1, r] pools with every head reading them), with the launch's
    split plan (from library ``lib``'s tiling) and grid. A second launch on
    the same inputs, made with host syncs turned into errors, must give the
    same bits; the share of outputs more than half a bf16 ulp from the plain
    version in f32 must stay within ``PV_HALF_ULP_TOL``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = pa.sm_count(torch.cuda.current_device())
    rows = []
    for c in cases:
        g = paged_geometry(c)
        x = paged_inputs(g, gen)
        q, kp, vp, tables, lengths = (x[k] for k in ("q", "kp", "vp", "tables",
                                                      "lengths"))
        ks = vs = None
        if g["quant"]:
            (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        n_rep = g["H"] // g["K"]
        kw = dict(scale=g["scale"], softcap=g["softcap"], window=g["window"],
                  k_scale=ks, v_scale=vs)
        args = (q, kp, vp, tables, lengths, n_rep)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = kernel(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not torch.equal(got, again):
            fail(f"{kname} case {c['name']}: two launches on the same inputs differ")
        ref = plain(*args, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(got.float()).all()):
            fail(f"{kname} case {c['name']}: max abs err {err} > {KERNEL_TOL}")
        # the same bf16 values in f32 (int8 codes dequantized and rounded to
        # bf16, as the kernel rounds them)
        k32, v32 = ((x.float() * sc).bfloat16().float() if sc is not None else x.float()
                    for x, sc in ((kp, ks), (vp, vs)))
        ref32 = plain(q.float(), k32, v32, tables, lengths, n_rep, scale=g["scale"],
                      softcap=g["softcap"], window=g["window"])
        share = half_ulp_share(got, ref32)
        if share > PV_HALF_ULP_TOL:
            fail(f"{kname} case {c['name']}: {share} of outputs over half a bf16 "
                 f"ulp from the f32 plain version > {PV_HALF_ULP_TOL}")
        plan = pa.split_plan(g["B"], g["T"], g["H"], g["K"], g["NT"], g["bs"],
                             pa.tile_geometry(lib, g["Hd"]), sms)
        grid = [plan.q_tiles, plan.splits, g["B"] * g["K"]]
        blocks = grid[0] * grid[1] * grid[2]
        if c["name"] in SPLIT_DECODE_CASES and blocks < sms:
            fail(f"{kname} case {c['name']}: {blocks} blocks < {sms} SMs")
        library_ms = None
        if not g["quant"] and not g["softcap"]:
            # the yardstick: SDPA over the window gathered beforehand (the
            # gather is not timed); the port never calls it
            B, T, S = g["B"], g["T"], g["NT"] * g["bs"]
            kt = pa.gather_paged_kv(kp, tables).transpose(1, 2)
            vt = pa.gather_paged_kv(vp, tables).transpose(1, 2)
            qpos = lengths.reshape(-1, 1, 1) + torch.arange(T, device="cuda")[None, :, None]
            kpos = torch.arange(S, device="cuda")[None, None, :]
            mask = kpos <= qpos
            if g["window"]:
                mask &= qpos - kpos < g["window"]
            mask = mask[:, None]
            qt = q.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=g["scale"] or None,
                    enable_gqa=n_rep > 1)

            lib_err = (sdpa().transpose(1, 2).float() - ref.float()).abs().max().item()
            if lib_err > KERNEL_TOL:
                fail(f"SDPA yardstick disagrees on {c['name']}: {lib_err}")
            library_ms = event_ms(sdpa, 20, flush)
        bound_ms, bound_by = paged_bound(g, tables)
        row = {"case": c["name"], "kernel": kname,
               "shape": {k: c[k] for k in c if k != "name"},
               "plan": plan._asdict(), "grid": grid, "blocks": blocks,
               "threads": 32 * plan.warps, "bit_equal_relaunch": True,
               "max_abs_err": err, "tol": KERNEL_TOL,
               "over_half_ulp_f32": share,
               "mean_abs_err_f32": (got.float() - ref32).abs().mean().item(),
               "half_ulp_tol": PV_HALF_ULP_TOL,
               "kernel_ms": event_ms(lambda: kernel(*args, **kw), 50, flush),
               "kernel_warm_l2_ms": event_ms(lambda: kernel(*args, **kw), 50, None),
               "device_us": split_kernel_us(lambda: kernel(*args, **kw), 20, flush),
               "kernel_host_us": host_us(lambda: kernel(*args, **kw)),
               "plain_ms": event_ms(lambda: plain(*args, **kw), 5, flush),
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# the split-KV kernels' f32 instantiations (scores and P.V on the CUDA
# cores, no TF32) against the plain version in f32: sums of up to 2048
# products in another order, ~1e-6
SPLIT_F32_TOL = 1e-4


def check_split_f32(pa, la, kv_quantize, seed: int) -> list[dict]:
    """A decode, a mixed and an int8 case of each split-KV kernel in f32,
    correctness only (nothing serves f32 on the card by default)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    paged = {c["name"]: c for c in PAGED_CASES}
    latent = {c["name"]: c for c in LATENT_CASES}
    rows = []
    for kname, kernel, plain, c in (
            ("paged_flash_attention", pa.paged_flash_attention,
             pa.paged_attention_plain, paged["decode_per_row"]),
            ("paged_flash_attention", pa.paged_flash_attention,
             pa.paged_attention_plain, paged["mixed_step_parked"]),
            ("paged_flash_attention", pa.paged_flash_attention,
             pa.paged_attention_plain, paged["int8_decode"]),
            ("latent_flash_attention", la.latent_flash_attention,
             la.latent_attention_plain, latent["r128_decode"]),
            ("latent_flash_attention", la.latent_flash_attention,
             la.latent_attention_plain, latent["r512_mixed_q8_0"]),
            ("latent_flash_attention", la.latent_flash_attention,
             la.latent_attention_plain, latent["gemma2_r512_window_softcap"])):
        g = paged_geometry(c)
        x = paged_inputs(g, gen)
        q, kp, vp = x["q"].float(), x["kp"].float(), x["vp"].float()
        ks = vs = None
        if g["quant"]:
            (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        kw = dict(scale=g["scale"], softcap=g["softcap"], window=g["window"],
                  k_scale=ks, v_scale=vs)
        args = (q, kp, vp, x["tables"], x["lengths"], g["H"] // g["K"])
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = (got - plain(*args, **kw)).abs().max().item()
        if not (err <= SPLIT_F32_TOL and torch.isfinite(got).all()):
            fail(f"{kname} f32 case {c['name']}: max abs err {err} > {SPLIT_F32_TOL}")
        row = {"f32_case": c["name"], "kernel": kname, "max_abs_err": err,
               "tol": SPLIT_F32_TOL}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ptxas_report(built: dict) -> dict[str, list[dict]]:
    """Each kernel's registers, spills and static shared memory, per
    library, from the compiler's -Xptxas -v report."""
    out = {}
    for name, b in built.items():
        funcs, cur = [], None
        for line in b.ptxas.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"function": m.group(1)}
                funcs.append(cur)
            elif cur is not None:
                for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem", r"(\d+) bytes smem")):
                    m = re.search(pat, line)
                    if m:
                        cur[key] = int(m.group(1))
        out[name] = funcs
    return out


# --------------------------------------------------------------------------
# phase 3: latent_flash_attention against its plain version

# absorbed queries [B, T, H, r] against latent pools [N, bs, 1, r]: a paged
# case with one kv head of width r read by all H heads, at the caller's
# head-dim scale. Llama-3.2-1B (H=32, Hd=64): r = 128 is the default rank
# (K·Hd/4), r = 512 full rank; T = 1 is a B = 4 decode step, T = 64 a mixed
# step's lane width. gemma2-9b geometry: H = 16, r = 512 (its default rank),
# softcap 50, window 4096, block size 32.
LATENT_CASES = [
    dict(name=f"r{r}_{'decode' if T == 1 else 'mixed'}{'_q8_0' if q else ''}",
         B=4, T=T, K=1, Hd=r, lengths=[512] * 4 if T == 1 else [448, 900, 1300, 1900],
         scale=64 ** -0.5, quant=q)
    for r in (128, 512) for T in (1, 64) for q in (False, True)
] + [
    dict(name=f"gemma2_r512_window_softcap{'_q8_0' if q else ''}", B=2, T=1,
         lengths=[4500, 300], H=16, K=1, Hd=512, bs=32, max_seq=5120,
         window=4096, softcap=50.0, scale=256 ** -0.5, quant=q)
    for q in (False, True)
] + [dict(name="r128_decode_single_long", B=1, T=1, K=1, Hd=128, lengths=[2047],
          scale=64 ** -0.5)]


# --------------------------------------------------------------------------
# phase 3: fused_decode_attn against its plain version

# Llama-3.2-1B at B = 1 and B = 4, 512 cached, dense or q8_0 weights × bf16 or
# q8_0 pools; one Hd = 128 case at llama3-8b geometry (D 4096, H 32, K 8)
# with half rope, a window and per-row lengths
FUSED_CASES = [
    dict(name=f"b{B}_{w}_w_{kv}_pool", preset="llama3.2-1b", B=B, w=w, kv=kv,
         lengths=[512] * B)
    for B in (1, 4) for w in ("dense", "q8_0") for kv in ("bf16", "q8_0")
] + [dict(name="llama3_8b_hd128_half_window", preset="llama3-8b", B=4, w="dense",
          kv="bf16", lengths=[512, 300, 700, 1000], window=384, rope_style="half")]
FUSED_Y_ULPS = 4   # y: a few bf16 ulp of its largest |value|
FUSED_KV_ULPS = 1  # k_new / v_new: one bf16 ulp of the largest |value|
# x is drawn this small so that y = x + attention half is the attention half:
# RMSNorm makes h, and so everything after it, independent of x's scale, and
# ulps of max|y| then measure what the kernel computes, not the residual
FUSED_X_SCALE = 0.01
# the cuts that fit no other way: the largest batches that fuse, where the
# key tiles take the ring's place once its tiles are done (late_keys), the
# ring down to one-row tiles for some; f32 rows at dtype "f32"
FUSED_EDGE_CASES = [
    dict(name="f32_b20_late_keys", preset="llama3.2-1b", B=20, dtype="f32", w="dense",
         kv="f32"),
    dict(name="f32_b22_int8_pool_row_tiles", preset="llama3.2-1b", B=22, dtype="f32",
         w="dense", kv="q8_0"),
    dict(name="f32_llama3_8b_b9_int8_pool", preset="llama3-8b", B=9, dtype="f32", w="dense",
         kv="q8_0"),
    dict(name="bf16_b39_q8_0_w_int8_pool_row_tiles", preset="llama3.2-1b", B=39,
         dtype="bf16", w="q8_0", kv="q8_0"),
]
# an f32 case's y, k_new and v_new against the plain version, as a share of
# their largest |value|: sums in other orders over D = 2048-4096 terms
# (a few f32 ulp a sum); one key of 513 left out moves y by ~1e-3 of it
FUSED_F32_REL = 1e-5
# the served unfused half against the plain version: over q8_0 weights it
# runs W8A8 (h and the attention output quantized to 127 levels a row) where
# the plain version multiplies the dequantized weights (2.6 ulp of max|y| at
# B = 4 in the plain W8A8 arithmetic on the CPU)
FUSED_SERVED_ULPS = {"dense": FUSED_Y_ULPS, "q8_0": 8}


def fused_block(llama, qm, cfg, w: str, window: int, gen: torch.Generator,
                dtype: torch.dtype = torch.bfloat16):
    """One block's attention leaves at ``cfg``'s widths, weights N(0, 0.02²)
    and norm weights 1 + N(0, 0.1²) from ``gen`` in ``dtype``: the block the
    kernel runs (q8_0 packs when ``w`` says so) and the dense block of the
    same weights the plain version runs (for q8_0, each weight dequantized
    to bf16 as the kernel dequantizes it)."""
    D, H, K, Hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    leaves = {"attn_norm": (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
                            ).to(dtype)}
    for name, shape in (("wq", (H * Hd, D)), ("wk", (K * Hd, D)),
                        ("wv", (K * Hd, D)), ("wo", (D, H * Hd))):
        leaves[name] = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    if w == "dense":
        block = llama.Block(cfg, leaves, window)
        return block, block
    packed = dict(leaves)
    dense = dict(leaves)
    for name in ("wq", "wk", "wv", "wo"):
        packed[name] = qm.pack_q8_0(leaves[name]).to("cuda")
        dense[name] = packed[name].dequant(torch.bfloat16)
    return llama.Block(cfg, packed, window), llama.Block(cfg, dense, window)


def fused_bound(cfg, g: dict, w: str) -> tuple[float, str]:
    """Least time for the work these inputs need: the head's weights once
    (q8_0: a code and 1/32 of a bf16 scale per weight), each row's visible
    pool positions once, x, norm, rope tables, y and the new K/V once;
    2 operations per weight per row and 4·Hd per head per attended key."""
    D, H, K, Hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, window, quant = g["B"], g["window"], g["quant"]
    n_w = D * H * Hd * 2 + 2 * D * K * Hd
    w_bytes = n_w * (1 + 2 / 32 if w == "q8_0" else 2)
    col_bytes = 2 * K * (Hd * (1 if quant else 2) + (4 if quant else 0))
    keys = sum(min(cl, g["NT"] * g["bs"]) - (max(0, cl - window + 1) if window else 0)
               for cl in g["lengths"])
    n_bytes = (w_bytes + keys * col_bytes + 2 * B * D * 2 + D * 2 + B * Hd * 4
               + 2 * B * K * Hd * 2)
    ops = 2 * B * n_w + 4 * H * Hd * (keys + B)
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, ops / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fused(fd, llama, qm, pa, kv_quantize, seed: int,
                flush: torch.Tensor) -> list[dict]:
    """The fused decode step, kernel against plain version (the unfused
    composition on the same weights, in bf16), one JSON line per case; the
    served unfused attention half (cuBLAS or W8A8 projections and the paged
    kernel) is held to the plain version and timed beside the kernel, as no
    one library call computes it."""
    from distributed_llm_pipeline_tpu_torch.models import PRESETS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for c in FUSED_CASES:
        cfg = PRESETS[c["preset"]].replace(rope_style=c.get("rope_style",
                                                            "interleaved"))
        g = paged_geometry(dict(B=c["B"], T=1, lengths=c["lengths"],
                                H=cfg.n_heads, K=cfg.n_kv_heads, Hd=cfg.head_dim,
                                window=c.get("window", 0), quant=c["kv"] == "q8_0"))
        x = paged_inputs(g, gen)
        kp, vp, tables, lengths = (x[k] for k in ("kp", "vp", "tables", "lengths"))
        ks = vs = None
        if g["quant"]:
            (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        block, dense = fused_block(llama, qm, cfg, c["w"], g["window"], gen)
        xin = (FUSED_X_SCALE * torch.randn(c["B"], cfg.dim, generator=gen,
                                           device="cuda")).bfloat16()
        cos, sin = (t[:, 0].contiguous() for t in
                    llama.rope_freqs(cfg, lengths.long()[:, None]))

        def pools():
            return [t.clone() if t is not None else None for t in (kp, vp, ks, vs)]

        def kern():
            return fd.fused_decode_attn(xin, block, cos, sin, kp, vp, tables,
                                        lengths, k_scale=ks, v_scale=vs)

        def plain(p=None):
            k2, v2, ks2, vs2 = p or (kp, vp, ks, vs)
            return fd.fused_decode_plain(xin, dense, cos, sin, k2, v2, tables,
                                         lengths, k_scale=ks2, v_scale=vs2)

        def unfused(p=None):
            # the served unfused attention half on the kernel's block
            k2, v2, ks2, vs2 = p or (kp, vp, ks, vs)
            xb = xin[:, None]
            q, k, v = block.qkv(xb, cos[:, None], sin[:, None])
            where = llama.paged_write_index(tables, lengths, 1, k2.shape[1])
            llama._paged_kv_write(k2, v2, ks2, vs2, k, v, *where)
            attn = pa.paged_attention_any(
                q, k2, v2, tables, lengths, cfg.n_heads // cfg.n_kv_heads,
                scale=cfg.attn_scale, softcap=cfg.attn_softcap,
                window=block.window, k_scale=ks2, v_scale=vs2)
            return block.attn_out(xb, attn)[:, 0]

        got = kern()
        torch.cuda.synchronize()
        want = plain(pools())
        errs, tols = [], []
        for name, a, b, ulps in zip(("y", "k_new", "v_new"), got, want,
                                    (FUSED_Y_ULPS, FUSED_KV_ULPS, FUSED_KV_ULPS)):
            err = (a.float() - b.float()).abs().max().item()
            tol = ulps * bf16_ulp(b.float().abs().max().item())
            if not (err <= tol and torch.isfinite(a.float()).all()):
                fail(f"fused_decode_attn case {c['name']}: {name} max abs err "
                     f"{err} > {tol}")
            errs.append(err)
            tols.append(tol)
        unfused_err = (unfused(pools()).float() - want[0].float()).abs().max().item()
        unfused_tol = FUSED_SERVED_ULPS[c["w"]] * bf16_ulp(want[0].float().abs().max().item())
        if not unfused_err <= unfused_tol:
            fail(f"fused case {c['name']}: the served unfused half differs from the "
                 f"plain version by {unfused_err} > {unfused_tol}")
        # the same bits again (no float atomics: the head sum is ordered)
        again = kern()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_decode_attn case {c['name']}: a relaunch gave other bits")
        bound_ms, bound_by = fused_bound(cfg, g, c["w"])
        w_q8 = c["w"] == "q8_0"
        plan = fd.fused_plan(c["B"], cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             xin.element_size(), w_q8, g["quant"])
        row = {"case": c["name"], "kernel": "fused_decode_attn",
               "shape": {k: c[k] for k in c if k != "name"},
               "plan": {"cluster": plan.cluster, "ctas": plan.ctas,
                        "max_active_clusters": fd.max_active_clusters(
                            plan, c["B"], cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, xin.element_size(), w_q8, g["quant"]),
                        **{k: v for k, v in plan._asdict().items()
                           if k not in ("cluster", "ctas")}},
               "max_abs_err": errs[0], "tol": tols[0],
               "k_new_max_abs_err": errs[1], "k_new_tol": tols[1],
               "v_new_max_abs_err": errs[2], "v_new_tol": tols[2],
               "served_unfused_y_max_abs_diff": unfused_err,
               "served_unfused_tol": unfused_tol,
               "kernel_ms": event_ms(kern, 50, flush),
               "kernel_warm_l2_ms": event_ms(kern, 50, None),
               "kernel_host_us": host_us(kern),
               "plain_ms": event_ms(plain, 5, flush),
               "unfused_ms": event_ms(unfused, 20, flush),
               "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_fused_edges(fd, llama, qm, kv_quantize, seed: int) -> list[dict]:
    """FUSED_EDGE_CASES, kernel against plain version at 512 cached tokens a
    row, and a relaunch for the same bits; one JSON line a case with the
    plan (no timing)."""
    from distributed_llm_pipeline_tpu_torch.models import PRESETS

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    rows = []
    for c in FUSED_EDGE_CASES:
        cfg = PRESETS[c["preset"]]
        dtype = torch.float32 if c["dtype"] == "f32" else torch.bfloat16
        g = paged_geometry(dict(B=c["B"], T=1, lengths=[512] * c["B"], H=cfg.n_heads,
                                K=cfg.n_kv_heads, Hd=cfg.head_dim, quant=c["kv"] == "q8_0"))
        x = paged_inputs(g, gen)
        kp, vp, tables, lengths = (x[k] for k in ("kp", "vp", "tables", "lengths"))
        kp, vp = kp.to(dtype), vp.to(dtype)
        ks = vs = None
        if g["quant"]:
            (kp, ks), (vp, vs) = kv_quantize(kp), kv_quantize(vp)
        block, dense = fused_block(llama, qm, cfg, c["w"], 0, gen, dtype)
        xin = (FUSED_X_SCALE * torch.randn(c["B"], cfg.dim, generator=gen,
                                           device="cuda")).to(dtype)
        cos, sin = (t[:, 0].contiguous() for t in
                    llama.rope_freqs(cfg, lengths.long()[:, None]))
        plan = fd.fused_plan(c["B"], cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             xin.element_size(), c["w"] == "q8_0", g["quant"])
        if not plan.late_keys:
            fail(f"fused edge case {c['name']}: its plan keeps the key tiles apart: {plan}")

        def kern():
            return fd.fused_decode_attn(xin, block, cos, sin, kp, vp, tables, lengths,
                                        k_scale=ks, v_scale=vs)

        got = kern()
        torch.cuda.synchronize()
        pools = [t.clone() if t is not None else None for t in (kp, vp, ks, vs)]
        want = fd.fused_decode_plain(xin, dense, cos, sin, pools[0], pools[1], tables,
                                     lengths, k_scale=pools[2], v_scale=pools[3])
        errs, tols = [], []
        for name, a, b, ulps in zip(("y", "k_new", "v_new"), got, want,
                                    (FUSED_Y_ULPS, FUSED_KV_ULPS, FUSED_KV_ULPS)):
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            tol = FUSED_F32_REL * top if dtype == torch.float32 else ulps * bf16_ulp(top)
            if not (err <= tol and torch.isfinite(a.float()).all()):
                fail(f"fused_decode_attn edge case {c['name']}: {name} max abs err "
                     f"{err} > {tol}")
            errs.append(err)
            tols.append(tol)
        again = kern()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_decode_attn edge case {c['name']}: a relaunch gave other bits")
        row = {"case": c["name"], "kernel": "fused_decode_attn",
               "shape": {k: c[k] for k in c if k != "name"}, "plan": plan._asdict(),
               "max_abs_err": errs[0], "tol": tols[0], "k_new_max_abs_err": errs[1],
               "v_new_max_abs_err": errs[2], "kv_tol": tols[1:]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phase 3: the quantized matmul kernels against their plain versions

# Llama-3.2-1B's projection (D, F) pairs and its head (tied, 128256 rows)
QUANT_PAIRS = [("wq_wo", 2048, 2048), ("wk_wv", 2048, 512),
               ("gate_up", 2048, 8192), ("down", 8192, 2048),
               ("head", 2048, 128256)]
W8A8_M = (1, 4, 16, 32)          # decode B = 1..4, short prefill buckets
DEQUANT_M = (33, 256, 512)       # the cutover, mixed steps, a 512 prefill
INT8_M = W8A8_M + DEQUANT_M      # int8 has one kernel at every M
# edges: an odd F, activation group 32 (Q8_0 and int8 with D % 64 != 0,
# Q6_K, Q2_KS and Q3_KS with D/4 % 256 != 0, Q4_K and Q5_KS with
# D/2 % 256 != 0), int8's group 128, an all-zero activation row
QUANT_EDGES = [dict(name="odd_f", D=2048, F=1001),
               dict(name="group32", D={"q8_0": 2080, "q6_k": 1280, "q4_k": 1280,
                                       "q5_ks": 1280, "int8": 2080, "q2_ks": 1280,
                                       "q3_ks": 1280, "q5_k": 1056, "q4_k8": 1056,
                                       "q6_k8": 1056}, F=1024),
               dict(name="group128", D={"int8": 1152}, F=1024)]
QUANT_KINDS = ("q8_0", "q6_k", "q4_k", "q5_ks", "int8", "q2_ks", "q3_ks",
               "q5_k", "q4_k8", "q6_k8")
# the byte-code packs of tp > 1 meshes run at the tp = 2 shard shapes of
# Llama-3.2-1B (q/k/v and gate/up split their outputs, the output and down
# projections their contraction dim) and the head rank 0 keeps whole;
# q5_k_matmul at the mesh's mixed steps (4 rows x 16 lanes: M = 64) too
BYTE_KINDS = ("q5_k", "q4_k8", "q6_k8")
SHARD_PAIRS = [("wq", 2048, 1024), ("wk_wv", 2048, 256), ("wo", 1024, 2048),
               ("gate_up", 2048, 4096), ("down", 4096, 2048), ("head", 2048, 128256)]
SHARD_DEQUANT_M = (33, 64, 256, 512)
# the case each kernel's kernels-line entry reports: the (D, F) pair with the
# most weight bytes of a layer at the M its served path runs (q8_0, q5_ks and
# q2_ks: the parallel-4 path, B=4 decode and 256-lane mixed steps; q6_k,
# q4_k, int8 and q3_ks: the single-stream path, B=1 decode and a 512-token
# prefill bucket; int8's entry reports its GEMM)
QUANT_TIMED = {("q8_0", "w8a8"): ("gate_up", 4), ("q8_0", "dequant"): ("gate_up", 256),
               ("q6_k", "w8a8"): ("gate_up", 1), ("q6_k", "dequant"): ("gate_up", 512),
               ("q4_k", "w8a8"): ("gate_up", 1), ("q4_k", "dequant"): ("gate_up", 512),
               ("q5_ks", "w8a8"): ("gate_up", 4), ("int8", "int8"): ("gate_up", 512),
               ("q2_ks", "w8a8"): ("gate_up", 4), ("q3_ks", "w8a8"): ("gate_up", 1),
               ("q5_k", "dequant"): ("gate_up", 64), ("q5_k", "w8a8"): ("gate_up", 4),
               ("q4_k8", "w8a8"): ("gate_up", 1), ("q6_k8", "w8a8"): ("gate_up", 1)}


def quant_kernels(qm, kind: str) -> list[tuple[str, tuple[int, ...], tuple[int, ...]]]:
    """(kernel, M of the pairs, M of the edges) for each kernel a pack kind
    runs."""
    if kind == "int8":
        return [("int8", INT8_M, (3, 100))]
    kernels = [("w8a8", W8A8_M, (3,))]
    if qm._NAMES[kind][0]:   # the kind has a fused-dequant kernel
        kernels.append(("dequant", SHARD_DEQUANT_M if kind in BYTE_KINDS else DEQUANT_M,
                        (100,)))
    return kernels


def random_pack(qm, kq, kind: str, D: int, F: int, gen: torch.Generator):
    """A pack of random codes (every bit pattern of the format) and scales
    of about 0.02 / code std, built on the card; an affine pack's offsets
    sit near scale · the codes' mean, so its weights are centred as the
    encoder's are."""
    def codes(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda",
                             generator=gen)

    def scales(*shape, std_code: float):
        return ((0.5 + torch.rand(shape, device="cuda", generator=gen))
                * 0.02 / std_code).bfloat16()

    def offsets(a: torch.Tensor, mean_code: float) -> torch.Tensor:
        jitter = 0.9 + 0.2 * torch.rand(a.shape, device="cuda", generator=gen)
        return (a.float() * mean_code * jitter).bfloat16()

    if kind == "q8_0":
        return qm.Q8_0Pack(qs=codes(F, D).clamp_(-127, 127),
                           scale=scales(F, D // 32, std_code=73.0))
    if kind == "int8":
        group = 256 if D % 256 == 0 else qm._pow2_group(D)
        return qm.Int8Pack(qs=codes(F, D).clamp_(-127, 127),
                           gs=scales(F, D // group, std_code=73.0).float())
    if kind == "q2_ks":
        a = scales(F, D // 16, std_code=1.12)
        return kq.Q2KSPack(q2l=codes(F, D // 4), a=a, b=offsets(a, 1.5))
    if kind == "q3_ks":
        return kq.Q3KSPack(q3l=codes(F, D // 4), q3h=codes(F, D // 8),
                           s=scales(F, D // 16, std_code=2.29))
    if kind == "q4_k":
        a = scales(F, D // 32, std_code=4.6)
        return kq.Q4KPack(qs=codes(F, D // 2), a=a, b=offsets(a, 7.5))
    if kind == "q5_ks":
        a = scales(F, D // 32, std_code=9.2)
        return kq.Q5KSPack(q5n=codes(F, D // 2), q5h=codes(F, D // 8), a=a,
                           b=offsets(a, 15.5))
    if kind == "q5_k":
        a = scales(F, D // 32, std_code=9.2)
        return kq.Q5KPack(q5=codes(F, D) & 31, a=a, b=offsets(a, 15.5))
    if kind == "q4_k8":
        a = scales(F, D // 32, std_code=4.6)
        return kq.Q4K8Pack(q4=codes(F, D) & 15, a=a, b=offsets(a, 7.5))
    if kind == "q6_k8":
        return kq.Q6K8Pack(q6=codes(F, D) >> 2, s=scales(F, D // 16, std_code=18.5))
    return kq.Q6KPack(ql=codes(F, D // 2), qh=codes(F, D // 4),
                      s=scales(F, D // 16, std_code=18.5))


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def quant_case(qm, pack, kernel: str, M: int, out_dtype, gen, flush,
               zero_row: bool = False) -> dict:
    """One kernel against its plain version at x [M, D] bf16: max abs error
    within one bf16 ulp of the largest output (the kernels and the plain
    versions differ in f32 summation order, then round alike), the W8A8 and
    int8 kernels' quantized activations equal to ``quantize_acts``, times
    and the bound."""
    import torch.nn.functional as F

    Fo, D = pack.shape
    x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    if zero_row:
        x[0] = 0
    if kernel == "w8a8":
        def kern():
            return qm.w8a8_matmul(x, pack, out_dtype)

        def plain():
            return qm.w8a8_plain(x, pack, out_dtype)
    elif kernel == "int8":
        def kern():
            return qm.int8_matmul(x, pack, out_dtype)

        def plain():
            return qm.int8_matmul_plain(x, pack, out_dtype)
    else:
        from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq

        plain_fn = kq.q5_k_matmul_plain if pack.kind == "q5_k" else qm.dequant_matmul_plain

        def kern():
            return qm.dequant_matmul(x, pack, out_dtype)

        def plain():
            return plain_fn(x, pack, out_dtype)
    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = (got.float() - ref.float()).abs().max().item()
    tol = bf16_ulp(ref.float().abs().max().item())
    name = f"{pack.kind} {kernel} D={D} F={Fo} M={M}"
    if not (err <= tol and torch.isfinite(got.float()).all()):
        fail(f"{name}: max abs err {err} > {tol}")
    extra = {}
    if kernel == "dequant" and pack.kind in qm.GEMM_KINDS:
        extra = gemm_launch_check(qm, pack, M, kern, got, name)
    if kernel == "w8a8" and qm.gemv_takes(pack.kind, D):
        extra = gemv_launch_check(qm, pack, M, kern, got, name)
    if kernel == "int8" and M > qm.INT8_W8A8_MAX_M:
        extra = int8_launch_check(qm, pack, M, kern, got, ref, name)
        if M >= 256:
            extra["device_us"] = split_kernel_us(kern, 20, flush, INT8_KERNELS)
    if kernel in ("w8a8", "int8"):
        group = pack.group
        xq = torch.empty(M, D, dtype=torch.int8, device="cuda")
        xs = torch.empty(M, D // group, dtype=torch.float32, device="cuda")
        (qm.int8_matmul if kernel == "int8" else qm.w8a8_matmul)(
            x, pack, out_dtype, acts=(xq, xs))
        rq, rs = qm.quantize_acts(x, group)
        if not (torch.equal(xq, rq) and torch.equal(xs, rs)):
            fail(f"{name}: the kernel's quantized activations differ from "
                 "quantize_acts")
        if kernel == "int8" and M >= 256:
            # a yardstick only: the int8 product of the same operands with no
            # group scales; the port never calls it
            qt = pack.qs.t()
            try:
                extra["int_mm_ms"] = event_ms(lambda: torch._int_mm(rq, qt), 20, flush)
            except RuntimeError as e:
                extra["int_mm_error"] = str(e)[:200]
    dense = pack.dequant(torch.bfloat16)
    lib_err = (F.linear(x, dense).float() - ref.float()).abs().max().item()
    n_bytes = (M * D * 2 + pack.nbytes()
               + M * Fo * (4 if out_dtype == torch.float32 else 2))
    ops = 2 * M * D * Fo
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / (BF16_FLOP_S if kernel == "dequant" else INT8_OP_S) * 1e3
    return {"case": name, "kind": pack.kind, "kernel": kernel, "M": M, "D": D,
            "F": Fo, "out": str(out_dtype).split(".")[-1], "zero_row": zero_row,
            "max_abs_err": err, "tol": tol, **extra,
            "library_max_abs_err": lib_err,
            "kernel_ms": event_ms(kern, 50, flush),
            "kernel_warm_l2_ms": event_ms(kern, 50, None),
            "kernel_host_us": host_us(kern),
            "plain_ms": event_ms(plain, 5, flush),
            "library": "F.linear on the dense bf16 weight the pack represents",
            "library_ms": event_ms(lambda: F.linear(x, dense), 20, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def relaunch_check(kern, got: torch.Tensor, name: str) -> None:
    """A second launch on the same inputs, made with host syncs turned into
    errors, must give the same bits."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = kern()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(got, again):
        fail(f"{name}: two launches on the same inputs differ")


def gemm_launch_check(qm, pack, M: int, kern, got: torch.Tensor, name: str) -> dict:
    """The fused-dequant GEMM's cut of this case (``gemm_plan`` from the
    library's geometry) and a relaunch for the same bits."""
    Fo, D = pack.shape
    geo = qm.gemm_geometry(pack.kind, qm.gemm_bm(M))
    plan = qm.gemm_plan(M, D, Fo, geo, qm.sm_count(torch.cuda.current_device()))
    relaunch_check(kern, got, name)
    grid = [plan.tiles_n, plan.tiles_m, plan.splits]
    return {"plan": plan._asdict(), "grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "threads": geo.threads, "smem": geo.smem, "blocks_per_sm": geo.blocks_per_sm,
            "bit_equal_relaunch": True}


def gemv_launch_check(qm, pack, M: int, kern, got: torch.Tensor, name: str) -> dict:
    """The persistent W8A8 GEMV's cut of this case (``gemv_plan``, shapes
    only; the library refuses a launch whose shared memory is not the
    plan's) and a relaunch for the same bits."""
    Fo, D = pack.shape
    plan = qm.gemv_plan(pack.kind, M, D, Fo, qm.sm_count(torch.cuda.current_device()))
    relaunch_check(kern, got, name)
    return {"plan": plan._asdict(), "blocks": plan.grid, "threads": 32 * qm.GEMV_WARPS,
            "smem": plan.smem, "bit_equal_relaunch": True}


def int8_launch_check(qm, pack, M: int, kern, got: torch.Tensor, ref: torch.Tensor,
                      name: str) -> dict:
    """The int8 GEMM's cut of this case (``int8_plan``, shapes only), the
    library's geometry for it (which must tile as the plan assumes), the
    output equal to the plain version's bit for bit (both sum each output's
    groups in group order, every product and sum rounded alike), and a
    relaunch for the same bits."""
    Fo, D = pack.shape
    if not torch.equal(got, ref):
        fail(f"{name}: the int8 GEMM differs from int8_matmul_plain "
             f"({(got != ref).sum().item()} outputs)")
    plan = qm.int8_plan(M, D, Fo, pack.group, qm.sm_count(torch.cuda.current_device()))
    geo = qm.int8_geometry(pack.group, plan.bn)
    if (geo.bm, geo.bn, geo.kstep) != (plan.bm, plan.bn, qm.INT8_KSTEP):
        fail(f"{name}: the library tiles {geo}, the plan assumes {plan}")
    relaunch_check(kern, got, name)
    grid = [plan.tiles_n, plan.tiles_m]
    return {"plan": plan._asdict(), "grid": grid, "blocks": grid[0] * grid[1],
            "threads": geo.threads, "smem": geo.smem, "stages": geo.stages,
            "blocks_per_sm": geo.blocks_per_sm, "bit_equal_plain": True,
            "bit_equal_relaunch": True}


# the identity probe of the GEMMs: x = I at the gate_up pack
IDENTITY_D, IDENTITY_F = 2048, 8192


def every_byte(F: int, D: int) -> torch.Tensor:
    """int8 codes [F, D] on the card holding every byte value, -128
    included, in every row and column (random_pack's Q8_0 and int8 codes
    stop at +-127, as the encoders' do; a GGUF block's raw bytes may not)."""
    f = torch.arange(F, device="cuda")[:, None]
    j = torch.arange(D, device="cuda")[None, :]
    return ((f * 37 + j) % 256).to(torch.uint8).view(torch.int8)


def check_gemm_identity(qm, kq, seed: int, card: str) -> list[dict]:
    """x = I (M = D = 2048) through each fused-dequant GEMM into f32 must
    equal ``dequant_matmul_plain`` bit for bit: the decoded weights'
    transpose (less b per 32 rows for Q4_K and Q5_K), every product exact
    and every sum of at most two nonzero terms; Q8_0's pack holds every byte
    value. The same through the int8 GEMM must equal ``int8_matmul_plain``
    (x = I quantizes to 127 on the diagonal: each output is one group's
    term). A decode, swizzle, band or fold mistake shows column by column,
    where the one-ulp tolerance would blur it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.eye(IDENTITY_D, dtype=torch.bfloat16, device="cuda")
    rows = []
    for kind in (*qm.GEMM_KINDS, "int8"):
        pack = random_pack(qm, kq, kind, IDENTITY_D, IDENTITY_F, gen)
        if kind in ("q8_0", "int8"):
            pack.qs.copy_(every_byte(IDENTITY_F, IDENTITY_D))
            if torch.unique(pack.qs).numel() != 256:
                fail(f"{kind} identity probe: the pack lacks byte values")
        if kind == "int8":
            got = qm.int8_matmul(x, pack, torch.float32)
            want = qm.int8_matmul_plain(x, pack, torch.float32)
        else:
            got = qm.dequant_matmul(x, pack, torch.float32)
            want = qm.dequant_matmul_plain(x, pack, torch.float32)
        torch.cuda.synchronize()
        bad = (got != want).nonzero()
        row = {"identity_probe": kind, "M": IDENTITY_D, "D": IDENTITY_D, "F": IDENTITY_F,
               "every_byte": kind in ("q8_0", "int8"),
               "bit_equal": bad.shape[0] == 0, "differing": bad.shape[0],
               "first_differing_rows_cols": bad[:8].tolist(), "card": card}
        print(json.dumps(row), flush=True)
        if bad.shape[0]:
            fail(f"{kind} identity probe: {bad.shape[0]} outputs differ from the plain "
                 f"version, first (row, col) {bad[:8].tolist()}")
        rows.append(row)
    return rows


def check_misaligned(qm, kq, seed: int) -> dict:
    """A contiguous view at a storage offset that is not a multiple of 16
    bytes must raise ValueError from each quantized wrapper, from the dense
    attention's and from the fused decode step's (the kernels load x, q, the
    cache and the weights 16 bytes at a time or by bulk copies; a misaligned
    load would end the CUDA context), as must a pack field so placed; the
    context stays usable."""
    from distributed_llm_pipeline_tpu_torch.models import PRESETS, llama
    from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    M, D, F = 64, 2048, 512
    x = torch.empty(M * D + 1, dtype=torch.bfloat16, device="cuda")[1:].view(M, D)
    x.normal_(generator=gen)
    q4 = random_pack(qm, kq, "q4_k", D, F, gen)
    q6 = random_pack(qm, kq, "q6_k", D, F, gen)
    q8 = random_pack(qm, kq, "q8_0", D, F, gen)
    i8 = random_pack(qm, kq, "int8", D, F, gen)
    calls = {"dequant_matmul": lambda: qm.dequant_matmul(x, q4, torch.bfloat16),
             "dequant_matmul, q8_0": lambda: qm.dequant_matmul(x, q8, torch.bfloat16),
             "w8a8_matmul": lambda: qm.w8a8_matmul(x[:4], q6, torch.bfloat16),
             "int8_matmul": lambda: qm.int8_matmul(x, i8, torch.bfloat16)}

    def off16(t: torch.Tensor) -> torch.Tensor:
        """a copy of ``t`` one element past a 16-byte boundary"""
        bad = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view_as(t)
        return bad.copy_(t)

    bad_q6 = kq.Q6KPack(ql=off16(q6.ql), qh=q6.qh, s=q6.s)
    bad_q8 = qm.Q8_0Pack(qs=off16(q8.qs), scale=q8.scale)
    bad_i8 = qm.Int8Pack(qs=off16(i8.qs), gs=i8.gs)
    calls["dequant_matmul, pack field"] = lambda: qm.dequant_matmul(
        x.clone(), bad_q6, torch.bfloat16)
    calls["dequant_matmul, q8_0 pack field"] = lambda: qm.dequant_matmul(
        x.clone(), bad_q8, torch.bfloat16)
    calls["int8_matmul, pack field"] = lambda: qm.int8_matmul(x.clone(), bad_i8, torch.bfloat16)
    q = torch.empty(32 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, 1, 32, 64)
    kv = torch.zeros(1, 256, 8, 64, dtype=torch.bfloat16, device="cuda")
    calls["flash_attention"] = lambda: fa.flash_attention(q, kv, kv, 100, 4)
    # the fused step over a pool view one element past a 16-byte boundary
    cfg = PRESETS["llama3.2-1b"]
    block, _ = fused_block(llama, qm, cfg, "dense", 0, gen)
    fx = (FUSED_X_SCALE * torch.randn(4, cfg.dim, generator=gen, device="cuda")).bfloat16()
    pool = torch.zeros(9, 64, cfg.n_kv_heads, cfg.head_dim, dtype=torch.bfloat16, device="cuda")
    fargs = dict(tables=torch.arange(1, 9, dtype=torch.int32, device="cuda").view(4, 2),
                 lengths=torch.full((4,), 100, dtype=torch.int32, device="cuda"))
    fcos, fsin = (t[:, 0].contiguous() for t in llama.rope_freqs(
        cfg, fargs["lengths"].long()[:, None]))
    calls["fused_decode_attn, pool"] = lambda: fd.fused_decode_attn(
        fx, block, fcos, fsin, off16(pool), pool, **fargs)
    out = {}
    for what, call in calls.items():
        try:
            call()
        except ValueError as e:
            out[what] = str(e)
        else:
            fail(f"{what}: a misaligned input did not raise ValueError")
    torch.cuda.synchronize()
    xa = x.clone()
    ok = (torch.equal(qm.dequant_matmul(xa, q4, torch.float32),
                      qm.dequant_matmul(xa, q4, torch.float32))
          and torch.equal(qm.int8_matmul(xa, i8, torch.float32),
                          qm.int8_matmul(xa, i8, torch.float32))
          and torch.equal(fd.fused_decode_attn(fx, block, fcos, fsin, pool, pool, **fargs)[0],
                          fd.fused_decode_attn(fx, block, fcos, fsin, pool, pool, **fargs)[0]))
    torch.cuda.synchronize()
    if not ok:
        fail("the CUDA context misbehaves after the misaligned calls")
    row = {"misaligned_raise": out, "context_usable": True}
    print(json.dumps(row), flush=True)
    return row


def check_quant(qm, kq, seed: int, flush: torch.Tensor, card: str) -> dict:
    """The quantized matmul kernels: one JSON line per case; returns the
    rows by (kind, kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows: dict[tuple[str, str], list[dict]] = {}
    for kind in QUANT_KINDS:
        kernels = quant_kernels(qm, kind)
        pairs = SHARD_PAIRS if kind in BYTE_KINDS else QUANT_PAIRS
        # the mesh's head sees M <= 4: a byte head runs W8A8 at M = 1 and 4
        cases = [(p, D, F, M, k) for p, D, F in pairs for k, ms, _ in kernels
                 for M in ms if not (kind in BYTE_KINDS and p == "head" and M > 4)]
        for e in QUANT_EDGES:
            if isinstance(e["D"], dict) and kind not in e["D"]:
                continue
            D = e["D"][kind] if isinstance(e["D"], dict) else e["D"]
            cases += [(e["name"], D, e["F"], m, k) for k, _, ms in kernels for m in ms]
        packs = {}
        for pname, D, F, M, kernel in cases:
            if pname not in packs:
                packs[pname] = random_pack(qm, kq, kind, D, F, gen)
            pack = packs[pname]
            out_dtype = torch.float32 if pname == "head" else torch.bfloat16
            row = quant_case(qm, pack, kernel, M, out_dtype, gen, flush,
                             zero_row=pname == "odd_f")
            row["pair"] = pname
            row["card"] = card
            print(json.dumps(row), flush=True)
            rows.setdefault((kind, kernel), []).append(row)
        if not qm._NAMES[kind][0]:
            print(json.dumps(dense_route_case(qm, packs["gate_up"], gen, flush, card)),
                  flush=True)
        del packs
    return rows


def dense_route_case(qm, pack, gen, flush, card: str, M: int = 256) -> dict:
    """The route of a kind with no fused-dequant kernel at M > 32: the
    dense weight (``pack.dequant``), then ``F.linear``, beside ``F.linear``
    on a dense weight already there."""
    import torch.nn.functional as F

    Fo, D = pack.shape
    x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    dense = pack.dequant(torch.bfloat16)
    got = qm.dequant_linear(x, pack, torch.bfloat16)
    if not torch.equal(got, F.linear(x, dense)):
        fail(f"{pack.kind} dequant_linear differs from F.linear on the dense weight")
    return {"case": f"{pack.kind} dequant_linear D={D} F={Fo} M={M}", "kind": pack.kind,
            "M": M, "D": D, "F": Fo,
            "route_ms": event_ms(lambda: qm.dequant_linear(x, pack, torch.bfloat16), 20, flush),
            "dequant_ms": event_ms(lambda: pack.dequant(torch.bfloat16), 20, flush),
            "library": "F.linear on the dense bf16 weight",
            "library_ms": event_ms(lambda: F.linear(x, dense), 20, flush), "card": card}


# --------------------------------------------------------------------------
# phase 4: the served path

def build_vocab(vocab_size: int) -> dict:
    """GGUF tokenizer metadata of an SPM vocab covering the model's whole id
    space (any sampled id decodes): specials, the byte table (strongly
    penalized, as real SPM vocabs do), the merge chain that reaches
    "▁hello", then filler pieces."""
    import numpy as np

    from distributed_llm_pipeline_tpu_torch.tokenizer import TokenType as TT

    tokens = ["<unk>", "<s>", "</s>"]
    types, scores = [TT.UNKNOWN, TT.CONTROL, TT.CONTROL], [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(TT.BYTE)
        scores.append(-100.0)
    for piece, score in (("▁", -2.0), ("he", -3.0), ("ll", -3.5), ("llo", -3.2),
                         ("hello", -2.5), ("▁hello", -1.0)):
        tokens.append(piece)
        types.append(TT.NORMAL)
        scores.append(score)
    while len(tokens) < vocab_size:
        tokens.append(f"tok{len(tokens)}")
        types.append(TT.NORMAL)
        scores.append(-20.0)

    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.array(scores, dtype=np.float32),
            "tokenizer.ggml.token_type": np.array([int(t) for t in types], dtype=np.int32),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.add_bos_token": True,
            "tokenizer.ggml.add_space_prefix": True}


def q4_k_m_types(n_layers: int):
    """llama.cpp's Q4_K_M type of each matrix (``src/llama-quant.cpp``,
    ``llama_tensor_get_type``) for a tied llama: attn_v and ffn_down in Q6_K
    on the ``use_more_bits`` layers, the other projections in Q4_K, the
    embedding (which is the head) in Q6_K."""
    from distributed_llm_pipeline_tpu_torch.gguf import GGMLType

    n8 = n_layers // 8
    more = {i for i in range(n_layers)
            if i < n8 or i >= 7 * n_layers // 8 or (i - n8) % 3 == 2}

    def wtype(name: str):
        if name == "token_embd.weight":
            return GGMLType.Q6_K
        _, layer, leaf = name.split(".")[:3]
        if leaf in ("attn_v", "ffn_down") and int(layer) in more:
            return GGMLType.Q6_K
        return GGMLType.Q4_K

    return wtype


def write_model(path: Path, cfg, seed: int, device: str = "cuda",
                wtype=None) -> None:
    """A GGUF of ``cfg``'s geometry, weights N(0, 0.02²) drawn on ``device``
    from ``seed``, norms 1 (F32), tied embeddings. The matrices are BF16, or
    encoded on the host as ``wtype``: a GGMLType (e.g. Q6_K), or a function
    of the tensor name giving one (``q4_k_m_types``)."""
    from distributed_llm_pipeline_tpu_torch.gguf import GGMLType, GGUFWriter, quantize

    w = GGUFWriter(path)
    a = cfg.arch
    for key, val in (("general.architecture", a), ("general.name", "chip-smoke"),
                     (f"{a}.embedding_length", cfg.dim),
                     (f"{a}.block_count", cfg.n_layers),
                     (f"{a}.attention.head_count", cfg.n_heads),
                     (f"{a}.attention.head_count_kv", cfg.n_kv_heads),
                     (f"{a}.attention.key_length", cfg.head_dim),
                     (f"{a}.feed_forward_length", cfg.hidden_dim),
                     (f"{a}.attention.layer_norm_rms_epsilon", cfg.norm_eps),
                     (f"{a}.rope.freq_base", cfg.rope_theta),
                     (f"{a}.rope.dimension_count", cfg.head_dim),
                     (f"{a}.context_length", cfg.max_seq_len),
                     (f"{a}.vocab_size", cfg.vocab_size)):
        w.add(key, val)
    for key, val in build_vocab(cfg.vocab_size).items():
        w.add(key, val)
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(name: str, *shape: int) -> None:
        t = torch.randn(shape, generator=gen, device=device) * 0.02
        if wtype is not None:
            qt = wtype(name) if callable(wtype) else wtype
            w.add_tensor_bytes(name, shape, qt, quantize(qt, t.cpu().numpy().reshape(-1)))
            return
        w.add_tensor_bytes(name, shape, GGMLType.BF16,
                           t.bfloat16().view(torch.int16).cpu().numpy().tobytes())

    def ones(name: str, n: int) -> None:
        w.add_tensor(name, torch.ones(n).numpy(), GGMLType.F32)

    D, H, K, Hd, Fd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim
    rnd("token_embd.weight", cfg.vocab_size, D)
    ones("output_norm.weight", D)
    for i in range(cfg.n_layers):
        ones(f"blk.{i}.attn_norm.weight", D)
        ones(f"blk.{i}.ffn_norm.weight", D)
        rnd(f"blk.{i}.attn_q.weight", H * Hd, D)
        rnd(f"blk.{i}.attn_k.weight", K * Hd, D)
        rnd(f"blk.{i}.attn_v.weight", K * Hd, D)
        rnd(f"blk.{i}.attn_output.weight", D, H * Hd)
        rnd(f"blk.{i}.ffn_gate.weight", Fd, D)
        rnd(f"blk.{i}.ffn_up.weight", Fd, D)
        rnd(f"blk.{i}.ffn_down.weight", D, Fd)
    w.write()


async def stream_chat(s, base: str, body: dict,
                      first: asyncio.Event | None = None) -> dict:
    """POST one /chat and collect its SSE events with the client-side
    first- and last-token times; ``first`` is set at the first token."""
    t0, t_first, t_last, events = time.monotonic(), None, None, []
    async with s.post(f"{base}/chat", json=body) as r:
        if r.status != 200 or not r.headers["Content-Type"].startswith(
                "text/event-stream"):
            fail(f"/chat answered {r.status} {r.headers['Content-Type']}")
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            ev = json.loads(line[6:])
            events.append(ev)
            if ev["msg_type"] == "token":
                t_last = time.monotonic()
                t_first = t_first or t_last
                if first is not None:
                    first.set()
    return {"body": body, "events": events, "t0": t0, "t_first": t_first,
            "t_last": t_last}


async def chat_requests(server, requests: list[dict],
                        lead: int | None = None) -> tuple[dict, list[dict]]:
    """Boot ``server`` (a port ChatServer) on a free localhost port and POST
    each request to /chat: one after another, or, with ``lead``, that
    request first and all the others together once it streams its first
    token. Returns /healthz (read first) and each request's events in
    request order."""
    import aiohttp
    from aiohttp import web

    runner = web.AppRunner(server.app)
    await runner.setup()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    site = web.SockSite(runner, sock)
    await site.start()
    base = f"http://127.0.0.1:{sock.getsockname()[1]}"
    try:
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=600)) as s:
            async with s.get(f"{base}/healthz") as r:
                health = await r.json()
            if lead is None:
                return health, [await stream_chat(s, base, b) for b in requests]
            first = asyncio.Event()
            lead_task = asyncio.create_task(
                stream_chat(s, base, requests[lead], first))
            lead_task.add_done_callback(lambda _: first.set())
            await first.wait()
            rest = {i: asyncio.create_task(stream_chat(s, base, b))
                    for i, b in enumerate(requests) if i != lead}
            out = {lead: await lead_task}
            for i, t in rest.items():
                out[i] = await t
            return health, [out[i] for i in range(len(requests))]
    finally:
        await runner.cleanup()   # closes a slot scheduler too


def check_sse(res: dict) -> dict:
    """The reference's SSE shape: log and token events, closed by the done
    summary (a log event with finish_reason and n_gen)."""
    events, body = res["events"], res["body"]
    if not events or any(e["msg_type"] not in ("log", "token") for e in events):
        fail(f"bad SSE event kinds: {events[:3]}")
    last = events[-1]
    if last["msg_type"] != "log" or last.get("finish_reason") not in ("length", "stop"):
        fail(f"stream did not end with a done summary: {last}")
    n_gen = last["n_gen"]
    if last["finish_reason"] == "length" and n_gen != body["max_new_tokens"]:
        fail(f"finish 'length' after {n_gen} of {body['max_new_tokens']} tokens")
    if n_gen and not any(e["msg_type"] == "token" for e in events):
        fail("no token events")
    if not any("offloaded" in e["content"] for e in events if e["msg_type"] == "log"):
        fail("no placement log line")
    m = re.search(r"TTFT ([\d.]+) ms \| decode ([\d.naif]+) tok/s", last["content"])
    return {"n_gen": n_gen, "finish_reason": last["finish_reason"],
            "engine_ttft_ms": float(m.group(1)), "engine_decode_tok_s": float(m.group(2)),
            "client_ttft_ms": (res["t_first"] - res["t0"]) * 1e3,
            "client_decode_tok_s": (n_gen - 1) / (res["t_last"] - res["t_first"])
            if n_gen > 1 and res["t_last"] > res["t_first"] else None,
            "text_chars": sum(len(e["content"]) for e in events
                              if e["msg_type"] == "token")}


def profile_decode(engine, steps: int = 8, on_ready=None) -> dict:
    """Where a single-stream decode step's time goes, 512 tokens into the
    dense cache. ``on_ready`` is called once the cache is filled, before
    the steps."""
    cache = engine.make_cache()
    engine.prefill(list(range(3, 515)), cache)
    tok = torch.tensor([[7]], device=engine.device)
    if on_ready is not None:
        on_ready()
    return profile_steps(lambda: engine.model(tok, cache), steps)


def profile_paged_decode(engine, B: int = 4, length: int = 512,
                         steps: int = 8, on_ready=None, fused: bool = False) -> dict:
    """Where a batched decode step of the slots path goes: B rows, each
    ``length`` tokens into its own blocks of the paged pool; ``fused`` runs
    the fused decode step."""
    cache = engine.make_paged_cache(B)
    NT = cache.tables.shape[1]
    cache.tables = (1 + torch.arange(B * NT, device=engine.device)
                    ).reshape(B, NT).to(torch.int32)
    tok = torch.full((B, 1), 7, device=engine.device)

    def step():
        cache.length = torch.full((B,), length, dtype=torch.int32,
                                  device=engine.device)
        engine.model.forward_paged(tok, cache, fused=fused)

    if on_ready is not None:
        on_ready()
    return profile_steps(step, steps)


def profile_steps(step, steps: int) -> dict:
    """Wall time per step (host clock around synchronized steps), device
    time per step and its top kernels (torch.profiler), the device's busy
    share, and where the host's time goes: the Python functions with the
    largest self time over the steps (cProfile, which slows the host it
    measures, so only the shares compare)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    run()                   # warm-up
    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats      # {func: (cc, nc, tt, ct, callers)}
    total = sum(v[2] for v in stats.values())
    host_top = sorted(((f"{Path(k[0]).name}:{k[1]}:{k[2]}", v[2] / total, v[1] / steps)
                       for k, v in stats.items()), key=lambda r: -r[1])[:10]
    return {"wall_ms_per_step": wall * 1e3, "device_ms_per_step": device,
            "device_busy_share": device / (wall * 1e3),
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [[n[:100], ms] for n, ms in top],
            "host_top_self_share_calls_per_step": host_top,
            "steps_run": 4 * steps}    # warm-up, wall, torch.profiler, cProfile


class QuantWatch:
    """Holds a served run's quantized matmul launches to what its forwards
    call for: every packed projection one launch of the kernel that
    ``qm.route`` names for its kind and the forward's M = B·T (W8A8 at M ≤ 32
    and fused dequant above; int8's kernel at every M); a packed head sees
    M = B·T of the positions it scores. It wraps the model's
    ``embed_tokens`` and ``lm_logits`` (once per forward each) to record M.
    A kind with no fused-dequant kernel (q5_ks, q2_ks, q3_ks) launches
    nothing at M > 32: its calls of ``qm.dequant_linear``, which the watch
    wraps until ``close``, count in place of the launches."""

    def __init__(self, qm, model):
        from collections import Counter

        self.qm, self.body, self.head = qm, [], []
        self.linear = 0
        self._route = route = qm.dequant_linear

        def dequant_linear(*args, **kw):
            self.linear += 1
            return route(*args, **kw)

        qm.dequant_linear = dequant_linear
        self.served: dict[str, int] = {}   # the launches the last check held
        self.layer_kinds = Counter(m.kind for blk in model.layers for m in blk.children()
                                   if isinstance(m, qm.QuantPack))
        # the projections a fused decode step computes inside its kernel
        self.attn_kinds = Counter(blk._modules[n].kind for blk in model.layers
                                  for n in ("wq", "wk", "wv", "wo")
                                  if isinstance(blk._modules.get(n), qm.QuantPack))
        head = getattr(model, "lm_head", None)
        self.head_kind = head.kind if isinstance(head, qm.QuantPack) else None
        embed, logits = model.embed_tokens, model.lm_logits

        def embed_tokens(tokens):
            self.body.append(tokens.numel())
            return embed(tokens)

        def lm_logits(x):
            self.head.append(x.shape[0] * x.shape[1])
            return logits(x)

        model.embed_tokens, model.lm_logits = embed_tokens, lm_logits

    def close(self) -> None:
        self.qm.dequant_linear = self._route

    def reset(self) -> None:
        self.body.clear()
        self.head.clear()
        self.linear = 0
        for k in self.qm.launches:
            self.qm.launches[k] = 0

    def check(self, what: str, fused_m: list[int] = ()) -> dict:
        """Fail unless the launches since ``reset`` are what the forwards
        call for, kernel by kernel; returns them. ``fused_m`` lists the M of
        the forwards whose attention half ran fused: their attention packs
        launch nothing of their own."""
        want: dict[str, int] = {}
        linear = 0
        calls = [(kind, n, M) for M in self.body for kind, n in self.layer_kinds.items()]
        calls += [(kind, -n, M) for M in fused_m for kind, n in self.attn_kinds.items()]
        if self.head_kind:
            calls += [(self.head_kind, 1, M) for M in self.head]
        for kind, n, M in calls:
            name = self.qm.route(kind, M)
            if name is None:
                linear += n
            else:
                want[name] = want.get(name, 0) + n
        got = {k: v for k, v in self.qm.launches.items() if v}
        self.served = got
        if not self.body or got != want or self.linear != linear:
            fail(f"{what}: quant kernel launches {got} and {self.linear} dequant_linear "
                 f"calls, the forwards call for {want} and {linear} ({len(self.body)} "
                 f"forwards, layer packs {dict(self.layer_kinds)}, head {self.head_kind})")
        cut = self.qm.W8A8_MAX_M
        return {"forwards": len(self.body), "fused_forwards": len(fused_m),
                "forwards_w8a8": sum(m <= cut for m in self.body),
                "forwards_dequant": sum(m > cut for m in self.body),
                "layer_packs": dict(self.layer_kinds), "head": self.head_kind,
                "launches": got, "dequant_linear_calls": self.linear}


def serve_single(engine, requests: list[dict], card: str, fa, watch=None) -> int:
    """Phases 4 and 7: warm up on the requests through the engine, then
    serve them as POST /chat through a single-stream ChatServer; returns the
    attention kernel's launches in the served run."""
    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig
    from distributed_llm_pipeline_tpu_torch.serving import ChatServer

    # the first request after boot pays CUDA's lazy kernel loading
    for i, body in enumerate(requests):
        gen = GenerationConfig(**{k: v for k, v in body.items() if k != "prompt"})
        warm = list(engine.generate(body["prompt"], gen))[-1]
        print(json.dumps({"warm_up": i, "done": warm.content,
                          "ttft_ms": warm.data["ttft_ms"], "card": card}), flush=True)
    fa.launches = 0
    if watch is not None:
        watch.reset()
    forwards0 = engine.forwards
    health, results = asyncio.run(chat_requests(
        ChatServer(engine, GenerationConfig(max_new_tokens=32)), requests))
    launches = fa.launches
    forwards = engine.forwards - forwards0
    if health.get("status") != "ok" or health.get("n_layers") != engine.cfg.n_layers:
        fail(f"/healthz: {health}")
    for i, res in enumerate(results):
        summary = check_sse(res)
        print(json.dumps({"request": i, "quant": engine.quant,
                          "sampled": res["body"]["temperature"] > 0,
                          **summary, "card": card}), flush=True)
    n_layers = engine.cfg.n_layers
    if forwards <= 0 or launches != n_layers * forwards:
        fail(f"flash_attention launched {launches} times for {forwards} forwards "
             f"of {n_layers} layers")
    print(f"served path (quant {engine.quant}): {forwards} forwards, {launches} "
          f"flash_attention launches (= {n_layers} layers x forwards)", flush=True)
    if watch is not None:
        print(json.dumps({"quant_served": engine.quant,
                          **watch.check(f"single stream, quant {engine.quant}"),
                          "card": card}), flush=True)
    return launches


def profile_quant_step(engine, profile, qm, card: str) -> None:
    """A profiled quantized decode step, holding each packed projection to
    one launch per step (W8A8, or int8's kernel), counted from the steps
    alone (a cache's prefill launches the prefill routes)."""
    def reset():
        for k in qm.launches:
            qm.launches[k] = 0

    row = profile(engine, steps=8, on_ready=reset)
    per_step = sum(qm.launches.values()) / row["steps_run"]
    layer_packs = sum(isinstance(m, qm.QuantPack)
                      for blk in engine.model.layers for m in blk.children())
    head = isinstance(getattr(engine.model, "lm_head", None), qm.QuantPack)
    if per_step != layer_packs + head:
        fail(f"quantized decode step: {per_step} W8A8 launches per step, "
             f"{layer_packs} layer packs, head packed {head}")
    print(json.dumps({"quant_decode_step": {"quant": engine.quant, **row,
                                            "w8a8_launches_per_step": per_step},
                      "card": card}), flush=True)


# --------------------------------------------------------------------------
# phase 6: served logits, kernel against plain attention, paged against dense

def greedy_run(engine, ids: torch.Tensor, steps: list[torch.Tensor] | None,
               paged: bool = False, fused: bool = False,
               chunk: int | None = None) -> tuple[list, list]:
    """A prefill of ``ids`` and four decode steps on the dense cache (or,
    ``paged``, on a pool, the decode steps ``fused`` or not): the logits at
    each position and the tokens fed, ``steps`` or, when None, the greedy
    continuation. ``chunk``: the dense prefill runs as forwards of that
    many tokens each, as a mesh prefills."""
    model = engine.model
    if paged:
        cache = engine.make_paged_cache(1)
        NT = cache.tables.shape[1]
        cache.tables = torch.arange(1, NT + 1, dtype=torch.int32,
                                    device=engine.device)[None]
        outs = [model.forward_paged_last(ids, cache, ids.shape[1] - 1)]
    else:
        cache = engine.make_cache()
        step = chunk or ids.shape[1]
        for c in range(0, ids.shape[1], step):
            last = model.forward_last(ids[:, c:c + step], cache, step - 1)
        outs = [last]
    fed = []
    for i in range(4):
        tok = (outs[-1].argmax(-1) if steps is None else steps[i]).view(1, 1)
        fed.append(tok)
        outs.append((model.forward_paged(tok, cache, fused=fused) if paged
                     else model(tok, cache))[:, -1])
    return outs, fed


def prompt_ids(engine, seed: int) -> torch.Tensor:
    """A 512-token prompt of random ids from ``seed``, on the engine's device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(3, engine.cfg.vocab_size, (1, 512), generator=g).to(engine.device)


def compare_logits(engine, module, name: str, plain, seed: int,
                   tol: float = LOGIT_TOL, paged: bool = False,
                   prompts: int = 1) -> dict:
    """A 512-token prefill and four greedy decode steps, once through the
    kernels and once with ``module.name`` swapped for ``plain`` (both on the
    card, same weights and tokens), held within ``tol``; on the dense cache,
    or on a pool with ``paged``; over ``prompts`` prompts (seeds ``seed``,
    ``seed + 1``, ...)."""
    runs = []
    for i in range(prompts):
        ids = prompt_ids(engine, seed + i)
        # the greedy continuation, fed to both runs
        steps = greedy_run(engine, ids, None, paged)[1]
        kern = greedy_run(engine, ids, steps, paged)[0]
        orig = getattr(module, name)
        setattr(module, name, plain)
        try:
            runs.append((kern, greedy_run(engine, ids, steps, paged)[0]))
        finally:
            setattr(module, name, orig)
    return hold_prompts(runs, "kernel", "plain", tol)


def compare_paged_logits(engine, seed: int) -> dict:
    """The same 512-token prefill and four greedy decode steps through the
    paged forward on a pool (paged kernel) and through the dense forward
    (dense kernel)."""
    ids = prompt_ids(engine, seed)
    dense, fed = greedy_run(engine, ids, None)
    paged = greedy_run(engine, ids, fed, paged=True)[0]
    return hold_logits(paged, dense, "paged", "dense")


def logit_gap(got: list[torch.Tensor], want: list[torch.Tensor],
              a_name: str, b_name: str, tol: float) -> tuple[dict, list[str]]:
    """Max abs logit error by position and argmax agreement, a near tie of
    ``want``'s top two within ``tol`` excepted; with what breaks ``tol``."""
    errs, near_ties, problems = [], 0, []
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            problems.append("non-finite logits")
        errs.append((a - b).abs().max().item())
        ka, pa = a.argmax(-1).item(), b.argmax(-1).item()
        if ka != pa:
            # only a near tie of the reference run's top two may swap
            top2 = b[0].topk(2).values
            if (top2[0] - top2[1]).item() > tol or (b[0, pa] - b[0, ka]).item() > tol:
                problems.append(f"argmax differs: {a_name} {ka}, {b_name} {pa}")
            near_ties += 1
    if max(errs) > tol:
        problems.append(f"logits differ by {max(errs)} > {tol} (by position: {errs})")
    return {"positions": len(got), "max_abs_err": max(errs), "by_position": errs,
            "tol": tol, "argmax_near_ties": near_ties}, problems


def hold_logits(got: list[torch.Tensor], want: list[torch.Tensor],
                a_name: str, b_name: str, tol: float = LOGIT_TOL) -> dict:
    """Max abs logit error within ``tol`` and the same argmax, except at a
    near tie of ``want``'s top two within that tolerance."""
    return hold_prompts([(got, want)], a_name, b_name, tol)


def measure_prompts(runs: list[tuple[list, list]], a_name: str, b_name: str,
                    tol: float) -> tuple[dict, str | None]:
    """``logit_gap`` over the (got, want) runs of several prompts: the
    readings, and what breaks ``tol`` (None when nothing does)."""
    gaps = [logit_gap(got, want, a_name, b_name, tol) for got, want in runs]
    problems = [f"prompt {i}: {p}" for i, (_, ps) in enumerate(gaps) for p in ps]
    by_prompt = [g["max_abs_err"] for g, _ in gaps]
    if len(gaps) == 1:
        summary = gaps[0][0]
    else:
        summary = {"prompts": len(gaps),
                   "positions": sum(g["positions"] for g, _ in gaps),
                   "max_abs_err": max(by_prompt), "by_prompt": by_prompt, "tol": tol,
                   "argmax_near_ties": sum(g["argmax_near_ties"] for g, _ in gaps)}
    if not problems:
        return summary, None
    return summary, (f"{a_name} against {b_name} (max abs logit error by prompt "
                     f"{by_prompt}): {'; '.join(problems)}")


def hold_prompts(runs: list[tuple[list, list]], a_name: str, b_name: str,
                 tol: float) -> dict:
    """``hold_logits`` over the (got, want) runs of several prompts: all are
    measured before any is held, so a failure names every reading."""
    summary, problem = measure_prompts(runs, a_name, b_name, tol)
    if problem:
        fail(problem)
    return summary


# --------------------------------------------------------------------------
# phase 5: the served path, four slots over the paged pool

def slot_requests(seed: int) -> list[dict]:
    """The four /chat bodies of the slots phase. Letters outside the
    vocabulary's pieces encode as byte tokens, so random letters give
    prompts that share no block with each other."""
    import random

    rnd = random.Random(seed)

    def letters(n: int) -> str:
        return "".join(rnd.choice("abcdfgijkmnpqrstuvwxyz") for _ in range(n))

    prefix = " ".join(["hello"] * 480)     # ~480 tokens: 7 full blocks of 64
    greedy = {"max_new_tokens": 32, "temperature": 0.0, "stop_on_eos": False}
    return [
        {"prompt": f"{prefix} {letters(19)}", **greedy},
        {"prompt": f"{prefix} {letters(19)}", **greedy},
        {"prompt": letters(1000), **greedy},          # chunked prefill
        {"prompt": "hello hello", "max_new_tokens": 32, "temperature": 0.8,
         "top_k": 40, "top_p": 0.95, "seed": 1},
    ]


def serve_slots(engine, pa, fa, cfg, card: str, seed: int, watch=None,
                attn=None, fd=None) -> dict:
    """Phases 5, 7-9 and 10: ChatServer(parallel=4) answers four concurrent
    /chat requests; returns the attention kernels' launches in that run by
    name. ``attn`` is the pool's attention module (the paged kernel's, or
    the latent kernel's on a latent engine); with ``fd`` (the fused module)
    and a scheduler that resolved the fused step, every T = 1 decode
    forward must launch the fused kernel once per layer and no pool
    attention. ``watch`` (a QuantWatch) holds a quantized engine's matmul
    launches too."""
    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig
    from distributed_llm_pipeline_tpu_torch.serving import ChatServer

    attn = attn or pa
    server = ChatServer(engine, GenerationConfig(max_new_tokens=32), parallel=4)
    sched = server.scheduler
    backend = sched._backend
    fused = fd is not None and sched.fused_decode
    if (fd is not None) != fused:
        fail(f"the slots' fused decode resolved {sched.fused_decode}: "
             f"{[e.content for e in engine._events_on_load][-1]}")
    pool_bytes = backend.n_blocks * backend.block_bytes
    held = sum(sched._bufs[n].nbytes for n in ("k", "v", "ks", "vs")
               if sched._bufs.get(n) is not None)
    if pool_bytes != held:
        fail(f"the KV pool holds {held} bytes, kv_token_bytes says {pool_bytes}")
    # warm-up through the scheduler, on prompts that share no block with the
    # measured ones: lazy kernel loading, one chunked and one short prefill
    for body in slot_requests(seed + 100)[2:]:
        warm = list(sched.generate(body["prompt"], GenerationConfig(
            **{k: v for k, v in body.items() if k != "prompt"})))[-1]
        print(json.dumps({"slots_warm_up": warm.content, "card": card}), flush=True)
    requests = slot_requests(seed)
    sched.counters = dict.fromkeys(sched.counters, 0)
    forwards0 = sched.forwards
    pa.launches = fa.launches = attn.launches = 0
    if fd is not None:
        fd.launches = 0
    if watch is not None:
        watch.reset()
    fused0 = engine.model.fused_forwards
    t0 = time.monotonic()
    health, results = asyncio.run(chat_requests(server, requests, lead=0))
    wall = time.monotonic() - t0
    launches, dense_launches = attn.launches, fa.launches
    other_launches = pa.launches if attn is not pa else 0
    fused_launches = fd.launches if fd is not None else 0
    forwards = sched.forwards - forwards0
    # the forwards the model routed through the fused step: decode steps,
    # each over every slot row (M = 4)
    n_fused = engine.model.fused_forwards - fused0
    fused_m = [sched.n_slots] * n_fused
    if health.get("slots_total") != 4 or health.get("queue_depth") != 0:
        fail(f"/healthz under --parallel 4: {health}")
    summaries = []
    for i, res in enumerate(results):
        summary = check_sse(res)
        summaries.append(summary)
        print(json.dumps({"slots_request": i, "quant": engine.quant,
                          "prompt_chars": len(res["body"]["prompt"]),
                          "sampled": res["body"]["temperature"] > 0, **summary,
                          "card": card}), flush=True)
    c = sched.counters
    if c["paged_prefix_hits_total"] < 1:
        fail(f"no paged prefix hit in the slots run: {c}")
    if c["prefill_steps_stolen_total"] < 1:
        fail(f"no mixed step stole from a decoding stream: {c}")
    name = attn.__name__.rsplit(".", 1)[-1]
    if (forwards <= 0 or launches != cfg.n_layers * (forwards - n_fused)
            or fused_launches != cfg.n_layers * n_fused or (fused and not n_fused)
            or dense_launches or other_launches):
        fail(f"{name} launched {launches} times and fused_decode_attn "
             f"{fused_launches} for {forwards} paged forwards ({n_fused} fused) of "
             f"{cfg.n_layers} layers (dense kernel: {dense_launches}, paged kernel "
             f"beside the latent one: {other_launches})")
    n_gen = sum(s["n_gen"] for s in summaries)
    first = min(r["t0"] for r in results)
    last = max(r["t_last"] for r in results)
    if watch is not None:
        print(json.dumps({"quant_served": engine.quant, "parallel": 4,
                          **watch.check(f"slots, quant {engine.quant}", fused_m),
                          "card": card}), flush=True)
    print(json.dumps({"slots_served": {
        "quant": engine.quant, "kv_quant": engine.kv_quant, "kv_mode": engine.kv_mode,
        "latent_rank": engine.kv_latent_rank, "fused_decode": fused,
        "requests": len(results), "tokens": n_gen, "wall_s": wall,
        "aggregate_tok_s": n_gen / (last - first), "paged_forwards": forwards,
        "fused_forwards": n_fused, "attention_launches": {name: launches},
        "fused_launches": fused_launches, "counters": c,
        "kv_pool": {"blocks": backend.n_blocks, "block_size": backend.bs,
                    "bytes": pool_bytes},
        "card": card}}), flush=True)
    print(f"slots path: {forwards} paged forwards ({n_fused} fused decode), "
          f"{launches} {name} launches (= {cfg.n_layers} layers x unfused "
          f"forwards), {fused_launches} fused_decode_attn launches (= "
          f"{cfg.n_layers} x fused forwards), 0 dense launches", flush=True)
    return {name: launches, "fused_decode_attn": fused_launches}


ROUTE_MESSAGES = [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "hello hello"}]


async def post_route(s, base: str, route: str, body: dict) -> dict:
    """POST one completion route: the JSON answer, or with ``stream`` the
    SSE payloads; with the client-side send, first-payload and last-payload
    times."""
    t0 = time.monotonic()
    t_first = t_last = None
    async with s.post(f"{base}{route}", json=body) as r:
        if r.status != 200:
            fail(f"{route} answered {r.status}: {await r.text()}")
        if not body.get("stream"):
            answer = await r.json()
            t_last = time.monotonic()
        else:
            if not r.headers["Content-Type"].startswith("text/event-stream"):
                fail(f"{route} streamed {r.headers['Content-Type']}")
            answer = []
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                answer.append(line[6:] if line[6:] == "[DONE]" else json.loads(line[6:]))
                t_last = time.monotonic()
                t_first = t_first or t_last
    return {"route": route, "body": body, "answer": answer, "t0": t0,
            "t_first": t_first, "t_last": t_last}


async def route_requests(server, requests: list[tuple[str, dict]],
                         together: bool = False) -> list[dict]:
    """Boot ``server`` (a port ChatServer) on a free localhost port and POST
    each (route, body): one after another, or all at once."""
    import aiohttp
    from aiohttp import web

    runner = web.AppRunner(server.app)
    await runner.setup()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    site = web.SockSite(runner, sock)
    await site.start()
    base = f"http://127.0.0.1:{sock.getsockname()[1]}"
    try:
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=600)) as s:
            if together:
                return list(await asyncio.gather(
                    *(post_route(s, base, r, b) for r, b in requests)))
            return [await post_route(s, base, r, b) for r, b in requests]
    finally:
        await runner.cleanup()   # closes a slot scheduler too


def route_text(res: dict) -> tuple[str, int, str]:
    """(text, tokens generated, finish) of a completion route's answer,
    whole or streamed, in either dialect."""
    route, a = res["route"], res["answer"]
    llama = route == "/completion"
    if isinstance(a, list):
        chunks = [c for c in a if c != "[DONE]"]
        if llama:
            last = chunks[-1]
            return ("".join(c["content"] for c in chunks), last["tokens_predicted"],
                    "stop" if last["stopped_eos"] else "length")
        key = "delta" if route == "/v1/chat/completions" else None
        text = "".join((c["choices"][0][key].get("content", "") if key
                        else c["choices"][0]["text"]) for c in chunks)
        n = sum(1 for c in chunks if (c["choices"][0]["delta"].get("content") if key
                                      else c["choices"][0]["text"]))
        return text, n, chunks[-1]["choices"][0]["finish_reason"]
    if llama:
        return (a["content"], a["tokens_predicted"],
                "stop" if a["stopped_eos"] else "length")
    c = a["choices"][0]
    text = c["message"]["content"] if route == "/v1/chat/completions" else c["text"]
    return text, a["usage"]["completion_tokens"], c["finish_reason"]


def route_logprobs(res: dict) -> list[tuple[str, float | None, list[float], str]]:
    """Per token (its text, its logprob or None, the top logprobs, the top-1
    text) of an answer that carries logprobs."""
    route, a = res["route"], res["answer"]
    out = []
    if route == "/completion":
        for c in (a if isinstance(a, list) else [a]):
            for p in c.get("completion_probabilities") or []:
                out.append((p["content"], None,
                            [math.log(x["prob"]) for x in p["probs"]],
                            p["probs"][0]["tok_str"]))
        return out
    chunks = [c for c in a if c != "[DONE]"] if isinstance(a, list) else [a]
    for c in chunks:
        lp = c["choices"][0]["logprobs"]
        if not lp:
            continue
        if route == "/v1/chat/completions":
            for e in lp["content"]:
                top = e["top_logprobs"]
                out.append((e["token"], e["logprob"], [t["logprob"] for t in top],
                            top[0]["token"]))
        else:
            for tok, v, top in zip(lp["tokens"], lp["token_logprobs"], lp["top_logprobs"]):
                out.append((tok, v, list(top.values()), next(iter(top))))
    return out


def check_greedy_logprobs(res: dict, what: str) -> int:
    """A greedy answer's logprobs: each token's top logprobs sorted and <= 0,
    and the token's logprob the top value (OpenAI), or the token the top one
    unless the top two tie (llama-server's answer has no logprob of the
    token itself; bf16 logits of a 128256-token vocabulary tie now and
    then). Returns the tokens checked."""
    rows = route_logprobs(res)
    if not rows:
        fail(f"{what}: no logprobs in {str(res['answer'])[:300]}")
    for tok, v, top, top_tok in rows:
        if top != sorted(top, reverse=True) or any(x > 0 for x in top):
            fail(f"{what}: top logprobs not sorted or above 0: {top}")
        tie = len(top) > 1 and top[0] == top[1]
        if v is not None and v != top[0] or v is None and tok != top_tok and not tie:
            fail(f"{what}: greedy token {tok!r} ({v}) is not the top one "
                 f"{top_tok!r} ({top[0]})")
    return len(rows)


def route_line(res: dict, path: str, card: str) -> dict:
    """One route's client-side numbers: TTFT (streamed answers: send to the
    first payload) and tok/s (streamed: first to last payload; whole: send
    to answer)."""
    text, n_gen, finish = route_text(res)
    stream = bool(res["body"].get("stream"))
    if stream:
        ttft = (res["t_first"] - res["t0"]) * 1e3
        span = res["t_last"] - res["t_first"]
        tok_s = (n_gen - 1) / span if n_gen > 1 and span > 0 else None
    else:
        ttft, span = None, res["t_last"] - res["t0"]
        tok_s = n_gen / span if span > 0 else None
    line = {"route": res["route"], "path": path, "stream": stream, "n_gen": n_gen,
            "finish": finish, "client_ttft_ms": ttft, "client_tok_s": tok_s,
            "card": card}
    print(json.dumps({"route_served": line}), flush=True)
    return line


def serve_routes(engine, fa, pa, cfg, card: str, seed: int) -> dict:
    """Phase 12: the llama-server / OpenAI routes on the phase 4-5 engine,
    one stream and then 4 slots. Returns each path's attention launches."""
    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig
    from distributed_llm_pipeline_tpu_torch.serving import ChatServer

    n = 32
    greedy = {"temperature": 0.0}
    gen = GenerationConfig(max_new_tokens=n)
    # the greedy tokens of the llama-server prompt, read off the engine: the
    # biased requests ban the first eight distinct ones of the vocabulary's
    # pieces (a byte token's text is not its own)
    n_special = 3 + 256
    greedy_ids = [e.data["id"] for e in engine.generate("hello hello", GenerationConfig(
        max_new_tokens=n, temperature=0.0, logprobs=1)) if e.kind == "token" and e.data]
    banned = [t for t in dict.fromkeys(greedy_ids) if t >= n_special][:8]
    if not banned:
        fail(f"no greedy token of the vocabulary's pieces to ban: {greedy_ids}")
    banned_text = {engine.tokenizer.token_bytes(t).decode("utf-8", "replace")
                   for t in banned}
    ban = {"prompt": "hello hello", "n_predict": n, **greedy, "n_probs": 1,
           "logit_bias": [[t, False] for t in banned]}
    # μ of a mirostat run, as its done event reports it
    mu = list(engine.generate("hello hello", GenerationConfig(
        max_new_tokens=n, temperature=0.9, mirostat=2, seed=seed)))[-1].data["mirostat_mu"]

    # one stream: /apply-template, then /chat on its prompt, then the routes
    server = ChatServer(engine, gen)
    template = asyncio.run(route_requests(server, [
        ("/apply-template", {"messages": ROUTE_MESSAGES})]))[0]["answer"]["prompt"]
    fa.launches = 0
    forwards0 = engine.forwards
    chat = asyncio.run(chat_requests(ChatServer(engine, gen), [
        {"prompt": template, "max_new_tokens": n, **greedy}]))[1][0]
    chat_text = "".join(e["content"] for e in chat["events"] if e["msg_type"] == "token")
    single = asyncio.run(route_requests(ChatServer(engine, gen), [
        ("/v1/chat/completions", {"messages": ROUTE_MESSAGES, "max_tokens": n, **greedy}),
        ("/v1/chat/completions", {"messages": ROUTE_MESSAGES, "max_tokens": n, **greedy,
                                  "stream": True}),
        ("/completion", {"prompt": "hello hello", "n_predict": n, **greedy,
                         "n_probs": 5}),
        ("/v1/completions", {"prompt": "hello hello", "max_tokens": n, **greedy,
                             "logprobs": 5, "stream": True}),
        ("/completion", ban),
        ("/v1/completions", {"prompt": "hello hello", "max_tokens": n,
                             "temperature": 0.9, "typical_p": 0.9, "seed": seed}),
        ("/completion", {"prompt": "hello hello", "n_predict": n, "temperature": 0.9,
                         "mirostat": 2, "seed": seed, "stream": True})]))
    launches, forwards = fa.launches, engine.forwards - forwards0
    for i, res in enumerate(single):
        if i < 2 and route_text(res)[0] != chat_text:
            fail(f"{res['route']} (stream {bool(res['body'].get('stream'))}) gave "
                 f"{route_text(res)[0]!r}, /chat on the templated prompt {chat_text!r}")
        text, n_gen, finish = route_text(res)
        if finish not in ("stop", "length") or (finish == "length" and n_gen != n):
            fail(f"{res['route']}: {n_gen} tokens, finish {finish}")
    checked = sum(check_greedy_logprobs(single[i], f"one stream, request {i}")
                  for i in (2, 3))
    got = {tok for tok, *_ in route_logprobs(single[4])}
    if got & banned_text or route_text(single[4])[0] == route_text(single[2])[0]:
        fail(f"a banned token was generated: {sorted(got & banned_text)}")
    if not math.isfinite(mu):
        fail(f"mirostat's μ is {mu}")
    n_layers = cfg.n_layers
    if forwards <= 0 or launches != n_layers * forwards:
        fail(f"the routes launched flash_attention {launches} times for {forwards} "
             f"forwards of {n_layers} layers")
    lines = [route_line(r, "single", card) for r in single]
    print(json.dumps({"routes_single": {
        "requests": len(single) + 1, "forwards": forwards,
        "flash_attention_launches": launches, "greedy_logprob_tokens": checked,
        "banned": len(banned), "mirostat_mu": mu, "card": card}}), flush=True)

    # four slots: two logprob requests beside a biased one, all at once
    server = ChatServer(engine, gen, parallel=4)
    sched = server.scheduler
    pa.launches = fa.launches = 0
    forwards0 = sched.forwards
    slots = asyncio.run(route_requests(server, [
        ("/v1/completions", {"prompt": "hello hello", "max_tokens": n, **greedy,
                             "logprobs": 5}),
        ("/v1/chat/completions", {"messages": ROUTE_MESSAGES, "max_tokens": n, **greedy,
                                  "logprobs": True, "top_logprobs": 5, "stream": True}),
        ("/completion", ban)], together=True))
    p_launches, d_launches = pa.launches, fa.launches
    s_forwards = sched.forwards - forwards0
    checked = sum(check_greedy_logprobs(slots[i], f"slots, request {i}") for i in (0, 1))
    got = {tok for tok, *_ in route_logprobs(slots[2])}
    if got & banned_text:
        fail(f"a banned token was generated on the slots: {sorted(got & banned_text)}")
    if s_forwards <= 0 or p_launches != n_layers * s_forwards or d_launches:
        fail(f"the slot routes launched paged_flash_attention {p_launches} times "
             f"(flash_attention {d_launches}) for {s_forwards} paged forwards of "
             f"{n_layers} layers")
    lines += [route_line(r, "slots", card) for r in slots]
    print(json.dumps({"routes_slots": {
        "requests": len(slots), "paged_forwards": s_forwards,
        "paged_attention_launches": p_launches, "greedy_logprob_tokens": checked,
        "card": card}}), flush=True)
    print(f"completion routes: {forwards} forwards one stream ({launches} "
          f"flash_attention launches), {s_forwards} paged forwards on 4 slots "
          f"({p_launches} paged_flash_attention launches) = {n_layers} layers x "
          f"forwards", flush=True)
    return {"flash_attention": launches, "paged_flash_attention": p_launches,
            "routes": lines}


def load_quant_engine(Engine, gguf: Path, quant: str, card: str, unlink: bool):
    """An engine over ``gguf`` with ``quant``, its load line printed; the
    GGUF is deleted once loaded when ``unlink``."""
    t0 = time.monotonic()
    engine = Engine(gguf, max_seq=2048, quant=quant)
    if unlink:
        gguf.unlink()
    print(json.dumps({"quant_engine": quant, "gguf": gguf.name,
                      "up_s": time.monotonic() - t0,
                      "load_log": [e.content for e in engine._events_on_load],
                      "device_bytes": torch.cuda.memory_allocated(),
                      "card": card}), flush=True)
    return engine


def serve_quant(engine, slots: bool, requests: list[dict], fa, pa, qm, llama, cfg,
                card: str, seed: int) -> dict:
    """Phases 7 and 8 for one quantized engine: serve single-stream (the
    phase-4 requests) or on 4 slots (the phase-5 requests) with every
    packed projection's launches held by a QuantWatch, profile a decode
    step, then hold its logits, kernels against plain versions. Returns the
    kernel launches of the served run."""
    def plain_proj(x, w, out_dtype=None, _dense=llama.proj):
        if isinstance(w, qm.QuantPack):
            return qm.quant_matmul_plain(x, w, out_dtype)
        return _dense(x, w, out_dtype)

    watch = QuantWatch(qm, engine.model)
    try:
        if slots:
            serve_slots(engine, pa, fa, cfg, card, seed, watch)
            profile_quant_step(engine, profile_paged_decode, qm, card)
        else:
            serve_single(engine, requests, card, fa, watch)
            profile_quant_step(engine, profile_decode, qm, card)
    finally:
        watch.close()
    print(json.dumps({"quant_logits": engine.quant, **compare_logits(
        engine, llama, "proj", plain_proj, seed, QUANT_LOGIT_TOL)}), flush=True)
    return {k: v for k, v in watch.served.items() if v}


def q3_k_types(name: str):
    """A Q3_K GGUF's type of each matrix: the projections in Q3_K, the
    embedding (which is the head) in Q6_K, as llama.cpp's Q3_K mixes keep
    ``token_embd`` wider."""
    from distributed_llm_pipeline_tpu_torch.gguf import GGMLType

    return GGMLType.Q6_K if name == "token_embd.weight" else GGMLType.Q3_K


# --------------------------------------------------------------------------
# phase 10: --kv-quant q8_0, the fused decode step and latent KV, served

# latent KV at full rank (512 = K·Hd at Llama-3.2-1B) against the dense
# engine: the basis is complete, so only rounding separates them, but the
# latent path rounds twice more per layer in bf16 (the stored latent and the
# absorbed query) on top of the paged-vs-dense differences LOGIT_TOL holds
LATENT_FULL_RANK_TOL = 0.25


def load_kv_engine(Engine, path: Path, card: str, **kw):
    """An engine over the bf16 GGUF with ``kw`` (quant, kv_quant, kv_mode,
    kv_latent_rank), its load line printed."""
    t0 = time.monotonic()
    engine = Engine(path, max_seq=2048, **kw)
    print(json.dumps({"kv_engine": {k: v for k, v in kw.items()},
                      "kv_quant": engine.kv_quant, "kv_mode": engine.kv_mode,
                      "latent_rank": engine.kv_latent_rank,
                      "up_s": time.monotonic() - t0,
                      "load_log": [e.content for e in engine._events_on_load],
                      "card": card}), flush=True)
    return engine


def serve_kv_modes(Engine, path: Path, requests: list[dict], fa, pa, la, fd, qm,
                   llama, cfg, card: str, seed: int) -> dict:
    """Phase 10. Returns the fused and latent kernels' launches of their
    served runs by kernel module name.

    1. ``Engine(kv_quant="q8_0")``, one stream, the phase-4 requests: its
       cache is int8 and flash_attention launches once per layer and
       forward; a profiled decode step; logits kernel against plain.
    2. ``DLP_FUSED_DECODE=1``, ``ChatServer(parallel=4)``, the phase-5
       requests, twice: bf16 weights and pool, then ``quant="q8_0"`` weights
       with ``kv_quant="q8_0"`` pools. Every T = 1 decode forward launches
       fused_decode_attn once per layer and no paged attention; logits of
       fused against unfused decode steps on the same engine; a profiled
       fused decode step.
    3. ``DLP_KV_LATENT=1`` at the default rank (128): one stream (the
       phase-4 requests; flash_attention at head dim r), then
       ``parallel=4`` on q8_0 latent pools (latent_flash_attention once per
       layer and paged forward); a profiled decode step and logits kernel
       against plain on each. Then full rank (512) against the dense
       engine."""
    import os

    names = ("DLP_FUSED_DECODE", "DLP_KV_LATENT", "DLP_KV_LATENT_RANK")
    saved = {k: os.environ.get(k) for k in names}

    def setenv(**kw) -> None:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update(kw)

    out = {}
    try:
        setenv()
        engine = load_kv_engine(Engine, path, card, kv_quant="q8_0")
        if engine.make_cache().k.dtype != torch.int8:
            fail("--kv-quant q8_0 engine's cache is not int8")
        serve_single(engine, requests, card, fa)
        print(json.dumps({"kv_q8_0_decode_step": profile_decode(engine), "card": card}),
              flush=True)
        print(json.dumps({"kv_q8_0_logits": compare_logits(
            engine, llama, "attention_any", fa.flash_attention_plain, seed,
            KV_MODE_LOGIT_TOL, prompts=LOGIT_PROMPTS)}), flush=True)
        del engine
        torch.cuda.empty_cache()

        setenv(DLP_FUSED_DECODE="1")
        for quant, kv_quant in ((None, None), ("q8_0", "q8_0")):
            engine = load_kv_engine(Engine, path, card, quant=quant, kv_quant=kv_quant)
            watch = QuantWatch(qm, engine.model) if quant else None
            try:
                got = serve_slots(engine, pa, fa, cfg, card, seed, watch=watch, fd=fd)
            finally:
                if watch is not None:
                    watch.close()
            if quant is None:
                out["fused_decode_attn"] = got["fused_decode_attn"]
            runs = []
            for i in range(LOGIT_PROMPTS):
                ids = prompt_ids(engine, seed + i)
                unfused, fed = greedy_run(engine, ids, None, paged=True)
                runs.append((greedy_run(engine, ids, fed, paged=True, fused=True)[0],
                             unfused))
            print(json.dumps({"fused_logits": {
                "quant": quant, "kv_quant": kv_quant, **hold_prompts(
                    runs, "fused", "unfused",
                    FUSED_QUANT_LOGIT_TOL if quant else KV_MODE_LOGIT_TOL)}}), flush=True)

            def reset():
                fd.launches = 0

            row = profile_paged_decode(engine, on_ready=reset, fused=True)
            per_step = fd.launches / row["steps_run"]
            if per_step != cfg.n_layers:
                fail(f"fused decode step: {per_step} fused_decode_attn launches per step")
            print(json.dumps({"fused_decode_step_b4": {
                "quant": quant, "kv_quant": kv_quant, **row,
                "fused_launches_per_step": per_step}, "card": card}), flush=True)
            del engine
            torch.cuda.empty_cache()

        setenv(DLP_KV_LATENT="1")
        engine = load_kv_engine(Engine, path, card)
        if engine.kv_mode != "latent" or engine.kv_latent_rank != 128:
            fail(f"DLP_KV_LATENT=1: kv_mode {engine.kv_mode}, rank {engine.kv_latent_rank}")
        serve_single(engine, requests, card, fa)
        print(json.dumps({"latent_decode_step": profile_decode(engine), "card": card}),
              flush=True)
        print(json.dumps({"latent_logits": {"rank": 128, **compare_logits(
            engine, llama, "attention_any", fa.flash_attention_plain, seed,
            KV_MODE_LOGIT_TOL, prompts=LOGIT_PROMPTS)}}), flush=True)
        del engine
        engine = load_kv_engine(Engine, path, card, kv_quant="q8_0")
        got = serve_slots(engine, pa, fa, cfg, card, seed, attn=la)
        out["latent_attention"] = got["latent_attention"]
        print(json.dumps({"latent_paged_decode_step_b4": profile_paged_decode(engine),
                          "card": card}), flush=True)
        print(json.dumps({"latent_paged_logits": {"rank": 128, "kv_quant": "q8_0",
                                                  **compare_logits(
            engine, llama, "latent_attention_any", la.latent_attention_plain, seed,
            KV_MODE_LOGIT_TOL, paged=True, prompts=LOGIT_PROMPTS)}}), flush=True)
        del engine
        torch.cuda.empty_cache()

        setenv()
        dense = load_kv_engine(Engine, path, card)
        full = load_kv_engine(Engine, path, card, kv_mode="latent", kv_latent_rank=512)
        runs = []
        for i in range(LOGIT_PROMPTS):
            ids = prompt_ids(dense, seed + 7 + i)
            want, fed = greedy_run(dense, ids, None)
            runs.append((greedy_run(full, ids, fed)[0], want))
        print(json.dumps({"latent_full_rank_vs_dense": hold_prompts(
            runs, "latent r=512", "dense", LATENT_FULL_RANK_TOL)}), flush=True)
        del dense, full
        torch.cuda.empty_cache()
    finally:
        setenv(**{k: v for k, v in saved.items() if v is not None})
    return out


# --------------------------------------------------------------------------
# phase 11: serving over a pp x tp mesh of processes sharing the card

def mesh_check(engine, qm, what: str) -> list[dict]:
    """Hold every rank's launches since its counters were zeroed to what its
    chunk forwards call for: flash_attention once per local layer and
    chunk; each packed projection one launch of the kernel ``qm.route``
    names for its kind and the chunk's M (W8A8 at M <= 32, q5_k_matmul
    above), and on rank 0 the packed head once per call at its rows (the
    M of each call its ``StageModel`` recorded). Returns each rank's
    counts."""
    head = getattr(engine.model.stage, "lm_head", None)
    head_kind = head.kind if isinstance(head, qm.QuantPack) else None
    rows = []
    for st in engine.model.stats():
        want: dict[str, int] = {}
        calls = [(kind, n, M) for M in st["forward_ms"] for kind, n in st["packs"].items()]
        if head_kind:
            calls += [(head_kind, 1, M) for M in st["head_ms"]]
        for kind, n, M in calls:
            name = qm.route(kind, M)
            if name is None:
                fail(f"{what}: rank {st['rank']} ran a {kind} pack at M = {M}, "
                     "a route with no kernel")
            want[name] = want.get(name, 0) + n
        got = {k: v for k, v in st["launches"].items() if v}
        n_fwd = len(st["forward_ms"])
        if not n_fwd or got != want or st["flash_attention"] != st["layers"] * n_fwd:
            fail(f"{what}: rank {st['rank']} launched {got} and flash_attention "
                 f"{st['flash_attention']} times; its {n_fwd} chunk forwards of "
                 f"{st['layers']} layers (packs {st['packs']}) call for {want}")
        rows.append({"rank": st["rank"], "chunk_forwards": n_fwd,
                     "chunk_m": sorted(set(st["forward_ms"])), "layers": st["layers"],
                     "packs": st["packs"], "launches": got,
                     "flash_attention": st["flash_attention"],
                     "collective_s": st["comm_s"], "collective_calls": st["comm_calls"]})
    return rows


def profile_mesh_decode(engine, steps: int = 4) -> dict:
    """Where a single-stream mesh decode step's time goes, 512 tokens into
    the cache: wall per step on rank 0's clock (a step ends when the last
    stage's hidden row reaches rank 0), and per rank the device time, busy
    share, kernels and time in collectives per step (torch.profiler on
    every rank over the same steps)."""
    cache = engine.make_cache()
    engine.prefill(list(range(3, 515)), cache)
    tok = torch.tensor([[7]], device=engine.device)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.model(tok, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    run()
    engine.model.command("reset_stats")
    wall = run()
    comm = engine.model.stats()
    engine.model.command("profile", on=True)
    run()
    prof = engine.model.command("profile", on=False)
    ranks = [{"rank": c["rank"], "device_ms_per_step": p["device_ms"] / steps,
              "device_busy_share": p["device_ms"] / steps / (wall * 1e3),
              "kernels_per_step": p["kernels"] / steps,
              "collective_ms_per_step": c["comm_s"] * 1e3 / steps,
              "collectives_per_step": c["comm_calls"] / steps}
             for c, p in zip(comm, prof)]
    return {"wall_ms_per_step": wall * 1e3, "ranks": ranks, "steps": steps}


def mixed_step_gemm(trace, forward_ms: list[int], qm, what: str) -> dict:
    """Rank 0's device time, per mixed step, in the quantized GEMM's kernels
    (csrc/kquant_gemm.cuh: the block sums, the GEMM, the split-K reduce) from
    a torch.profiler trace of a serve, over its chunk forwards of more than
    ``qm.W8A8_MAX_M`` rows (the M of each forward, as ``stats`` records it)."""
    mixed = sum(1 for M in forward_ms if M > qm.W8A8_MAX_M)
    events = [e for e in trace.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and "dlp_kgemm" in e.name]
    if not mixed or not events:
        fail(f"{what}: {mixed} mixed steps, {len(events)} GEMM kernels traced on rank 0")
    us = sum(e.time_range.elapsed_us() for e in events)
    gemms = sum(1 for e in events if "kgemm_kernel" in e.name)
    return {"mesh": what, "rank": 0, "mixed_steps": mixed,
            "gemm_device_ms_per_mixed_step": us / 1e3 / mixed,
            "gemm_launches_per_mixed_step": gemms / mixed,
            "kernels_per_mixed_step": len(events) / mixed}


def serve_mesh(ShardedEngine, MeshSpec, gguf: Path, spec: str, quant, requests,
               ref, qm, card: str, slots: bool, tol: float) -> tuple[dict, str | None]:
    """One mesh path: ``ShardedEngine`` over ``gguf`` at ``spec`` (every rank
    a process on the card, gloo through host memory) serves ``requests``
    through ChatServer, single-stream or on 4 slots; every rank's launches
    are held (``mesh_check``), a decode step is profiled, and the logits
    of a 512-token prefill and four decode steps are measured against the
    single-device engine's (``ref``: ``mesh_ref``'s prompts, fed tokens and
    logits) prefilled in chunks of 16, as the mesh prefills, and against
    its one-shot prefill. Returns the launches by kernel, summed over the
    ranks, and what broke ``tol`` (None when nothing did)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig
    from distributed_llm_pipeline_tpu_torch.serving import ChatServer

    t0 = time.monotonic()
    engine = ShardedEngine(gguf, mesh_spec=MeshSpec.parse(spec), max_seq=2048, quant=quant)
    what = f"mesh {spec} quant {quant} {'slots' if slots else 'one stream'}"
    print(json.dumps({"mesh_engine": what, "up_s": time.monotonic() - t0,
                      "load_log": [e.content for e in engine._events_on_load],
                      "device_bytes_rank0": torch.cuda.memory_allocated(),
                      "card": card}), flush=True)
    try:
        gen = GenerationConfig(max_new_tokens=16)
        # the first request after boot loads kernels lazily
        list(engine.generate("hello", GenerationConfig(max_new_tokens=4)))
        engine.model.command("reset_stats")
        server = ChatServer(engine, gen, parallel=4 if slots else 1)
        # on slots, rank 0 (this process) is traced on the card through the
        # serve: its quantized GEMM's device time a mixed step (the serve's
        # wall time then carries the tracer's cost)
        trace = profile(activities=[ProfilerActivity.CUDA]) if slots else None
        t0 = time.monotonic()
        if trace:
            trace.__enter__()
        try:
            health, results = asyncio.run(chat_requests(server, requests,
                                                        lead=0 if slots else None))
        finally:
            if trace:
                torch.cuda.synchronize()
                trace.__exit__(None, None, None)
        wall = time.monotonic() - t0
        if health.get("status") != "ok" or (slots and health.get("slots_total") != 4):
            fail(f"{what}: /healthz {health}")
        summaries = [check_sse(r) for r in results]
        for i, (res, summ) in enumerate(zip(results, summaries)):
            print(json.dumps({"mesh_request": i, "mesh": spec, "quant": quant,
                              "slots": slots, "sampled": res["body"]["temperature"] > 0,
                              **summ, "card": card}), flush=True)
        if slots and server.scheduler.counters["prefill_steps_stolen_total"] < 1:
            fail(f"{what}: no mixed step stole from a decoding stream")
        ranks = mesh_check(engine, qm, what)
        if trace:
            print(json.dumps({"mesh_mixed_step_gemm": mixed_step_gemm(
                trace, engine.model.stats()[0]["forward_ms"], qm, what), "card": card}),
                flush=True)
        n_gen = sum(s["n_gen"] for s in summaries)
        first = min(r["t0"] for r in results)
        last = max(r["t_last"] for r in results)
        print(json.dumps({"mesh_served": {
            "mesh": spec, "quant": quant, "slots": slots, "requests": len(results),
            "tokens": n_gen, "wall_s": wall, "aggregate_tok_s": n_gen / (last - first),
            "ranks": ranks, "card": card}}), flush=True)
        if not slots:
            print(json.dumps({"mesh_decode_step": {"mesh": spec, "quant": quant,
                                                   **profile_mesh_decode(engine)},
                              "card": card}), flush=True)
        got = [greedy_run(engine, r["ids"], r["fed"])[0] for r in ref]
        held, problem = measure_prompts([(g, r["chunked"]) for g, r in zip(got, ref)],
                                        what, "the single device in chunks of 16", tol)
        one_shot = measure_prompts([(g, r["one_shot"]) for g, r in zip(got, ref)],
                                   "mesh", "one-shot", tol)[0]
        print(json.dumps({"mesh_logits": {"mesh": spec, "quant": quant, **held},
                          "vs_one_shot_prefill": {k: one_shot[k] for k in (
                              "max_abs_err", "by_prompt")}}), flush=True)
        total: dict[str, int] = {}
        for r in ranks:
            for k, v in {**r["launches"], "flash_attention": r["flash_attention"]}.items():
                total[k] = total.get(k, 0) + v
        return total, problem
    finally:
        engine.close()
        torch.cuda.empty_cache()


def mesh_ref(engine, seed: int, weights: str, card: str) -> list[dict]:
    """A single-device engine's runs over the 512-token prompts of seeds
    ``seed`` … ``seed + LOGIT_PROMPTS - 1``, for a mesh path to be held
    against: each prompt's ids, greedy tokens fed, and the logits with a
    one-shot prefill and with the prefill in chunks of 16 (the mesh's
    ``CHUNK``: every product at M = 16, and on a packed engine the W8A8
    route instead of the dense one). Prints the gap between the two, the
    single-device engine's own drift under the mesh's chunking."""
    refs = []
    for i in range(LOGIT_PROMPTS):
        ids = prompt_ids(engine, seed + i)
        one_shot, fed = greedy_run(engine, ids, None)
        refs.append({"ids": ids, "fed": fed, "one_shot": one_shot,
                     "chunked": greedy_run(engine, ids, fed, chunk=16)[0]})
    gap = measure_prompts([(r["chunked"], r["one_shot"]) for r in refs],
                          "chunked", "one-shot", 1.0)[0]
    print(json.dumps({"chunked_prefill_vs_one_shot": {
        "weights": weights, **{k: gap[k] for k in ("max_abs_err", "by_prompt")}},
        "card": card}), flush=True)
    return refs


# the kernel templates the sources instantiate (a kernels-line entry's
# "header"): the three attention sources' split-KV kernel, and the GEMM of
# dequant_matmul.cu's q4_k, q6_k, q5_k and q8_0
SPLIT_HEADER, GEMM_HEADER = "paged_tile.cuh", "kquant_gemm.cuh"
# the decoders' span view the persistent W8A8 GEMV reads (w8a8_matmul.cu)
SPAN_HEADER = "quant_tile.cuh"
# each GEMV pack kind's decoder (quant_tile.cuh) as it appears in the
# mangled names of its gemv_kernel instantiations
GEMV_DECODERS = {"q6_k": "dlp_quant3Q6KE", "q4_k": "dlp_quant3Q4KE",
                 "q5_ks": "dlp_quant4Q5KSE", "q2_ks": "dlp_quant4Q2KSE",
                 "q3_ks": "dlp_quant4Q3KSE", "q8_0": "ByteCodesILi32E",
                 "q6_k8": "ByteCodesILi16E", "q4_k8, q5_k": "dlp_quant11AffineBytesE"}


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 rows: list[dict], timed: dict, header: str | None = None) -> dict:
    entry = {"name": name, "route": "cuda", "source": source, "header": header,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
             "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
             "library_ms": timed["library_ms"], "timed_case": timed["case"]}
    if (header and header.endswith(SPAN_HEADER)) or name == "fused_decode_attn":
        entry["plan"] = timed["plan"]   # the GEMV's or the fused kernel's cut of that case
    return entry


def phase_seconds(phase: str, since: float, t_start: float) -> float:
    """Print, on a line of its own, the seconds a phase (or one path of it)
    took and when it ended; returns now."""
    now = time.monotonic()
    print(json.dumps({"phase": phase, "seconds": round(now - since, 1),
                      "ended_at_s": round(now - t_start, 1)}), flush=True)
    return now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()

    from distributed_llm_pipeline_tpu_torch.gguf import GGMLType
    from distributed_llm_pipeline_tpu_torch.models import PRESETS, llama
    from distributed_llm_pipeline_tpu_torch.ops import cuda_build
    from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd
    from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
    from distributed_llm_pipeline_tpu_torch.ops import latent_attention as la
    from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa
    from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm
    from distributed_llm_pipeline_tpu_torch.runtime import Engine

    # 1. the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"TF32 off for matmul and cuDNN", flush=True)

    # 2. build every kernel source of the paths
    t0 = time.monotonic()
    built = cuda_build.build(cuda_build.SOURCES)
    print(f"build: {len(built)} kernel source(s) in {time.monotonic() - t0:.1f}s",
          flush=True)
    for b in built.values():
        regs = re.findall(r"Used (\d+) registers", b.ptxas)
        spills = re.findall(r"(\d+) bytes spill stores", b.ptxas)
        smem = re.findall(r"(\d+) bytes smem", b.ptxas)
        print(f"  {b.name}: nvcc {b.seconds:.1f}s, registers {regs}, "
              f"spill store bytes {spills}, smem bytes {smem}", flush=True)
    # the split-KV kernels (paged, latent, dense): every instantiation's
    # report, none may spill
    split_ptxas = ptxas_report({k: built[k] for k in ("paged_attention",
                                                      "latent_attention",
                                                      "flash_attention")})
    print(json.dumps({"ptxas": split_ptxas}), flush=True)
    spilled = [f["function"] for fs in split_ptxas.values() for f in fs
               if f.get("spill_stores", 0) > 0]
    if spilled:
        fail(f"split-KV kernels spill registers: {spilled}")
    # the fused-dequant library: every kernel's report; the GEMM
    # instantiations (kgemm_kernel) may not spill, and ptxas's notes on
    # serialized wgmma are printed
    dequant_ptxas = ptxas_report({"dequant_matmul": built["dequant_matmul"]})
    print(json.dumps({"ptxas": dequant_ptxas, "wgmma_notes": [
        ln.strip() for ln in built["dequant_matmul"].ptxas.splitlines() if "wgmma" in ln]}),
        flush=True)
    spilled = [f["function"] for f in dequant_ptxas["dequant_matmul"]
               if "kgemm_kernel" in f["function"] and f.get("spill_stores", 0) > 0]
    if spilled:
        fail(f"the Q4_K / Q6_K / Q5_K / Q8_0 GEMM spills registers: {spilled}")
    # the int8 GEMM (int8_gemm_kernel, one instantiation per group and tile
    # width) may not spill either
    int8_ptxas = ptxas_report({"int8_matmul": built["int8_matmul"]})
    print(json.dumps({"ptxas": int8_ptxas, "wgmma_notes": [
        ln.strip() for ln in built["int8_matmul"].ptxas.splitlines() if "wgmma" in ln]}),
        flush=True)
    spilled = [f["function"] for f in int8_ptxas["int8_matmul"]
               if "int8_gemm_kernel" in f["function"] and f.get("spill_stores", 0) > 0]
    if spilled:
        fail(f"the int8 GEMM spills registers: {spilled}")
    # the persistent W8A8 GEMV (gemv_kernel, one instantiation per pack kind
    # and register rows of x) may not spill; every GEMV decoder has its
    # instantiations, and w8a8_kernel has none of the Q4_K and Q3_KS packs
    w8a8_ptxas = ptxas_report({"w8a8_matmul": built["w8a8_matmul"]})["w8a8_matmul"]
    gemv_ptxas = [f for f in w8a8_ptxas if "gemv_kernel" in f["function"]]
    print(json.dumps({"ptxas": {"w8a8_matmul gemv_kernel": gemv_ptxas}}), flush=True)
    spilled = [f["function"] for f in gemv_ptxas if f.get("spill_stores", 0) > 0]
    missing = [kind for kind, piece in GEMV_DECODERS.items()
               if not any(piece in f["function"] for f in gemv_ptxas)]
    if spilled or missing:
        fail(f"the W8A8 GEMV spills registers or lacks a decoder: {spilled}, {missing}")
    stale = [f["function"] for f in w8a8_ptxas if "w8a8_kernel" in f["function"]
             and any(GEMV_DECODERS[k] in f["function"] for k in ("q4_k", "q3_ks"))]
    if stale:
        fail(f"w8a8_kernel still has Q4_K or Q3_KS instantiations: {stale}")
    # the fused decode step (one instantiation per head-dim bound, activation,
    # weight and pool type) may not spill
    fused_ptxas = ptxas_report({"fused_decode": built["fused_decode"]})["fused_decode"]
    print(json.dumps({"ptxas": {"fused_decode": fused_ptxas}}), flush=True)
    spilled = [f["function"] for f in fused_ptxas
               if f.get("spill_stores", 0) > 0 or f.get("spill_loads", 0) > 0]
    if spilled or len(fused_ptxas) != 18:
        fail(f"the fused decode kernel spills registers or an instantiation is missing: "
             f"{spilled}, {len(fused_ptxas)} instantiations")

    t_phase = phase_seconds("1-2", t_start, t_start)

    # 3. kernels against their plain versions
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")   # 256 MiB > L2
    rows = check_attention(fa, pa, llama.kv_quantize, args.seed, flush)
    paged_rows = check_paged(pa, llama.kv_quantize, args.seed, flush)
    latent_rows = check_paged_cases(la.latent_flash_attention, la.latent_attention_plain,
                                    "latent_flash_attention", "latent_attention",
                                    LATENT_CASES, pa,
                                    llama.kv_quantize, args.seed, flush)
    check_split_f32(pa, la, llama.kv_quantize, args.seed)
    # the reference's accounting of a decode step's attention read per layer
    # at the main case (B = 4, 512 cached, bf16): latent at the default rank
    # (latents and both bases) against the dense pool's K/V
    cfg1b = PRESETS["llama3.2-1b"]
    print(json.dumps({"latent_decode_hbm_bytes_r128": la.latent_decode_hbm_bytes(
        cfg1b, 128, 512, 4), "dense_decode_kv_bytes": la.dense_decode_kv_bytes(
        cfg1b, 512, 4), "fused_decode_hbm_bytes": fd.decode_hbm_bytes(cfg1b, 512, 4),
        "unfused_decode_hbm_bytes": fd.decode_hbm_bytes(cfg1b, 512, 4, fused=False)}),
        flush=True)
    fused_rows = check_fused(fd, llama, qm, pa, llama.kv_quantize, args.seed, flush)
    check_fused_edges(fd, llama, qm, llama.kv_quantize, args.seed)
    quant_rows = check_quant(qm, kq, args.seed, flush, card)
    check_gemm_identity(qm, kq, args.seed, card)
    check_misaligned(qm, kq, args.seed)
    del flush
    print(f"phase 3 done at {time.monotonic() - t_start:.0f}s: "
          f"{sum(map(len, quant_rows.values()))} quantized kernel cases held", flush=True)
    t_phase = phase_seconds("3", t_phase, t_start)

    cfg = PRESETS["llama3.2-1b"]
    model_dir = ROOT / "build" / "chip_smoke"
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / f"llama3.2-1b-seed{args.seed}.gguf"
    q6_path = model_dir / f"llama3.2-1b-q6_k-seed{args.seed}.gguf"
    q4_path = model_dir / f"llama3.2-1b-q4_k_m-seed{args.seed}.gguf"
    q3_path = model_dir / f"llama3.2-1b-q3_k-seed{args.seed}.gguf"
    path9 = model_dir / f"llama3.2-1b-8layers-seed{args.seed}.gguf"
    try:
        # 4. the served path, single stream
        t0 = time.monotonic()
        write_model(path, cfg, args.seed)
        print(f"wrote {path.name}: {path.stat().st_size / 2**30:.2f} GiB in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        t0 = time.monotonic()
        engine = Engine(path, max_seq=2048)   # CUDA: no device argument
        print(f"engine up in {time.monotonic() - t0:.1f}s on {engine.device}",
              flush=True)
        prompt = " ".join(["hello"] * 480)   # ~480 tokens: a 512 bucket
        requests = [
            {"prompt": prompt, "max_new_tokens": 32, "temperature": 0.0},
            {"prompt": "hello hello", "max_new_tokens": 32, "temperature": 0.8,
             "top_k": 40, "top_p": 0.95, "seed": args.seed},
            {"prompt": "hello", "max_new_tokens": 32, "temperature": 1.0, "top_k": 0,
             "top_p": 0.9, "min_p": 0.05, "repeat_penalty": 1.1, "seed": args.seed + 1},
        ]
        launches = serve_single(engine, requests, card, fa)
        print(json.dumps({"decode_step": profile_decode(engine), "card": card}),
              flush=True)
        t_phase = phase_seconds("4", t_phase, t_start)

        # 5. the served path, four slots over the paged pool
        paged_launches = serve_slots(engine, pa, fa, cfg, card,
                                     args.seed)["paged_attention"]
        print(json.dumps({"paged_decode_step_b4": profile_paged_decode(engine),
                          "card": card}), flush=True)
        t_phase = phase_seconds("5", t_phase, t_start)

        # 6. served logits: kernel against plain attention, paged against dense
        print(json.dumps({"logits": compare_logits(
            engine, llama, "attention_any", fa.flash_attention_plain, args.seed)}),
            flush=True)
        print(json.dumps({"paged_logits": compare_paged_logits(engine, args.seed)}),
              flush=True)
        # the single-device logits phase 11's mesh paths are held against
        refs = {"bf16": mesh_ref(engine, args.seed, "bf16", card)}
        t_phase = phase_seconds("6", t_phase, t_start)

        # 12. the completion routes, run here: they reuse phases 4-5's engine
        print(f"phase 12 at {time.monotonic() - t_start:.0f}s", flush=True)
        serve_routes(engine, fa, pa, cfg, card, args.seed)
        del engine
        torch.cuda.empty_cache()
        t_phase = phase_seconds("12", t_phase, t_start)

        # 7. serve quantized: the paper's demo (a Q6_K GGUF, one stream) and
        # --quant q8_0 --parallel 4; 8. Q4_K_M native, one stream, and
        # --quant q5_k --parallel 4; 9. --quant int8, one stream, Q3_K native,
        # one stream, and --quant q2_k --parallel 4. The bf16 GGUF goes once
        # q2_k has packed it
        quant_launches = {}
        # phase 9, and the --quant q5_k slots of phases 8 and 11 (the slowest
        # paths: the device's Q5_K packing and the mesh's 64-lane mixed
        # steps), run at 8 of the 16 layers (widths unchanged) so that the
        # whole run stays under 900 s
        cfg9 = cfg.replace(n_layers=8)
        write_model(path9, cfg9, args.seed)
        for phase, pcfg, qpath, wtype, seed, runs in (
                (7, cfg, q6_path, GGMLType.Q6_K, args.seed + 1,
                 (("native", q6_path, cfg, False), ("q8_0", path, cfg, True))),
                (8, cfg, q4_path, q4_k_m_types(cfg.n_layers), args.seed + 2,
                 (("native", q4_path, cfg, False), ("q5_k", path9, cfg9, True))),
                (9, cfg9, q3_path, q3_k_types, args.seed + 3,
                 (("int8", path9, cfg9, False), ("native", q3_path, cfg9, False),
                  ("q2_k", path9, cfg9, True)))):
            t0 = time.monotonic()
            write_model(qpath, pcfg, seed, wtype=wtype)
            print(f"phase {phase} at {time.monotonic() - t_start:.0f}s: wrote {qpath.name}: "
                  f"{qpath.stat().st_size / 2**30:.2f} GiB in {time.monotonic() - t0:.1f}s "
                  f"(encoded on the host)", flush=True)
            for quant, gguf, rcfg, slots in runs:
                t_run = time.monotonic()
                # phase 11 serves the Q6_K and Q4_K_M GGUFs again
                qengine = load_quant_engine(Engine, gguf, quant, card,
                                            unlink=gguf not in (path, path9, q6_path, q4_path))
                quant_launches.update(serve_quant(qengine, slots, requests, fa, pa, qm,
                                                  llama, rcfg, card, args.seed))
                ref = {(7, "native"): "q6_k", (8, "native"): "q4_k_m",
                       (8, "q5_k"): "q5_k"}.get((phase, quant))
                if ref:
                    refs[ref] = mesh_ref(qengine, args.seed, ref, card)
                del qengine
                torch.cuda.empty_cache()
                phase_seconds(f"{phase} {quant} {gguf.name}", t_run, t_start)
            t_phase = phase_seconds(str(phase), t_phase, t_start)

        # 10. --kv-quant q8_0, the fused decode step and latent KV
        print(f"phase 10 at {time.monotonic() - t_start:.0f}s", flush=True)
        served10 = serve_kv_modes(Engine, path, requests, fa, pa, la, fd, qm, llama,
                                  cfg, card, args.seed)
        t_phase = phase_seconds("10", t_phase, t_start)

        # 11. the mesh: --mesh 2x2 over the bf16 GGUF, --mesh 1x2 --parallel 4
        # --quant q5_k, and --mesh 1x2 --quant native over the Q4_K_M and
        # Q6_K GGUFs, every rank a process on this card
        print(f"phase 11 at {time.monotonic() - t_start:.0f}s", flush=True)
        from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine

        # gloo through host memory between processes that share the card
        # takes milliseconds a collective: 16 new tokens a request
        def shorter(bodies):
            return [{**b, "max_new_tokens": 16} for b in bodies]

        mesh_launches: dict[str, int] = {}
        problems = []
        for spec, gguf, quant, key, slots, tol in (
                ("2x2", path, None, "bf16", False, MESH_LOGIT_TOL),
                ("1x2", path9, "q5_k", "q5_k", True, QUANT_LOGIT_TOL),
                ("1x2", q4_path, "native", "q4_k_m", False, QUANT_LOGIT_TOL),
                ("1x2", q6_path, "native", "q6_k", False, QUANT_LOGIT_TOL)):
            t_run = time.monotonic()
            got, problem = serve_mesh(
                ShardedEngine, MeshSpec, gguf, spec, quant,
                shorter(slot_requests(args.seed) if slots else requests),
                refs[key], qm, card, slots, tol)
            for k, v in got.items():
                mesh_launches[k] = mesh_launches.get(k, 0) + v
            problems += [problem] if problem else []
            phase_seconds(f"11 {spec} {quant} {gguf.name}", t_run, t_start)
        if problems:
            fail("; ".join(problems))
        print(json.dumps({"mesh_launches": mesh_launches, "card": card}), flush=True)
        phase_seconds("11", t_phase, t_start)
    finally:
        for p in (path, path9, q6_path, q4_path, q3_path):
            p.unlink(missing_ok=True)

    # 13. results
    src = "distributed_llm_pipeline_tpu_torch/csrc/"
    ref = "distributed_llm_pipeline_tpu/ops/"
    entries = [
        kernel_entry("flash_attention", src + "flash_attention.cu",
                     ref + "flash_attention.py:138", launches, rows, rows[0],
                     src + SPLIT_HEADER),
        kernel_entry("paged_flash_attention", src + "paged_attention.cu",
                     ref + "paged_attention.py:141", paged_launches, paged_rows,
                     paged_rows[0], src + SPLIT_HEADER),
        kernel_entry("fused_decode_attn", src + "fused_decode.cu",
                     ref + "fused_decode.py:379", served10["fused_decode_attn"],
                     fused_rows, next(r for r in fused_rows
                                      if r["case"] == "b4_dense_w_bf16_pool")),
        kernel_entry("latent_flash_attention", src + "latent_attention.cu",
                     ref + "latent_attention.py:334", served10["latent_attention"],
                     latent_rows, next(r for r in latent_rows
                                       if r["case"] == "r128_decode"),
                     src + SPLIT_HEADER)]
    for name, kind, kernel, source, replaces in (
            ("q8_0_matmul", "q8_0", "dequant", "dequant_matmul.cu", "quant_matmul.py:356"),
            ("gw8a8_matmul", "q8_0", "w8a8", "w8a8_matmul.cu", "quant_matmul.py:242"),
            ("q6_k_matmul", "q6_k", "dequant", "dequant_matmul.cu", "kquant_matmul.py:879"),
            ("q6_k_w8a8_matmul", "q6_k", "w8a8", "w8a8_matmul.cu", "kquant_matmul.py:1048"),
            ("q4_k_matmul", "q4_k", "dequant", "dequant_matmul.cu", "kquant_matmul.py:585"),
            ("q4_k_w8a8_matmul", "q4_k", "w8a8", "w8a8_matmul.cu", "kquant_matmul.py:813"),
            ("q5_ks_w8a8_matmul", "q5_ks", "w8a8", "w8a8_matmul.cu", "kquant_matmul.py:796"),
            ("int8_matmul", "int8", "int8", "int8_matmul.cu", "quant_matmul.py:512"),
            ("q2_ks_w8a8_matmul", "q2_ks", "w8a8", "w8a8_matmul.cu", "kquant_matmul.py:1104"),
            ("q3_ks_w8a8_matmul", "q3_ks", "w8a8", "w8a8_matmul.cu", "kquant_matmul.py:1162"),
            ("q5_k_matmul", "q5_k", "dequant", "dequant_matmul.cu", "kquant_matmul.py:831"),
            # row 4 (gw8a8_matmul_pallas) again, over the tp mesh's byte codes
            ("q5_k_w8a8_matmul", "q5_k", "w8a8", "w8a8_matmul.cu", "quant_matmul.py:242"),
            ("q4_k8_w8a8_matmul", "q4_k8", "w8a8", "w8a8_matmul.cu", "quant_matmul.py:242"),
            ("q6_k8_w8a8_matmul", "q6_k8", "w8a8", "w8a8_matmul.cu", "quant_matmul.py:242")):
        krows = quant_rows[(kind, kernel)]
        pair, M = QUANT_TIMED[(kind, kernel)]
        timed = next(r for r in krows if r["pair"] == pair and r["M"] == M)
        served = mesh_launches if kind in BYTE_KINDS else quant_launches
        header = src + GEMM_HEADER if kernel == "dequant" and kind in qm.GEMM_KINDS else None
        if kernel == "w8a8" and qm.gemv_takes(kind, timed["D"]):
            header = src + SPAN_HEADER
        entries.append(kernel_entry(name, src + source, ref + replaces,
                                    served.get(name, 0), krows, timed, header))
    if any(e["launches"] <= 0 for e in entries):
        fail(f"a kernel of the path never launched: {entries}")
    print(f"chip_smoke wall time {time.monotonic() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
