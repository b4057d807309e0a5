"""The Q4_K / Q6_K / Q5_K / Q8_0 fused-dequant GEMM (``csrc/kquant_gemm.cuh``)
on the CPU, where its CUDA kernel cannot run: what surrounds the kernel, and
mirrors of its arithmetic.

- The decoder's bit tricks: a torch integer mirror of the kernel's code
  extraction (the nibble planes, Q6_K's 2-bit plane, band by band) and of its
  code-to-bf16 conversion in pairs (each code under the exponent of 128, less
  128 or 160) and bf16 product with the scale gives, for every byte value of
  every plane and every band, the weights ``dequant_matmul_plain`` uses, bit
  for bit: held through ``x = I``, as the chip's identity probe holds the
  kernel (Q4_K: less b per 32 rows).
- The plan (``ops.quant_matmul.gemm_plan``) for every (D, F, M) that phase 3
  of ``chip_smoke.py`` and the served paths use, at several SM counts: every
  output tile once, every k-step (of the weight's D and of the offset
  term's D/32 columns) in exactly one split, the workspaces from shapes
  only, and a ``ValueError`` for what the kernel refuses.
- The k-step order: a plain mirror of the kernel's band-interleaved k-steps,
  the offset term's steps and the split-K partials summed in the plan's
  order, against the JAX package's ``q4_k_matmul_pallas`` and
  ``q6_k_matmul_pallas`` (interpret mode) on the same numpy packs and
  inputs: within 1e-5 of max |ref| in f32, one bf16 ulp of max |ref| in bf16.
- Q5_K's byte codes (one plane, four 32-column slabs a k-step, D only a
  multiple of 32 on a tensor-parallel shard, so a ragged last step): the
  plan at the shard widths, the code-to-bf16 decode bit-equal to
  ``q5_k_matmul_plain``'s weights on every code 0..31, and the k-step and
  split-K order against ``q5_k_matmul_pallas`` (interpret mode), as above.
- Q8_0's signed byte codes (Q5_K's layout without the offset): the decode
  in two halves (the low 7 bits under the exponent of 128, less a bias of
  128 or 256 built from the sign bit the same way) bit-equal to
  ``dequant_matmul_plain``'s weights on all 256 byte values, -128
  included; the plan at Llama-3.2-1B's pairs, the odd F and D = 2080; the
  k-step and split-K order against ``q8_0_matmul_pallas`` (interpret mode).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import kquant_matmul as jkq
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

# the header's tiling (kquant_gemm.cuh Geo and geometry) as the card's
# *_geometry entries report it: one block an SM
GEOMETRY = {
    ("q4_k", 64): qm.GemmGeometry(64, 128, 32, 2, 32, 10, 288, 189600, 1),
    ("q4_k", 128): qm.GemmGeometry(128, 128, 32, 2, 32, 7, 288, 197744, 1),
    ("q6_k", 64): qm.GemmGeometry(64, 128, 32, 4, 0, 6, 288, 222304, 1),
    ("q6_k", 128): qm.GemmGeometry(128, 128, 32, 4, 0, 4, 288, 230464, 1),
    ("q5_k", 64): qm.GemmGeometry(64, 128, 128, 1, 32, 6, 288, 218208, 1, 32),
    ("q5_k", 128): qm.GemmGeometry(128, 128, 128, 1, 32, 4, 288, 218176, 1, 32),
    ("q8_0", 64): qm.GemmGeometry(64, 128, 128, 1, 0, 6, 288, 218208, 1, 32),
    ("q8_0", 128): qm.GemmGeometry(128, 128, 128, 1, 0, 4, 288, 218176, 1, 32),
}


def _geometry(kind, M):
    return GEOMETRY[(kind, qm.gemm_bm(M))]


# ---------------------------------------------------------------------------
# the decoder's bit tricks

def _pair_to_bf16(codes: torch.Tensor, bias: float) -> torch.Tensor:
    """The kernel's code -> bf16 step: the code (0..127) as the low byte of
    bf16 0x43cc (= 128 + code exactly), less ``bias`` in bf16 (exact)."""
    v = (codes.to(torch.int16) | 0x4300).view(torch.bfloat16)
    return (v.float() - bias).to(torch.bfloat16)


def _signed_to_bf16(codes: torch.Tensor) -> torch.Tensor:
    """Q8_0's code -> bf16 step for a signed byte c: the low 7 bits as the
    low byte of bf16 0x43 (= 128 + (c & 127)), less the sign bit as the low
    byte of bf16 0x43 (0x4300 = 128 or 0x4380 = 256), in bf16 (exact)."""
    u = codes.view(torch.uint8).to(torch.int16)
    v = ((u & 0x7F) | 0x4300).view(torch.bfloat16)
    bias = ((u & 0x80) | 0x4300).view(torch.bfloat16)
    return (v.float() - bias.float()).to(torch.bfloat16)


def _times(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bf16x2 multiply: the exact product (two 8-bit mantissas fit f32)
    rounded once to bf16."""
    return (c.float() * s.float()).to(torch.bfloat16)


def _mirror_weights(pack) -> torch.Tensor:
    """W [F, D] bf16 as the kernel decodes it from the raw planes."""
    F, D = pack.shape
    if pack.kind == "q5_k":   # one byte a code, already 0..31
        c = _pair_to_bf16(pack.q5.view(torch.uint8), 128.0)
        return _times(c, pack.a.repeat_interleave(32, dim=1))
    if pack.kind == "q8_0":   # one signed byte a code
        return _times(_signed_to_bf16(pack.qs), pack.scale.repeat_interleave(32, dim=1))
    if pack.kind == "q4_k":
        q = pack.qs.view(torch.uint8)                              # [F, D/2]
        bands = [q & 0x0F, q >> 4]                                 # (q >> 4) & 0x0F
        codes = torch.cat(bands, dim=1)
        c = _pair_to_bf16(codes, 128.0)
        return _times(c, pack.a.repeat_interleave(32, dim=1))
    ql, qh = pack.ql.view(torch.uint8), pack.qh.view(torch.uint8)
    la, lb = ql[:, : D // 4], ql[:, D // 4:]
    bands = []
    for k in range(4):
        lo = ((la if k % 2 == 0 else lb) >> ((k >> 1) * 4)) & 0x0F
        bands.append(lo | (((qh >> (2 * k)) & 3) << 4))            # 0..63
    c = _pair_to_bf16(torch.cat(bands, dim=1), 160.0)
    return _times(c, pack.s.repeat_interleave(16, dim=1))


def _all_bytes(rows: int, cols: int, shift: int) -> torch.Tensor:
    """int8 [rows, cols] holding every byte value in every row and column."""
    f = torch.arange(rows)[:, None]
    j = torch.arange(cols)[None, :]
    return ((f * 37 + j + shift) % 256).to(torch.uint8).view(torch.int8)


def _scales(rows, cols, signed, seed):
    g = np.random.default_rng(seed)
    s = g.uniform(0.5, 2.0, (rows, cols)) * 10.0 ** g.integers(-4, 1, (rows, cols))
    if signed:
        s *= g.choice([-1.0, 1.0], (rows, cols))
    return torch.from_numpy(s.astype(np.float32)).bfloat16()


@pytest.mark.parametrize("kind", ["q4_k", "q6_k"])
@pytest.mark.parametrize("D", [512, 1280])
def test_decoder_bit_tricks_are_the_plain_weights(kind, D):
    F = 256
    if kind == "q4_k":
        a = _scales(F, D // 32, False, 1)
        pack = kq.Q4KPack(qs=_all_bytes(F, D // 2, 0), a=a,
                          b=(a.float() * 7.5).bfloat16())
    else:
        pack = kq.Q6KPack(ql=_all_bytes(F, D // 2, 0), qh=_all_bytes(F, D // 4, 11),
                          s=_scales(F, D // 16, True, 2))
    w = _mirror_weights(pack)
    # x = I through the plain version: W^T (less b per 32 rows for Q4_K),
    # every output one product (and one offset), exact in f32
    got = qm.dequant_matmul_plain(torch.eye(D, dtype=torch.bfloat16), pack, torch.float32)
    want = w.float().t()
    if kind == "q4_k":
        want = want - pack.b.float().repeat_interleave(32, dim=1).t()
    assert torch.equal(got, want)
    # and the weights themselves, bit for bit, against the pack's codes
    codes, sc = pack.codes_and_scales()
    plain_w = (codes.to(torch.bfloat16).reshape(F, D // pack.sub, pack.sub)
               * sc.to(torch.bfloat16)[..., None]).reshape(F, D)
    assert torch.equal(w.view(torch.int16), plain_w.view(torch.int16))


# ---------------------------------------------------------------------------
# the plan

# (D, F): Llama-3.2-1B's projections and head (phase 3 and the served paths),
# phase 3's odd F and group-32 edges, and the identity probe
PLAN_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256),
               (2048, 1001), (1280, 1024)]
# phase 3's M (33, 100, 256, 512), the identity probe's 2048, and served
# forwards: prefill buckets, 4 slots x 16 or 64 lanes, a 481-token prompt
PLAN_M = (33, 48, 64, 65, 100, 128, 256, 481, 512, 1024, 2048)
SM_COUNTS = (1, 8, 132, 144)


def _steps_of(plan, geo, D):
    """Each k-step's contraction columns: a weight step, the positions
    [pt, pt + p) of every band (p = ``geo.positions``; a ragged last step
    stops at the band's end); an offset step, 32 columns of D/32."""
    band = D // geo.bands
    main = [[b * band + geo.positions * t + j for b in range(geo.bands)
             for j in range(min(geo.positions, band - geo.positions * t))]
            for t in range(plan.main_steps)]
    tail = [list(range(32 * u, min(D // 32, 32 * u + 32))) for u in range(plan.tail_steps)]
    return main, tail


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("D,F", PLAN_SHAPES)
@pytest.mark.parametrize("kind", ["q4_k", "q6_k"])
def test_plan_covers_every_tile_and_step_once(kind, D, F, sms):
    for M in PLAN_M:
        geo = _geometry(kind, M)
        plan = qm.gemm_plan(M, D, F, geo, sms)
        assert plan.bm == geo.bm and plan.bn == geo.bn == 128
        # every output tile once
        assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm
        assert (plan.tiles_n - 1) * plan.bn < F <= plan.tiles_n * plan.bn
        # every k-step in exactly one split, none empty
        total = plan.main_steps + plan.tail_steps
        runs = [range(s * plan.steps_per_split,
                      min(total, (s + 1) * plan.steps_per_split)) for s in range(plan.splits)]
        assert all(len(r) > 0 for r in runs)
        assert sorted(t for r in runs for t in r) == list(range(total))
        assert 1 <= plan.splits <= qm.MAX_SPLITS
        # the steps partition D (and the offset term's D/32 columns)
        main, tail = _steps_of(plan, geo, D)
        assert sorted(c for cols in main for c in cols) == list(range(D))
        if kind == "q4_k":
            assert sorted(c for cols in tail for c in cols) == list(range(D // 32))
        else:
            assert tail == []
        # a grid at least as wide as the card's slots is never split
        if plan.tiles_m * plan.tiles_n >= sms * geo.blocks_per_sm:
            assert plan.splits == 1


@pytest.mark.parametrize("kind", ["q4_k", "q6_k"])
def test_plan_workspaces_depend_on_shapes_only(kind):
    for M in PLAN_M:
        for D, F in PLAN_SHAPES:
            plan = qm.gemm_plan(M, D, F, _geometry(kind, M), 132)
            again = qm.gemm_plan.__wrapped__(M, D, F, _geometry(kind, M), 132)
            assert plan == again
            n_xs, n_part = qm.gemm_workspace(plan, M, D, F, kind == "q4_k")
            assert n_xs == (M * math.ceil(D / 32 / 32) * 32 if kind == "q4_k" else 0)
            assert n_part == (plan.splits * M * F if plan.splits > 1 else 0)


@pytest.mark.parametrize("M,D,F", [(0, 2048, 512), (33, 2048, 0), (33, 2080, 512),
                                   (33, 128, 512), (33, 1056, 512),
                                   (65536 * 128 + 1, 2048, 512)])
def test_plan_refuses_what_the_kernel_refuses(M, D, F):
    """The kernel takes M, F >= 1, D a multiple of 256 (every Q4_K / Q6_K
    pack's) and at most 65535 row tiles."""
    with pytest.raises(ValueError):
        qm.gemm_plan(M, D, F, GEOMETRY[("q6_k", 128)], 132)


# ---------------------------------------------------------------------------
# the k-step order against the JAX Pallas kernels

def _weight(D, F, seed):
    return (np.random.default_rng(seed).normal(size=(D, F)) * 0.05).astype(np.float32)


def _gemm_mirror(x: torch.Tensor, pack, plan, out_dtype) -> torch.Tensor:
    """The kernel's function in its own order: per split, its k-steps in
    order (a weight step: the 32-column slab of each band; an offset step:
    32 columns of -bf16(sum_32 x) against b), products summed in f32; the
    splits' partials summed in split order. Weights as the kernel decodes
    them in bf16 (code * scale in x's dtype otherwise). Q5_K's weight step
    is 128 consecutive columns (fewer in a ragged last step), as Q8_0's."""
    cd = x.dtype
    M, D = x.shape
    F = pack.shape[0]
    if cd == torch.bfloat16:
        w = _mirror_weights(pack)
    else:
        codes, sc = pack.codes_and_scales()
        w = (codes.float().reshape(F, D // pack.sub, pack.sub) * sc.float()[..., None]
             ).reshape(F, D)
    bands = {"q4_k": 2, "q6_k": 4, "q5_k": 1, "q8_0": 1}[pack.kind]
    width = 32 if bands > 1 else 128   # a band's positions a step
    total = plan.main_steps + plan.tail_steps
    if plan.tail_steps:
        KT = plan.tail_steps * 32
        xs = torch.zeros(M, KT, dtype=cd)
        xs[:, : D // 32] = (-x.float().reshape(M, D // 32, 32).sum(-1)).to(cd)
        bt = torch.zeros(F, KT, dtype=cd)
        bt[:, : D // 32] = pack.b.to(cd)
    out = None
    for s in range(plan.splits):
        part = torch.zeros(M, F)
        for t in range(s * plan.steps_per_split, min(total, (s + 1) * plan.steps_per_split)):
            if t < plan.main_steps:
                for b in range(bands):
                    c0 = b * D // bands + width * t
                    cols = slice(c0, min(c0 + width, (b + 1) * D // bands))
                    part += x[:, cols].float() @ w[:, cols].float().t()
            else:
                cols = slice(32 * (t - plan.main_steps), 32 * (t - plan.main_steps) + 32)
                part += xs[:, cols].float() @ bt[:, cols].float().t()
        out = part if out is None else out + part
    return out.to(out_dtype)


def _jax_gemm(kind, x, w, out_dtype):
    if kind == "q4_k":
        f = {k: jnp.asarray(v) for k, v in jkq.pack_q4_k(w).items()}
        D2 = x.shape[1] // 2
        return jkq.q4_k_matmul_pallas(x, f["qs"], f["a"], f["b"],
                                      block_d=jqm.divisor_tile(D2, (512, 384, 256, 128), 512),
                                      out_dtype=out_dtype, interpret=True)
    f = {k: jnp.asarray(v) for k, v in jkq.pack_q6_k(w).items()}
    D4 = x.shape[1] // 4
    return jkq.q6_k_matmul_pallas(x, f["ql"], f["qh"], f["s"],
                                  block_d=jqm.divisor_tile(D4, (256, 128, 64, 32), 256),
                                  out_dtype=out_dtype, interpret=True)


# (kind, M, D, F, SM count): a one-tile grid split over few SMs (splits > 1
# with the offset term in the last split), 128-row tiles, and D = 1280, whose
# offset term ends in a half-empty slab (D/32 = 40)
ORDER_CASES = [("q4_k", 40, 512, 160, 4), ("q4_k", 96, 256, 192, 132),
               ("q4_k", 33, 1280, 160, 16), ("q6_k", 40, 512, 160, 4),
               ("q6_k", 96, 256, 192, 132), ("q6_k", 70, 1280, 128, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,M,D,F,sms", ORDER_CASES)
def test_kstep_order_matches_jax_pallas(kind, M, D, F, sms, dtype):
    w = _weight(D, F, seed=M + D)
    pack = (kq.pack_q4_k if kind == "q4_k" else kq.pack_q6_k)(w.T)
    plan = qm.gemm_plan(M, D, F, _geometry(kind, M), sms)
    x32 = np.random.default_rng(F).normal(size=(M, D)).astype(np.float32)
    if dtype == "f32":
        ref = np.asarray(_jax_gemm(kind, jnp.asarray(x32), w, jnp.float32))
        got = _gemm_mirror(torch.from_numpy(x32), pack, plan, torch.float32).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        x = torch.from_numpy(x32).bfloat16()
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        ref = np.asarray(_jax_gemm(kind, xj, w, jnp.bfloat16), np.float32)
        got = _gemm_mirror(x, pack, plan, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    if sms < 16 and F <= 160:
        assert plan.splits > 1   # the case exercises the split-K order


# ---------------------------------------------------------------------------
# Q5_K: byte codes, one plane, D a multiple of 32 only

# (D, F) of the q5_k packs: the tp = 2 shards of Llama-3.2-1B (wq, wk/wv, wo,
# gate/up, down) and of llama2-7b's w_down (D = 5504 = 11008 / 2), and phase
# 3's D = 1056 edge
Q5_SHAPES = [(2048, 1024), (2048, 256), (1024, 2048), (2048, 4096), (4096, 2048),
             (5504, 4096), (1056, 1024)]
Q5_M = (33, 64, 100, 256, 512)


@pytest.mark.parametrize("sms", (1, 132))
@pytest.mark.parametrize("D,F", Q5_SHAPES)
def test_q5_k_plan_covers_every_tile_and_step_once(D, F, sms):
    for M in Q5_M:
        geo = _geometry("q5_k", M)
        plan = qm.gemm_plan(M, D, F, geo, sms)
        assert plan.bm == geo.bm and plan.bn == 128
        assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm
        assert (plan.tiles_n - 1) * plan.bn < F <= plan.tiles_n * plan.bn
        total = plan.main_steps + plan.tail_steps
        runs = [range(s * plan.steps_per_split,
                      min(total, (s + 1) * plan.steps_per_split)) for s in range(plan.splits)]
        assert all(len(r) > 0 for r in runs)
        assert sorted(t for r in runs for t in r) == list(range(total))
        # 128 columns a weight step, the last ragged where 128 does not
        # divide D; the offset term's D/32 columns 32 a step
        assert plan.main_steps == -(-D // 128)
        main, tail = _steps_of(plan, geo, D)
        assert [c for cols in main for c in cols] == list(range(D))
        assert len(main[-1]) == (D % 128 or 128)
        assert sorted(c for cols in tail for c in cols) == list(range(D // 32))
        n_xs, n_part = qm.gemm_workspace(plan, M, D, F, True)
        assert n_xs == M * math.ceil(D / 32 / 32) * 32
        assert n_part == (plan.splits * M * F if plan.splits > 1 else 0)
        assert plan == qm.gemm_plan.__wrapped__(M, D, F, geo, sms)


@pytest.mark.parametrize("D", [1040, 1000, 16, 0])
def test_q5_k_plan_refuses_a_d_that_32_does_not_divide(D):
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.gemm_plan(64, D, 1024, GEOMETRY[("q5_k", 64)], 132)


@pytest.mark.parametrize("D", [512, 1056])
def test_q5_k_decode_is_the_plain_weights_on_every_code(D):
    """Every code 0..31 in every row and column, through the kernel's
    decode (each byte under the exponent of 128, less 128, one bf16
    multiply by a): the weights ``q5_k_matmul_plain`` uses, bit for bit, and
    through x = I the plain version's output less b per 32 rows."""
    F = 64
    codes = ((torch.arange(F)[:, None] * 7 + torch.arange(D)[None, :]) % 32).to(torch.int8)
    a = _scales(F, D // 32, False, 3)
    pack = kq.Q5KPack(q5=codes, a=a, b=(a.float() * 15.5).bfloat16())
    w = _mirror_weights(pack)
    got = kq.q5_k_matmul_plain(torch.eye(D, dtype=torch.bfloat16), pack, torch.float32)
    want = w.float().t() - pack.b.float().repeat_interleave(32, dim=1).t()
    assert torch.equal(got, want)
    plain_w = (codes.to(torch.bfloat16).reshape(F, D // 32, 32)
               * a[..., None]).reshape(F, D)
    assert torch.equal(w.view(torch.int16), plain_w.view(torch.int16))
    assert sorted(set(codes.flatten().tolist())) == list(range(32))


def _q5_k_packs(D_whole, F, shards, i, seed):
    """(JAX fields as numpy, port pack) of row shard i of ``shards`` of a
    Q5_K weight [D_whole, F] (the whole weight when shards is 1)."""
    w = _weight(D_whole, F, seed)
    jp, tp = jkq.pack_q5_k(w), kq.pack_q5_k(w.T)
    d = D_whole // shards
    jp = {f: np.asarray(a)[i * d // (1 if f == "q5" else 32):
                           (i + 1) * d // (1 if f == "q5" else 32)]
          for f, a in jp.items()}
    tp = kq.Q5KPack(q5=tp.q5[:, i * d:(i + 1) * d].contiguous(),
                    a=tp.a[:, i * d // 32:(i + 1) * d // 32].contiguous(),
                    b=tp.b[:, i * d // 32:(i + 1) * d // 32].contiguous())
    return jp, tp


# (M, whole D, F, row shards, SM count): a whole pack split over few SMs
# (splits > 1, the offset term in the last split); a shard of D = 320 (the
# last step 2 slabs), of D = 96 (one ragged step of 3 slabs) and of
# D = 1056 (a last step of 1 slab, an offset term ending in 1 column)
Q5_ORDER_CASES = [(40, 512, 160, 1, 4), (70, 1280, 128, 4, 8), (33, 768, 160, 8, 16),
                  (36, 8448, 64, 8, 132)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,D_whole,F,shards,sms", Q5_ORDER_CASES)
def test_q5_k_kstep_order_matches_jax_pallas(M, D_whole, F, shards, sms, dtype):
    jp, pack = _q5_k_packs(D_whole, F, shards, shards // 2, seed=M)
    D = pack.shape[1]
    plan = qm.gemm_plan(M, D, F, _geometry("q5_k", M), sms)
    assert plan.splits > 1 or D % 128   # split-K or a ragged step is exercised
    x32 = np.random.default_rng(F + D).normal(size=(M, D)).astype(np.float32)
    f = {k: jnp.asarray(v) for k, v in jp.items()}

    def ref(x, out_dtype):
        return jkq.q5_k_matmul_pallas(
            x, f["q5"], f["a"], f["b"],
            block_d=jqm.divisor_tile(D, (512, 384, 256, 128, 64), 32),
            out_dtype=out_dtype, interpret=True)

    if dtype == "f32":
        want = np.asarray(ref(jnp.asarray(x32), jnp.float32))
        got = _gemm_mirror(torch.from_numpy(x32), pack, plan, torch.float32).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        x = torch.from_numpy(x32).bfloat16()
        want = np.asarray(ref(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                              jnp.bfloat16), np.float32)
        got = _gemm_mirror(x, pack, plan, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


# ---------------------------------------------------------------------------
# Q8_0: signed byte codes, one plane, D a multiple of 32 only

# (D, F): Llama-3.2-1B's five pairs, phase 3's odd F and its D = 2080 edge
# (group 32: 16 full k-steps and a ragged one of one slab)
Q8_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256),
             (2048, 1001), (2080, 1024)]
Q8_M = (33, 100, 256, 512, 2048)


@pytest.mark.parametrize("sms", (1, 132))
@pytest.mark.parametrize("D,F", Q8_SHAPES)
def test_q8_0_plan_covers_every_tile_and_step_once(D, F, sms):
    for M in Q8_M:
        geo = _geometry("q8_0", M)
        plan = qm.gemm_plan(M, D, F, geo, sms)
        assert plan.bm == geo.bm and plan.bn == 128 and plan.tail_steps == 0
        assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm
        assert (plan.tiles_n - 1) * plan.bn < F <= plan.tiles_n * plan.bn
        runs = [range(s * plan.steps_per_split,
                      min(plan.main_steps, (s + 1) * plan.steps_per_split))
                for s in range(plan.splits)]
        assert all(len(r) > 0 for r in runs)
        assert sorted(t for r in runs for t in r) == list(range(plan.main_steps))
        # 128 columns a step in order, the last ragged where 128 does not
        # divide D
        main, tail = _steps_of(plan, geo, D)
        assert [c for cols in main for c in cols] == list(range(D)) and tail == []
        assert len(main[-1]) == (D % 128 or 128)
        assert qm.gemm_workspace(plan, M, D, F, False) == (
            0, plan.splits * M * F if plan.splits > 1 else 0)
        if plan.tiles_m * plan.tiles_n >= sms * geo.blocks_per_sm:
            assert plan.splits == 1
        assert plan == qm.gemm_plan.__wrapped__(M, D, F, geo, sms)


@pytest.mark.parametrize("D", [512, 2080])
def test_q8_0_decode_is_the_plain_weights_on_every_byte(D):
    """All 256 byte values (-128 included: a GGUF block's raw bytes may hold
    it) in every row and column, through the kernel's decode: the weights
    ``dequant_matmul_plain`` uses, bit for bit, and through x = I its
    output. The exponent trick alone (each byte under 0x43) is wrong for
    half of them, as is an offset of 128 before it."""
    F = 256
    codes = _all_bytes(F, D, 5)
    pack = qm.Q8_0Pack(qs=codes, scale=_scales(F, D // 32, True, 4))
    w = _mirror_weights(pack)
    got = qm.dequant_matmul_plain(torch.eye(D, dtype=torch.bfloat16), pack, torch.float32)
    assert torch.equal(got, w.float().t())
    plain_w = (codes.to(torch.bfloat16).reshape(F, D // 32, 32)
               * pack.scale[..., None]).reshape(F, D)
    assert torch.equal(w.view(torch.int16), plain_w.view(torch.int16))
    assert sorted(set(codes.flatten().tolist())) == list(range(-128, 128))
    # the codes themselves, before the scale: every one exact
    assert torch.equal(_signed_to_bf16(codes).float(), codes.float())
    # the unsigned trick (byte under 0x43, less 128) fails the negative codes
    naive = _pair_to_bf16(codes.view(torch.uint8), 128.0).float()
    assert not torch.equal(naive[codes < 0], codes[codes < 0].float())
    assert torch.equal(naive[codes >= 0], codes[codes >= 0].float())


# (M, D, F, SM count): a one-tile grid split over few SMs (split-K), D = 2080
# (a ragged last step of one slab) on the card's grid and split, and a D of
# 9 full steps and a ragged one of one slab (1184)
Q8_ORDER_CASES = [(40, 512, 160, 4), (33, 2080, 96, 132), (70, 1184, 128, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,D,F,sms", Q8_ORDER_CASES)
def test_q8_0_kstep_order_matches_jax_pallas(M, D, F, sms, dtype):
    w = _weight(D, F, seed=M + D)
    jp, pack = jqm.pack_q8_0(w), qm.pack_q8_0(w.T)
    assert torch.equal(pack.qs, torch.from_numpy(np.ascontiguousarray(np.asarray(jp["qs"]).T)))
    plan = qm.gemm_plan(M, D, F, _geometry("q8_0", M), sms)
    assert plan.splits > 1 or D % 128   # split-K or a ragged step is exercised
    x32 = np.random.default_rng(F + D).normal(size=(M, D)).astype(np.float32)
    f = {k: jnp.asarray(v) for k, v in jp.items()}

    def ref(x, out_dtype):
        return jqm.q8_0_matmul_pallas(x, f["qs"], f["scale"], out_dtype=out_dtype,
                                      interpret=True)

    if dtype == "f32":
        want = np.asarray(ref(jnp.asarray(x32), jnp.float32))
        got = _gemm_mirror(torch.from_numpy(x32), pack, plan, torch.float32).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        x = torch.from_numpy(x32).bfloat16()
        want = np.asarray(ref(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                              jnp.bfloat16), np.float32)
        got = _gemm_mirror(x, pack, plan, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


def test_q8_0_scale_rows_pad_what_tma_cannot_address():
    """D = 2080 gives 65 scales (130 bytes) a row: the maps read a copy
    padded to 72 values; D = 2048's 64 scales are read as they are."""
    pack = qm.pack_q8_0(_weight(2080, 16, 9).T)
    padded = qm.scale_rows(pack.scale)
    assert padded.shape == (16, 72) and torch.equal(padded[:, :65], pack.scale)
    assert not padded[:, 65:].any()
    whole = qm.pack_q8_0(_weight(2048, 16, 9).T)
    assert qm.scale_rows(whole.scale) is whole.scale


# ---------------------------------------------------------------------------
# alignment: the kernels stage x and the packs 16 bytes at a time

def test_misaligned_pack_field_is_refused():
    """A pack field at an address that is not a multiple of 16 bytes raises
    ValueError when the pack is placed for a kernel (on the card it would
    fault and end the CUDA context); an aligned one is placed."""
    pack = kq.pack_q6_k(_weight(256, 32, 3).T)
    cpu = torch.device("cpu")
    assert len(pack.kernel_ptrs(cpu)) == 3
    ql = torch.empty(pack.ql.numel() + 1, dtype=torch.int8)[1:].view_as(pack.ql)
    ql.copy_(pack.ql)
    bad = kq.Q6KPack(ql=ql, qh=pack.qh, s=pack.s)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        bad.kernel_ptrs(cpu)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        pa.check_aligned("x", torch.empty(65, dtype=torch.bfloat16)[1:])
