"""The persistent W8A8 GEMV of the Q2_KS and Q5_KS packs (``csrc/w8a8_matmul.cu``
``gemv_kernel``), as far as the CPU reaches it.

- ``gemv_plan``, from shapes only: every output row in exactly one block and
  one tile of it, every row of x in one pass, the shared memory within the
  card's, at Llama-3.2-1B's projection pairs and head, an odd F (1001) and
  D = 1280 (activation group 32), for a card of 114 and of 132 SMs; it
  refuses what the kernel refuses.
- A torch integer mirror of the span decoders (``Q2KS::span`` and
  ``Q5KS::span`` of ``csrc/quant_tile.cuh``: the bit tricks, the swizzled
  chunk order, the scale and offset indices) equals the pack's
  ``codes_and_scales`` and ``offsets`` on every byte value of every plane.
- A torch mirror of the kernel's arithmetic (the plan's blocks, tiles and
  passes; each lane's spans in order, each band's sub-block term fused into
  the lane's f32 accumulator; the warp's butterfly; a row's warps summed in
  order) against the JAX ``q2_ks_w8a8_matmul_pallas`` /
  ``q5_ks_w8a8_matmul_pallas`` in interpret mode, on the same numpy inputs:
  max error <= 1e-5 x max |ref| in f32 (the f32 order differs), one bf16 ulp
  of max |ref| in bf16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import kquant_matmul as jkq
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

# the reference's activation quantization as its serving path runs it (jitted)
jax_quantize_acts = jax.jit(jqm.quantize_acts, static_argnums=1)

BANDS = {"q2_ks": 4, "q5_ks": 2}
SUB = {"q2_ks": 16, "q5_ks": 32}

# phase 3's (D, F) pairs of chip_smoke.py, its odd F and its D = 1280 edge;
# llama3-8b's and llama3-70b's down projections, whose rows of x go in
# passes, and a D whose one-row tile outgrows the ring
PAIRS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256),
         (2048, 1001), (1280, 1024), (14336, 4096), (28672, 8192), (65536, 1024)]


# --------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("D,F", PAIRS)
@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("kind", qm.GEMV_KINDS)
def test_gemv_plan_covers_every_row_once(kind, sms, D, F):
    for M in range(1, qm.W8A8_MAX_M + 1):
        p = qm.gemv_plan(kind, M, D, F, sms)
        seen = np.zeros(F, np.int64)
        for b in range(p.grid):
            lo, hi = b * p.rows_per_block, min(F, (b + 1) * p.rows_per_block)
            assert lo < hi, (M, b)                  # no block without rows
            tiles = -(-(hi - lo) // p.rows_per_tile)
            for t in range(tiles):
                r0 = lo + t * p.rows_per_tile
                seen[r0:min(hi, r0 + p.rows_per_tile)] += 1
        assert (seen == 1).all(), M
        rows_x = [min(p.m_slice, M - i * p.m_slice) for i in range(p.passes)]
        assert min(rows_x) > 0 and sum(rows_x) == M and p.m_slice <= M
        # a lane takes one span of lane_rows rows at a time; a row's spans go
        # once or twice over its warps' lanes (more only past D = 16384)
        assert p.lane_rows == qm.gemv_lane_rows(kind, p.m_slice) in (2, 4)
        assert p.rows_per_tile == qm.GEMV_WARPS // p.warps_per_row * p.lane_rows
        assert p.warps_per_row in (1, 2, 4, 8)
        assert p.warps_per_row == 1 or 32 * p.warps_per_row <= D // 64
        assert D // 64 < 64 * p.warps_per_row or p.warps_per_row == 8
        assert 1 <= p.stages <= min(qm.GEMV_MAX_STAGES, -(-p.rows_per_block // p.rows_per_tile))
        assert p.group == (qm.GROUP if (D // BANDS[kind]) % 256 == 0 else 32)
        assert p.smem == qm.gemv_smem(kind, D, p.group, p.rows_per_tile, p.stages, p.m_slice)
        assert p.smem <= qm.GEMV_SMEM_MAX
        assert p.blocks_per_sm * (p.smem + 1024) <= qm.GEMV_SM_SMEM
        assert p.blocks_per_sm == 1 or p.passes == 1
        assert p.grid <= sms * p.blocks_per_sm
        # fewer passes would not fit, even with a one-stage ring
        if p.passes > 1:
            fewer = -(-M // (p.passes - 1))
            rows = qm.GEMV_WARPS // p.warps_per_row * qm.gemv_lane_rows(kind, fewer)
            assert qm.gemv_smem(kind, D, p.group, rows, 1, fewer) > qm.GEMV_SMEM_MAX


def test_gemv_plan_is_shape_only():
    """Ints in, the same plan out, cached by shape; a pack's values play no
    part (the wrapper calls it with the shapes alone)."""
    a = qm.gemv_plan("q5_ks", 4, 2048, 8192, 132)
    assert a == qm.gemv_plan("q5_ks", 4, 2048, 8192, 132)
    assert a is qm.gemv_plan("q5_ks", 4, 2048, 8192, 132)
    assert a.passes == 1 and a.blocks_per_sm == 2 and a.grid == 256 and a.lane_rows == 2


@pytest.mark.parametrize("args", [("q8_0", 4, 2048, 8192), ("q3_ks", 4, 2048, 8192),
                                  ("q2_ks", 0, 2048, 8192), ("q2_ks", 33, 2048, 8192),
                                  ("q5_ks", 4, 1000, 8192), ("q5_ks", 4, 128, 8192),
                                  ("q2_ks", 4, 2048, 0)])
def test_gemv_plan_refuses(args):
    with pytest.raises(ValueError):
        qm.gemv_plan(*args, 132)


# --------------------------------------------------------------------------
# the span decoders

M32 = 0xFFFFFFFF


def _words(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4n] → the n little-endian 32-bit words, int64 [..., n]."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _fifth_bits(bits: torch.Tensor) -> torch.Tensor:
    return (((bits * 0x00204081) & M32) & 0x01010101) << 4


def _span_q2ks(q2l: torch.Tensor, s: int, h: int):
    """``Q2KS::span``'s codes: w[k][i] = (word i >> 2k) & 0x03030303, the
    words of q2l[:, 16s : 16s + 16]; one chunk a band (h plays no part)."""
    v = _words(q2l.view(torch.uint8)[:, 16 * s:16 * s + 16])        # [F, 4]
    return [[(v >> (2 * k)) & 0x03030303] for k in range(4)]        # [band][chunk] [F, 4]


def _span_q5ks(q5n: torch.Tensor, q5h: torch.Tensor, s: int, h: int):
    """``Q5KS::span``'s codes: chunk 0 the 16 positions at 16h, chunk 1 the
    other 16, each from its q5n bytes and its four q5h bytes."""
    n = q5n.view(torch.uint8)[:, 32 * s:32 * s + 32]
    hw = _words(q5h.view(torch.uint8)[:, 8 * s:8 * s + 8])           # [F, 2]: x, y
    out = [[], []]
    for c in range(2):
        half = c ^ h
        v = _words(n[:, 16 * half:16 * half + 16])                  # [F, 4]
        hb = hw[:, half:half + 1]
        hi = [(hb >> (8 * i)) for i in range(4)]
        hi = torch.cat(hi, dim=1)                                   # [F, 4]
        out[0].append((v & 0x0F0F0F0F) | _fifth_bits(hi & 0xF))
        out[1].append(((v >> 4) & 0x0F0F0F0F) | _fifth_bits((hi >> 4) & 0xF))
    return out


def _every_byte(rows: int, cols: int, step: int) -> torch.Tensor:
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    return ((r * step + c) % 256).to(torch.uint8).view(torch.int8)


def _byte_pack(kind: str, F: int, D: int):
    gen = torch.Generator().manual_seed(3)
    a = torch.rand(F, D // SUB[kind], generator=gen).bfloat16()
    b = torch.rand(F, D // SUB[kind], generator=gen).bfloat16()
    if kind == "q2_ks":
        return kq.Q2KSPack(q2l=_every_byte(F, D // 4, 37), a=a, b=b)
    return kq.Q5KSPack(q5n=_every_byte(F, D // 2, 37), q5h=_every_byte(F, D // 8, 64), a=a, b=b)


@pytest.mark.parametrize("h", [0, 1])
@pytest.mark.parametrize("kind", qm.GEMV_KINDS)
def test_span_decoders_equal_codes_and_scales(kind, h):
    """Every span of every row decoded as the kernel's span view does, its
    codes put back at the columns the kernel multiplies them with (x columns
    k·D/BANDS + s·64/BANDS + 16·(c ^ h) + 4i + byte), equals the pack's
    codes on every byte value of each plane; its scale and offset are those
    of the sub-block there."""
    F, D = 4, 1024
    pack = _byte_pack(kind, F, D)
    for name in pack.fields[:-2]:
        assert torch.unique(getattr(pack, name)).numel() == 256, name
    want, a = pack.codes_and_scales()
    b = pack.offsets()
    bands, sub, n_span = BANDS[kind], SUB[kind], D // 64
    got = torch.full((F, D), -1000, dtype=torch.int64)
    for s in range(n_span):
        w = (_span_q2ks(pack.q2l, s, h) if kind == "q2_ks"
             else _span_q5ks(pack.q5n, pack.q5h, s, h))
        for k in range(bands):
            col = k * (D // bands) + s * (64 // bands)
            for c, words in enumerate(w[k]):
                x0 = col + 16 * (c ^ h) if len(w[k]) == 2 else col
                for i in range(4):
                    for j in range(4):
                        byte = (words[:, i] >> (8 * j)) & 0xFF
                        got[:, x0 + 4 * i + j] = torch.where(byte > 127, byte - 256, byte)
            # the span view's scale and offset indices: k · D/64 + s, the
            # sub-block col / sub
            assert k * n_span + s == col // sub
            assert torch.equal(a[:, k * n_span + s], a[:, col // sub])
            assert torch.equal(b[:, k * n_span + s], b[:, col // sub])
    assert torch.equal(got, want.to(torch.int64))


# --------------------------------------------------------------------------
# the kernel's arithmetic


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fmaf: the exact product (48 bits) plus c in f64, rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def gemv_mirror(x: torch.Tensor, pack, plan, out_dtype) -> torch.Tensor:
    """``gemv_kernel``'s function in its order: ``quantize_acts``; for each
    block, tile and pass of ``plan``, each output row's lanes (worker w =
    slice · 32 + lane of its ``warps_per_row`` warps) take the spans s ≡ w
    (mod 32 · warps_per_row) in order, and for each band k the sub-block
    term acc = fma(xs, float(P) · a, acc), acc = fma(-(float(S) · xs), b,
    acc); then each warp's butterfly (xor 16, 8, 4, 2, 1) and the row's
    warps summed in order."""
    kind, (M, D), F = pack.kind, x.shape, pack.shape[0]
    bands, sub, n_span, wpr = BANDS[kind], SUB[kind], D // 64, plan.warps_per_row
    xq, xs = qm.quantize_acts(x, plan.group)
    codes, a = pack.codes_and_scales()
    b = pack.offsets()
    # exact integer dots P [M, F, D/sub] and sums S [M, D/sub]
    xb = xq.double().reshape(M, D // sub, sub)
    P = torch.einsum("msk,fsk->mfs", xb, codes.double().reshape(F, D // sub, sub)).float()
    S = xb.sum(-1).float()
    sub_col = torch.arange(D // sub) * sub
    sx = S * xs[:, sub_col // plan.group]                            # float(S) · xs, f32
    af, bf = a.float(), b.float()
    out = torch.full((M, F), float("nan"))
    written = torch.zeros(M, F, dtype=torch.int64)

    def rows_out(m0: int, mrows: int, f0: int, nr: int) -> torch.Tensor:
        ms, fs = slice(m0, m0 + mrows), slice(f0, f0 + nr)
        acc = torch.zeros(mrows, nr, 32 * wpr)
        for s in range(n_span):
            w = s % (32 * wpr)
            for k in range(bands):
                col = k * (D // bands) + s * (64 // bands)
                sb = col // sub
                pa = P[ms, fs, sb] * af[fs, sb][None]                 # float(P) · a
                acc[..., w] = _fma(xs[ms, col // plan.group][:, None], pa, acc[..., w])
                acc[..., w] = _fma(-sx[ms, sb][:, None], bf[fs, sb][None], acc[..., w])
        v = acc.reshape(mrows, nr, wpr, 32)
        lane = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        total = v[..., 0, 0]
        for sl in range(1, wpr):
            total = total + v[..., sl, 0]
        return total

    for blk in range(plan.grid):
        lo, hi = blk * plan.rows_per_block, min(F, (blk + 1) * plan.rows_per_block)
        for p in range(plan.passes):
            m0 = p * plan.m_slice
            mrows = min(plan.m_slice, M - m0)
            for r0 in range(lo, hi, plan.rows_per_tile):
                nr = min(plan.rows_per_tile, hi - r0)
                out[m0:m0 + mrows, r0:r0 + nr] = rows_out(m0, mrows, r0, nr)
                written[m0:m0 + mrows, r0:r0 + nr] += 1
    assert (written == 1).all()
    return out.to(out_dtype)


def _weight(D, F, seed):
    return (np.random.default_rng(seed).normal(size=(D, F)) * 0.05).astype(np.float32)


def _jax_w8a8(kind, x, jp, out_dtype, group):
    f = {k: jnp.asarray(v) for k, v in jp.items()}
    xq, xs = jax_quantize_acts(x, group)
    if kind == "q2_ks":
        return jkq.q2_ks_w8a8_matmul_pallas(xq, xs, f["q2l"], f["a"], f["b"],
                                            out_dtype=out_dtype, interpret=True)
    return jkq.q5_ks_w8a8_matmul_pallas(xq, xs, f["q5n"], f["q5h"], f["a"], f["b"],
                                        out_dtype=out_dtype, interpret=True)


def _packs(kind, w):
    name = f"pack_{kind}"
    return getattr(jkq, name)(w), getattr(kq, name)(w.T)


# (kind, D): group 256 (the band a multiple of 256) and group 32; D = 4096
# gives two warps a row (warps_per_row 2)
GEMV_SHAPES = [("q2_ks", 1024), ("q2_ks", 1280), ("q5_ks", 512), ("q5_ks", 1280)]
F_ODD = 160   # no multiple of 128


@pytest.mark.parametrize("M", [1, 3, 4, 16, 32])
@pytest.mark.parametrize("kind,D", GEMV_SHAPES)
def test_gemv_mirror_matches_jax_pallas_f32(kind, D, M):
    jp, tp = _packs(kind, _weight(D, F_ODD, seed=M + D))
    x = np.random.default_rng(D * M).normal(size=(M, D)).astype(np.float32)
    plan = qm.gemv_plan(kind, M, D, F_ODD, 132)
    assert plan.group == tp.group
    ref = np.asarray(_jax_w8a8(kind, jnp.asarray(x), jp, jnp.float32, tp.group))
    got = gemv_mirror(torch.from_numpy(x), tp, plan, torch.float32).numpy()
    assert got.shape == (M, F_ODD)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind", qm.GEMV_KINDS)
def test_gemv_mirror_two_warps_a_row(kind):
    """D = 4096: two warps a row, summed in order; one SM so that a block
    walks several tiles, the last one ragged."""
    D, F, M = 4096, 100, 3
    jp, tp = _packs(kind, _weight(D, F, seed=11))
    x = np.random.default_rng(12).normal(size=(M, D)).astype(np.float32)
    plan = qm.gemv_plan(kind, M, D, F, 1)
    assert plan.warps_per_row == 2 and plan.rows_per_block > plan.rows_per_tile
    ref = np.asarray(_jax_w8a8(kind, jnp.asarray(x), jp, jnp.float32, tp.group))
    got = gemv_mirror(torch.from_numpy(x), tp, plan, torch.float32).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind,D,M", [("q2_ks", 1024, 4), ("q2_ks", 1280, 16),
                                      ("q5_ks", 512, 32), ("q5_ks", 1280, 4)])
def test_gemv_mirror_matches_jax_pallas_bf16(kind, D, M):
    jp, tp = _packs(kind, _weight(D, F_ODD, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(M, D)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(_jax_w8a8(kind, xj, jp, jnp.bfloat16, tp.group), np.float32)
    got = gemv_mirror(x, tp, qm.gemv_plan(kind, M, D, F_ODD, 132), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
