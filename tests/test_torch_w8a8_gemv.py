"""The persistent W8A8 GEMV (``csrc/w8a8_matmul.cu`` ``gemv_kernel``) of the
Q6_K, Q4_K, Q5_KS, Q2_KS, Q3_KS and Q8_0 packs and the Q4_K8, Q5_K and Q6_K8
byte codes, as far as the CPU reaches it.

- ``gemv_plan``, from shapes only: every output row in exactly one block and
  one tile of it, every row of x in one pass, the shared memory within the
  card's, the activation group the pack's, at Llama-3.2-1B's projection
  pairs and head, its tp = 2 shard pairs, an odd F (1001) and D = 1280
  (activation group 32 for the banded packs), for a card of 114 and of 132
  SMs; it refuses what the kernel refuses. ``gemv_takes`` routes a byte-code
  pack whose D is no multiple of 256 (phase 3's edges, D = 1056 and 2080),
  and int8 at every D, to ``w8a8_kernel`` by shape, and every shape the
  model serves to the GEMV.
- A torch integer mirror of the span decoders (``Q6K``, ``Q4K``, ``Q5KS``,
  ``Q2KS``, ``Q3KS``, ``ByteCodes`` and ``AffineBytes`` of
  ``csrc/quant_tile.cuh``: the bit tricks, each lane order's chunks, the
  column map, the scale and offset indices) equals the pack's
  ``codes_and_scales`` and ``offsets`` on every byte value of every plane.
- A torch mirror of the kernel's arithmetic (the plan's blocks, tiles and
  passes; each lane's spans in order and its sub-blocks in its lane order,
  each sub-block's term fused into the lane's f32 accumulator; the warp's
  butterfly; a row's warps summed in order) against the JAX
  ``q6_k_w8a8_matmul_pallas`` / ``q4_k_w8a8_matmul_pallas`` /
  ``q5_ks_w8a8_matmul_pallas`` / ``q2_ks_w8a8_matmul_pallas`` /
  ``q3_ks_w8a8_matmul_pallas`` / ``gw8a8_matmul_pallas`` (the byte codes,
  with their offsets for Q4_K8 and Q5_K) in interpret mode, on the same
  numpy inputs: max error <= 1e-5 x max |ref| in f32 (the f32 order
  differs), one bf16 ulp of max |ref| in bf16.
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

# kind: the bands its layout pairs in a byte (1: one plane; the activation
# group divides D / bands), its rows a scale, and the lane bits that order a
# span's chunks (quant_tile.cuh `order`)
LAYOUT = {"q6_k": (4, 16, 0), "q5_ks": (2, 32, 1), "q2_ks": (4, 16, 0), "q4_k": (2, 32, 1),
          "q3_ks": (4, 16, 0), "q8_0": (1, 32, 2), "q4_k8": (1, 32, 2), "q5_k": (1, 32, 2),
          "q6_k8": (1, 16, 2)}
SUB = {k: v[1] for k, v in LAYOUT.items()}
BYTE_KINDS = ("q8_0", "q4_k8", "q5_k", "q6_k8")


def span_bands(kind: str) -> int:
    """A span's sub-blocks (the span view's BANDS): 64 / SUB."""
    return 64 // SUB[kind]


def lane_order(kind: str, lane: int) -> int:
    """``Dec::order(lane)``: the lane's chunk order h (span chunk j taken
    j-th is chunk j ^ h)."""
    return {0: 0, 1: (lane >> 2) & 1, 2: (lane >> 1) & 3}[LAYOUT[kind][2]]


def sub_col(kind: str, s: int, k: int, D: int) -> int:
    """``Dec::col``: the first column of sub-block k of span s (a banded
    pack's band k, a byte-code pack's k-th sub-block of the span)."""
    if kind in BYTE_KINDS:
        return 64 * s + SUB[kind] * k
    bands = span_bands(kind)
    return k * (D // bands) + s * (64 // bands)

# phase 3's (D, F) pairs of chip_smoke.py, its odd F and its D = 1280 edge;
# llama3-8b's and llama3-70b's down projections, whose rows of x go in
# passes, and a D whose one-row tile outgrows the ring
PAIRS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256),
         (2048, 1001), (1280, 1024), (14336, 4096), (28672, 8192), (65536, 1024)]
# the tp = 2 shard pairs the byte-code packs serve (wq, wk_wv, wo, gate_up,
# down; the head is whole)
SHARD_PAIRS = [(2048, 1024), (2048, 256), (1024, 2048), (2048, 4096), (4096, 2048)]


# --------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("D,F", PAIRS + SHARD_PAIRS)
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
        assert p.group == (qm.GROUP if (D // LAYOUT[kind][0]) % 256 == 0 else 32)
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


@pytest.mark.parametrize("args", [("int8", 4, 2048, 8192), ("q4_k", 4, 1000, 8192),
                                  ("q2_ks", 0, 2048, 8192), ("q2_ks", 33, 2048, 8192),
                                  ("q5_ks", 4, 1000, 8192), ("q5_ks", 4, 128, 8192),
                                  ("q2_ks", 4, 2048, 0)])
def test_gemv_plan_refuses(args):
    with pytest.raises(ValueError):
        qm.gemv_plan(*args, 132)


def test_the_gemv_route_is_by_shape():
    """The GEMV takes every GEMV kind at a D that is a multiple of 256:
    every pair, shard pair and head the model serves, and the banded packs'
    group-32 edge (D = 1280). A byte-code pack whose D is not (phase 3's
    edges: the tp shards' D = 1056, Q8_0's D = 2080) runs ``w8a8_kernel``,
    which the GEMV's plan refuses; int8 always does."""
    for kind in qm.GEMV_KINDS:
        for D, F in PAIRS + SHARD_PAIRS:
            assert qm.gemv_takes(kind, D), (kind, D)
            qm.gemv_plan(kind, 4, D, F, 132)
    for kind, D in [("q8_0", 2080), ("q5_k", 1056), ("q4_k8", 1056), ("q6_k8", 1056)]:
        assert not qm.gemv_takes(kind, D)
        with pytest.raises(ValueError):
            qm.gemv_plan(kind, 4, D, 1024, 132)
    assert not any(qm.gemv_takes("int8", D) for D, _ in PAIRS + SHARD_PAIRS)
    assert set(qm.GEMV_KINDS) == set(LAYOUT)


@pytest.mark.parametrize("kind,D", [("q8_0", 2080), ("q8_0", 2304), ("q6_k8", 1056),
                                    ("q6_k8", 2304), ("q5_k", 1056), ("q6_k", 1280),
                                    ("q4_k", 1280), ("q3_ks", 1280), ("q3_ks", 2048)])
def test_the_plan_group_is_the_packs(kind, D):
    """``gemv_plan``'s activation group is the pack's (``act_group``): a
    one-plane pack's group follows D, a banded pack's its band."""
    pack = _byte_pack(kind, 4, D)
    assert pack.group == qm.act_group(D, LAYOUT[kind][0])
    if qm.gemv_takes(kind, D):
        assert qm.gemv_plan(kind, 4, D, 100, 132).group == pack.group


# --------------------------------------------------------------------------
# the span decoders

M32 = 0xFFFFFFFF


def _words(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4n] → the n little-endian 32-bit words, int64 [..., n]."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _fifth_bits(bits: torch.Tensor) -> torch.Tensor:
    return (((bits * 0x00204081) & M32) & 0x01010101) << 4


def _vsub4(w: torch.Tensor, c: int) -> torch.Tensor:
    """``__vsub4(w, c)``: each byte of w less c's, modulo 256."""
    return sum((((w >> (8 * j)) - (c >> (8 * j))) & 0xFF) << (8 * j) for j in range(4))


def _span_q2ks(pack, s: int, h: int):
    """``Q2KS``'s span: band k's one chunk, w[i] = (word i >> 2k) &
    0x03030303, the words of q2l[:, 16s : 16s + 16]; h plays no part."""
    v = _words(pack.q2l.view(torch.uint8)[:, 16 * s:16 * s + 16])  # [F, 4]
    return [[(v >> (2 * k)) & 0x03030303] for k in range(4)]        # [band][chunk] [F, 4]


def _span_q5ks(pack, s: int, h: int):
    """``Q5KS``'s span: chunk 0 the 16 positions at 16h, chunk 1 the
    other 16, each from its q5n bytes and its four q5h bytes."""
    n = pack.q5n.view(torch.uint8)[:, 32 * s:32 * s + 32]
    hw = _words(pack.q5h.view(torch.uint8)[:, 8 * s:8 * s + 8])      # [F, 2]: x, y
    out = [[], []]
    for c in range(2):
        half = c ^ h
        v = _words(n[:, 16 * half:16 * half + 16])                  # [F, 4]
        hb = hw[:, half:half + 1]
        hi = torch.cat([(hb >> (8 * i)) for i in range(4)], dim=1)  # [F, 4]
        out[0].append((v & 0x0F0F0F0F) | _fifth_bits(hi & 0xF))
        out[1].append(((v >> 4) & 0x0F0F0F0F) | _fifth_bits((hi >> 4) & 0xF))
    return out


def _span_q4k(pack, s: int, h: int):
    """``Q4K``'s span: chunk 0 the 16 qs bytes at 32 s + 16 h, chunk 1 the
    other 16; band k's codes the nibble at 4k of each byte."""
    n = pack.qs.view(torch.uint8)[:, 32 * s:32 * s + 32]
    v = [_words(n[:, 16 * (c ^ h):16 * (c ^ h) + 16]) for c in range(2)]   # [chunk] [F, 4]
    return [[(w >> (4 * k)) & 0x0F0F0F0F for w in v] for k in range(2)]


def _span_q3ks(pack, s: int, h: int):
    """``Q3KS``'s span: l = q3l[:, 16s : 16s + 16], hw = the two words of
    q3h[:, 8s : 8s + 8]; band k's one chunk is ``decode4`` of word i of l
    with the half-word i % 2 of hw[i // 2] at sh = 2k: the two bits at sh
    of each byte, the third bits of its rows 4i .. 4i + 3 from bits sh, sh
    + 1 of the half-word's two bytes, minus 4 bytewise. h plays no part."""
    lw = _words(pack.q3l.view(torch.uint8)[:, 16 * s:16 * s + 16])         # [F, 4]
    hw = _words(pack.q3h.view(torch.uint8)[:, 8 * s:8 * s + 8])            # [F, 2]
    half = torch.stack([hw[:, 0], hw[:, 0] >> 16, hw[:, 1], hw[:, 1] >> 16], dim=1)
    out = []
    for k in range(4):
        sh = 2 * k
        lo = (lw >> sh) & 0x03030303
        bits = ((half >> sh) & 3) | (((half >> (8 + sh)) & 3) << 2)
        hi = (((bits * 0x00204081) & M32) & 0x01010101) << 2
        out.append([_vsub4(lo | hi, 0x04040404)])
    return out


def _span_q6k(pack, s: int, h: int):
    """``Q6K``'s span: la = ql[:, 16s:], lb = ql[:, D/4 + 16s:], hq =
    qh[:, 16s:], 16 bytes each; band k's one chunk is ``decode4``: the
    nibble at 4 (k >> 1) of lb (k odd) or la, the two bits at 2k of hq,
    minus 32 bytewise. h plays no part."""
    D = pack.shape[1]
    ql, qh = pack.ql.view(torch.uint8), pack.qh.view(torch.uint8)
    la = _words(ql[:, 16 * s:16 * s + 16])
    lb = _words(ql[:, D // 4 + 16 * s:D // 4 + 16 * s + 16])
    hq = _words(qh[:, 16 * s:16 * s + 16])
    out = []
    for k in range(4):
        lo = ((lb if k & 1 else la) >> (4 * (k >> 1))) & 0x0F0F0F0F
        hi = ((hq >> (2 * k)) & 0x03030303) << 4
        out.append([_vsub4(lo | hi, 0x20202020)])
    return out


def _span_bytes(pack, s: int, h: int):
    """``ByteCodes``' span: v[j] the span's chunk j ^ h of the 64 codes at
    64 s; the sub-block taken k-th is chunks v[k CH .. (k + 1) CH)."""
    q = pack._buffers[pack.fields[0]].view(torch.uint8)[:, 64 * s:64 * s + 64]
    v = [_words(q[:, 16 * (j ^ h):16 * (j ^ h) + 16]) for j in range(4)]
    ch = SUB[pack.kind] // 16
    return [v[k * ch:(k + 1) * ch] for k in range(span_bands(pack.kind))]


SPANS = {"q2_ks": _span_q2ks, "q5_ks": _span_q5ks, "q6_k": _span_q6k, "q4_k": _span_q4k,
         "q3_ks": _span_q3ks,
         **{k: _span_bytes for k in BYTE_KINDS}}


def _every_byte(rows: int, cols: int, step: int) -> torch.Tensor:
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    return ((r * step + c) % 256).to(torch.uint8).view(torch.int8)


def _byte_pack(kind: str, F: int, D: int):
    """A ``kind`` pack [F, D] whose code planes hold every byte value, with
    random scales (and offsets)."""
    gen = torch.Generator().manual_seed(3)
    a = torch.rand(F, D // SUB[kind], generator=gen).bfloat16()
    b = torch.rand(F, D // SUB[kind], generator=gen).bfloat16()
    if kind == "q2_ks":
        return kq.Q2KSPack(q2l=_every_byte(F, D // 4, 37), a=a, b=b)
    if kind == "q5_ks":
        return kq.Q5KSPack(q5n=_every_byte(F, D // 2, 37), q5h=_every_byte(F, D // 8, 64),
                           a=a, b=b)
    if kind == "q4_k":
        return kq.Q4KPack(qs=_every_byte(F, D // 2, 37), a=a, b=b)
    if kind == "q3_ks":
        return kq.Q3KSPack(q3l=_every_byte(F, D // 4, 37), q3h=_every_byte(F, D // 8, 64), s=a)
    if kind == "q6_k":
        return kq.Q6KPack(ql=_every_byte(F, D // 2, 37), qh=_every_byte(F, D // 4, 64), s=a)
    if kind == "q8_0":
        return qm.Q8_0Pack(qs=_every_byte(F, D, 37), scale=a)
    if kind == "q6_k8":
        return kq.Q6K8Pack(q6=_every_byte(F, D, 37), s=a)
    cls = {"q4_k8": kq.Q4K8Pack, "q5_k": kq.Q5KPack}[kind]
    return cls(**{cls.fields[0]: _every_byte(F, D, 37), "a": a, "b": b})


# each lane order a kind's decoder takes (and h = 1 for Q2_KS and Q6_K,
# whose one order ignores it)
@pytest.mark.parametrize("kind,h", [(k, h) for k in qm.GEMV_KINDS
                                    for h in range(max(2, 1 << LAYOUT[k][2]))])
def test_span_decoders_equal_codes_and_scales(kind, h):
    """Every span of every row decoded as the kernel's span view does, in
    lane order h, its codes put back at the columns the kernel multiplies
    them with (chunk c of the sub-block taken k-th, kb = k ^ (h / CH), at x
    columns col(s, kb) + 16 (c ^ (h % CH)) + 4i + byte), equals the pack's
    codes on every byte value of each plane; its scale and offset are those
    of the sub-block there."""
    F, D = 4, 1024
    pack = _byte_pack(kind, F, D)
    for name in pack.fields:
        if getattr(pack, name).dtype == torch.int8:
            assert torch.unique(getattr(pack, name)).numel() == 256, name
    want, a = pack.codes_and_scales()
    b = pack.offsets()
    ho = h & ((1 << LAYOUT[kind][2]) - 1)   # the order the decoder takes
    bands, sub, n_span = span_bands(kind), SUB[kind], D // 64
    ch = sub // 16
    got = torch.full((F, D), -1000, dtype=torch.int64)
    for s in range(n_span):
        w = SPANS[kind](pack, s, ho)
        for k in range(bands):
            kb = k ^ (ho // ch)
            col = sub_col(kind, s, kb, D)
            assert len(w[k]) == ch
            for c, words in enumerate(w[k]):
                x0 = col + 16 * (c ^ (ho % ch))
                for i in range(4):
                    for j in range(4):
                        byte = (words[:, i] >> (8 * j)) & 0xFF
                        got[:, x0 + 4 * i + j] = torch.where(byte > 127, byte - 256, byte)
            # the span view's scale and offset index (band_scale): a banded
            # pack's kb · D/64 + s, a byte-code pack's s · BANDS + kb; the
            # sub-block col / sub
            idx = s * bands + kb if kind in BYTE_KINDS else kb * n_span + s
            assert idx == col // sub
            assert torch.equal(a[:, idx], a[:, col // sub])
            if b is not None:
                assert torch.equal(b[:, idx], b[:, col // sub])
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
    (mod 32 · warps_per_row) in order, and of each span the sub-blocks in
    the lane's order (k ^ (h / CH), h = ``order(lane)``): acc = fma(xs,
    float(P) · a, acc), and for an affine pack acc = fma(-(float(S) · xs),
    b, acc); then each warp's butterfly (xor 16, 8, 4, 2, 1) and the row's
    warps summed in order. A row's sum is the same whichever block and tile
    hold it, so each pass's rows are computed at once."""
    kind, (M, D), F = pack.kind, x.shape, pack.shape[0]
    bands, sub, n_span, wpr = span_bands(kind), SUB[kind], D // 64, plan.warps_per_row
    ch = sub // 16
    xq, xs = qm.quantize_acts(x, plan.group)
    codes, a = pack.codes_and_scales()
    b = pack.offsets()
    # exact integer dots P [M, F, D/sub] and sums S [M, D/sub]
    xb = xq.double().reshape(M, D // sub, sub)
    P = torch.einsum("msk,fsk->mfs", xb, codes.double().reshape(F, D // sub, sub)).float()
    S = xb.sum(-1).float()
    sub_col0 = torch.arange(D // sub) * sub
    sx = S * xs[:, sub_col0 // plan.group]                           # float(S) · xs, f32
    af = a.float()
    bf = None if b is None else b.float()
    out = torch.full((M, F), float("nan"))
    written = torch.zeros(M, F, dtype=torch.int64)

    def rows_out(m0: int, mrows: int) -> torch.Tensor:
        ms = slice(m0, m0 + mrows)
        acc = torch.zeros(mrows, F, 32 * wpr)
        for s in range(n_span):
            w = s % (32 * wpr)
            h = lane_order(kind, w % 32)
            for k in range(bands):
                sb = sub_col(kind, s, k ^ (h // ch), D) // sub
                pa = P[ms, :, sb] * af[:, sb][None]                  # float(P) · a
                acc[..., w] = _fma(xs[ms, sb * sub // plan.group][:, None], pa, acc[..., w])
                if bf is not None:
                    acc[..., w] = _fma(-sx[ms, sb][:, None], bf[:, sb][None], acc[..., w])
        v = acc.reshape(mrows, F, wpr, 32)
        lane = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        total = v[..., 0, 0]
        for sl in range(1, wpr):
            total = total + v[..., sl, 0]
        return total

    for p in range(plan.passes):
        m0 = p * plan.m_slice
        mrows = min(plan.m_slice, M - m0)
        rows = rows_out(m0, mrows)
        for blk in range(plan.grid):
            lo, hi = blk * plan.rows_per_block, min(F, (blk + 1) * plan.rows_per_block)
            for r0 in range(lo, hi, plan.rows_per_tile):
                nr = min(plan.rows_per_tile, hi - r0)
                out[m0:m0 + mrows, r0:r0 + nr] = rows[:, r0:r0 + nr]
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
    if kind == "q5_ks":
        return jkq.q5_ks_w8a8_matmul_pallas(xq, xs, f["q5n"], f["q5h"], f["a"], f["b"],
                                            out_dtype=out_dtype, interpret=True)
    if kind == "q6_k":
        return jkq.q6_k_w8a8_matmul_pallas(xq, xs, f["ql"], f["qh"], f["s"],
                                           out_dtype=out_dtype, interpret=True)
    if kind == "q4_k":
        return jkq.q4_k_w8a8_matmul_pallas(xq, xs, f["qs"], f["a"], f["b"],
                                           out_dtype=out_dtype, interpret=True)
    if kind == "q3_ks":
        return jkq.q3_ks_w8a8_matmul_pallas(xq, xs, f["q3l"], f["q3h"], f["s"],
                                            out_dtype=out_dtype, interpret=True)
    # the byte codes: the reference's gw8a8 over the code plane, its scales
    # and (Q4_K8, Q5_K) its offsets
    code, sc = (f[n] for n in CODE_FIELDS[kind])
    return jqm.gw8a8_matmul_pallas(xq, xs, code, sc, f.get("b"), sb=SUB[kind],
                                   out_dtype=out_dtype, interpret=True)


CODE_FIELDS = {"q8_0": ("qs", "scale"), "q4_k8": ("q4", "a"), "q5_k": ("q5", "a"),
               "q6_k8": ("q6", "s")}


def _packs(kind, w):
    """(the JAX pack of w [D, F], the port's of w.T)."""
    name = f"pack_{kind}"
    jmod, tmod = (jqm, qm) if kind == "q8_0" else (jkq, kq)
    return getattr(jmod, name)(w), getattr(tmod, name)(w.T)


# (kind, D): the activation group 256 (the band a multiple of 256) and 32
# (the banded packs at D = 1280; a byte-code pack's D at the GEMV is a
# multiple of 256, so its group is); D = 4096 gives two warps a row
# (warps_per_row 2)
GEMV_SHAPES = [("q2_ks", 1024), ("q2_ks", 1280), ("q5_ks", 512), ("q5_ks", 1280),
               ("q6_k", 1024), ("q6_k", 1280), ("q4_k", 512), ("q4_k", 1280), ("q3_ks", 1024),
               ("q3_ks", 1280), ("q8_0", 512), ("q4_k8", 512), ("q5_k", 512), ("q6_k8", 512)]
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
                                      ("q5_ks", 512, 32), ("q5_ks", 1280, 4),
                                      ("q6_k", 1280, 4), ("q4_k", 512, 3), ("q3_ks", 1280, 16),
                                      ("q8_0", 512, 16),
                                      ("q4_k8", 512, 1), ("q5_k", 512, 32),
                                      ("q6_k8", 512, 3)])
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
