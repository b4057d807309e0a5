"""K-quant weights (Q2_K, Q3_K, Q4_K, Q5_K, Q6_K) kept quantized on the
device.

The counterpart of ``distributed_llm_pipeline_tpu/ops/kquant_matmul.py`` for
its single-device packs: Q6_K (the reference's demo checkpoint,
``orchestrator/src/main.rs:40``), Q4_K (its north-star Q4_K_M format) and the
sub-byte packs ``q5_ks``, ``q3_ks`` and ``q2_ks``. The GGUF super-blocks are
re-packed once at load into the JAX package's layout, transposed to
out-features-major like the port's ``F.linear`` weights; the quantized values
are exact:

    Q6_K  w = s · q, q ∈ [-32, 31] per 16-row sub-block along D
        ql  int8 [F, D/2]   4-bit plane: byte j holds row j in its low
                            nibble and row j + D/2 in its high nibble
        qh  int8 [F, D/4]   2-bit plane: bits 2k..2k+1 of byte j hold row
                            j + k·D/4 (the four quarter bands k = 0..3)
        s   bf16 [F, D/16]  effective scale (ggml d · sc, rounded to bf16)

    Q4_K  w = a · q − b, q ∈ [0, 15] per 32-row sub-block along D
        qs  int8 [F, D/2]   the 4-bit plane, paired as Q6_K's ql
        a   bf16 [F, D/32]  effective scale (ggml d · sc)
        b   bf16 [F, D/32]  effective offset (ggml dmin · m)

    Q5_KS w = a · q − b, q ∈ [0, 31] per 32-row sub-block along D
        q5n int8 [F, D/2]   the low 4 bits, paired as Q4_K's qs
        q5h int8 [F, D/8]   the fifth bit: byte t holds rows 4t..4t+3 in
                            bits 0..3 and rows D/2 + 4t.. in bits 4..7
        a, b                as Q4_K

    Q2_KS w = a · q − b, q ∈ [0, 3] per 16-row sub-block along D
        q2l int8 [F, D/4]   2-bit plane of four bands, as Q6_K's qh
        a   bf16 [F, D/16]  effective scale (ggml d · sc)
        b   bf16 [F, D/16]  effective offset (ggml dmin · m)

    Q3_KS w = s · q, q ∈ [-4, 3] per 16-row sub-block along D
        q3l int8 [F, D/4]   the low 2 bits, four bands as Q2_KS
        q3h int8 [F, D/8]   the third bit: bits 2k and 2k + 1 of byte t hold
                            rows 2t and 2t + 1 of band k; q = (low | hb << 2) − 4
        s   bf16 [F, D/16]  effective scale (ggml d · sc, sc signed)

The byte-code packs of tp > 1 meshes (the reference's ``byte_codes``): one
int8 code per logical row, so a tensor-parallel row shard splits every
field like a dense weight (a nibble or bit plane pairs rows across D and
cannot be split). The values are the same GGUF blocks':

    Q4_K8 w = a · q − b, q ∈ [0, 15] per 32-row sub-block along D
        q4  int8 [F, D];  a, b  bf16 [F, D/32]
    Q5_K  w = a · q − b, q ∈ [0, 31] per 32-row sub-block along D
        q5  int8 [F, D];  a, b  bf16 [F, D/32]
    Q6_K8 w = s · q, q ∈ [-32, 31] per 16-row sub-block along D
        q6  int8 [F, D];  s  bf16 [F, D/16]

So band k (rows [k·D/4, (k+1)·D/4)) of Q6_K reads its low 4 bits from the low
nibbles of ``ql``'s first half (k = 0), its second half (k = 1), or the high
nibbles of those (k = 2, 3), and its top 2 bits from bits 2k of ``qh``; the
two bands of Q4_K and Q5_KS (rows below and above D/2) read the low and the
high nibble of the same byte.

The packs go through the dispatch of ``ops/quant_matmul.py``. M ≤ 32 takes
the W8A8 integer dots (``csrc/w8a8_matmul.cu``; the activation group must
divide the band, so it is 256 where the band allows it, else 32; a byte
pack has no bands, its group is 256 where D allows it, else 32); M > 32
takes the fused dequant (``csrc/dequant_matmul.cu``) for Q6_K, Q4_K and
Q5_K (``q5_k_matmul``) and, for the sub-byte packs and the Q4_K8 and Q6_K8
byte packs, which have no fused kernel in the reference either, the dense
weight and one dense product. Each kernel decodes the bit planes itself
(``csrc/quant_tile.cuh`` at M ≤ 32; at M > 32 the GEMM of
``csrc/kquant_gemm.cuh``, cut by ``quant_matmul.gemm_plan``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.quants import (_fp16_field, _k4_scale_min, _q3k_unpack_scales, quant_q2_k,
                           quant_q3_k, quant_q4_k, quant_q5_k, quant_q6_k)
from .quant_matmul import QuantPack, _bf16, act_group, dequant_matmul_plain

SUB4 = 32   # Q4_K / Q5_K sub-block length along D
SUB6 = 16   # Q2_K / Q3_K / Q6_K sub-block length along D


def _two_bit_bands(plane: torch.Tensor) -> torch.Tensor:
    """A four-band 2-bit plane [F, D/4] → uint8 [F, D] in logical row order:
    band k (rows [k·D/4, (k+1)·D/4)) from bits 2k..2k+1."""
    u = plane.view(torch.uint8)
    return torch.cat([(u >> (2 * k)) & 3 for k in range(4)], dim=1)


class _FourBandPack(QuantPack):
    """A pack of 16-row sub-blocks whose 2-bit plane holds four bands per
    byte (Q6_K, Q2_KS, Q3_KS); its last field has one entry per sub-block."""

    sub = SUB6

    def _dense_shape(self) -> tuple[int, int]:
        per_sub = self._buffers[self.fields[-1]]
        return per_sub.shape[0], SUB6 * per_sub.shape[1]

    def _act_group(self) -> int:
        # the group must divide the band size D/4 (D % 256 == 0, so 32 does)
        return act_group(self.shape[1], 4)


class Q6KPack(_FourBandPack):
    kind = "q6_k"
    fields = ("ql", "qh", "s")

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        ql = self.ql.view(torch.uint8)
        lo = torch.cat([ql & 0x0F, ql >> 4], dim=1)                 # [F, D]
        q = (lo | (_two_bit_bands(self.qh) << 4)).to(torch.int16) - 32   # [-32, 31]
        return q.to(torch.int8), self.s


class Q2KSPack(_FourBandPack):
    kind = "q2_ks"
    fields = ("q2l", "a", "b")

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return _two_bit_bands(self.q2l).to(torch.int8), self.a       # [0, 3]

    def offsets(self) -> torch.Tensor:
        return self.b


class Q3KSPack(_FourBandPack):
    kind = "q3_ks"
    fields = ("q3l", "q3h", "s")

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.q3h.view(torch.uint8)                               # [F, D/8]
        Fo = h.shape[0]
        sh = torch.arange(2, dtype=torch.uint8, device=h.device)
        hb = torch.cat([((h[..., None] >> (2 * k + sh)) & 1).reshape(Fo, -1)
                        for k in range(4)], dim=1)                   # rows 2t, 2t + 1
        q = (_two_bit_bands(self.q3l) | (hb << 2)).to(torch.int16) - 4
        return q.to(torch.int8), self.s                              # [-4, 3]


class _TwoBandPack(QuantPack):
    """A nibble-paired affine pack (Q4_K, Q5_KS): w = a · q − b per 32 rows,
    the codes of rows d and d + D/2 in one byte of the first field."""

    sub = SUB4

    def _dense_shape(self) -> tuple[int, int]:
        plane = self._buffers[self.fields[0]]
        return plane.shape[0], 2 * plane.shape[1]

    def _act_group(self) -> int:
        # the group must divide the band size D/2 (D % 256 == 0, so 32 does)
        return act_group(self.shape[1], 2)

    def _low_nibbles(self) -> torch.Tensor:
        plane = self._buffers[self.fields[0]].view(torch.uint8)
        return torch.cat([plane & 0x0F, plane >> 4], dim=1)          # [F, D]

    def offsets(self) -> torch.Tensor:
        return self.b


class Q4KPack(_TwoBandPack):
    kind = "q4_k"
    fields = ("qs", "a", "b")

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._low_nibbles().to(torch.int8), self.a            # [0, 15]


class Q5KSPack(_TwoBandPack):
    kind = "q5_ks"
    fields = ("q5n", "q5h", "a", "b")

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.q5h.view(torch.uint8)                               # [F, D/8]
        sh = torch.arange(4, dtype=torch.uint8, device=h.device)
        Fo = h.shape[0]
        lo = ((h[..., None] >> sh) & 1).reshape(Fo, -1)              # rows 4t + s
        hi = ((h[..., None] >> (sh + 4)) & 1).reshape(Fo, -1)        # D/2 + 4t + s
        q = self._low_nibbles() | (torch.cat([lo, hi], dim=1) << 4)
        return q.to(torch.int8), self.a                              # [0, 31]


class _BytePack(QuantPack):
    """A byte-code pack: its first field holds one int8 code per logical row
    [F, D], its second one scale per ``sub`` rows; an affine pack's third
    field the offsets."""

    def _dense_shape(self) -> tuple[int, int]:
        return tuple(self._buffers[self.fields[0]].shape)

    def _act_group(self) -> int:
        # a tp row shard's D is only a multiple of 32
        return act_group(self.shape[1])

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._buffers[self.fields[0]], self._buffers[self.fields[1]]


class Q4K8Pack(_BytePack):
    kind = "q4_k8"
    fields = ("q4", "a", "b")
    sub = SUB4

    def offsets(self) -> torch.Tensor:
        return self.b


class Q5KPack(_BytePack):
    kind = "q5_k"
    fields = ("q5", "a", "b")
    sub = SUB4

    def offsets(self) -> torch.Tensor:
        return self.b


class Q6K8Pack(_BytePack):
    kind = "q6_k8"
    fields = ("q6", "s")
    sub = SUB6


def _host_f32(w: torch.Tensor | np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(torch.as_tensor(w).detach().to("cpu", torch.float32).numpy())


def _encode(w: torch.Tensor | np.ndarray, quant) -> tuple[np.ndarray, tuple[int, int]]:
    """A dense weight ``w [F, D]`` through a GGUF encoder on the host: its
    raw blocks and (D, F), as the ``*_from_gguf`` packers take them."""
    wn = _host_f32(w)
    Fo, D = wn.shape
    return np.frombuffer(quant(wn.reshape(-1)), np.uint8), (D, Fo)


def pack_q6_k(w: torch.Tensor | np.ndarray) -> Q6KPack:
    """Quantize a dense weight ``w [F, D]`` to Q6_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q6_k_from_gguf``."""
    return pack_q6_k_from_gguf(*_encode(w, quant_q6_k))


def _q6_k_codes(raw, shape: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """The codes of raw GGUF Q6_K super-blocks (210 B per 256 values) laid
    row-major over the (F, D) disk layout, one byte per logical row: uint8
    [F, D] in [0, 63] (the code + 32), and the effective scales ggml d · sc
    as f32 [F, D/16]. ``shape`` is (D, F)."""
    D, Fo = shape
    if D % 256:
        raise ValueError(f"Q6_K needs D % 256 == 0, got {D}")
    blk = np.frombuffer(np.ascontiguousarray(raw), np.uint8).reshape(-1, 210)
    ql = blk[:, 0:128].reshape(-1, 2, 64)
    qh = blk[:, 128:192].reshape(-1, 2, 32)
    scales = blk[:, 192:208].view(np.int8).astype(np.float32)   # (nb, 16)
    d = _fp16_field(blk, 208)                                   # (nb, 1)
    l_lo, l_hi = ql[:, :, :32], ql[:, :, 32:]
    q1 = (l_lo & 0x0F) | (((qh >> 0) & 3) << 4)
    q2 = (l_hi & 0x0F) | (((qh >> 2) & 3) << 4)
    q3 = (l_lo >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (l_hi >> 4) | (((qh >> 6) & 3) << 4)
    qb = np.concatenate([q1, q2, q3, q4], axis=2).reshape(Fo, D)
    return qb, (d * scales).reshape(Fo, D // SUB6)


def pack_q6_k_from_gguf(raw, shape: tuple[int, int]) -> Q6KPack:
    """A pack straight from raw GGUF Q6_K super-blocks (210 B per 256
    values) laid row-major over the (F, D) disk layout. ``shape`` is (D, F),
    as the reference takes it."""
    D, Fo = shape
    qb, s = _q6_k_codes(raw, shape)
    lo4 = qb & 0x0F
    ql_packed = (lo4[:, : D // 2] | (lo4[:, D // 2:] << 4)).astype(np.uint8)
    hi2 = (qb >> 4).reshape(Fo, 4, D // 4)
    qh_packed = (hi2[:, 0] | (hi2[:, 1] << 2) | (hi2[:, 2] << 4)
                 | (hi2[:, 3] << 6)).astype(np.uint8)
    return Q6KPack(ql=torch.from_numpy(ql_packed.view(np.int8)),
                   qh=torch.from_numpy(qh_packed.view(np.int8)), s=_bf16(s))


def _k_blocks(raw, shape: tuple[int, int], nbytes: int, name: str):
    """The (F·D/256, nbytes) super-blocks of a Q4_K or Q5_K tensor, and its
    per-32 affine parameters a = d · sc, b = dmin · m as f32 [F, D/32]."""
    D, Fo = shape
    if D % 256:
        raise ValueError(f"{name} needs D % 256 == 0, got {D}")
    blk = np.frombuffer(np.ascontiguousarray(raw), np.uint8).reshape(-1, nbytes)
    d = _fp16_field(blk, 0).reshape(Fo, D // 256, 1)
    dmin = _fp16_field(blk, 2).reshape(Fo, D // 256, 1)
    sc, mn = _k4_scale_min(blk[:, 4:16])                        # (nb, 8)
    a = (d * sc.reshape(Fo, D // 256, 8)).reshape(Fo, D // SUB4)
    b = (dmin * mn.reshape(Fo, D // 256, 8)).reshape(Fo, D // SUB4)
    return blk, a, b


def _nibble_pair(q: np.ndarray) -> torch.Tensor:
    """Codes [F, D] → the 4-bit plane [F, D/2]: row d in the low nibble and
    row d + D/2 in the high nibble of byte d."""
    lo = q & 0x0F
    half = q.shape[1] // 2
    return torch.from_numpy((lo[:, :half] | (lo[:, half:] << 4)).astype(np.uint8).view(np.int8))


def pack_q4_k(w: torch.Tensor | np.ndarray) -> Q4KPack:
    """Quantize a dense weight ``w [F, D]`` to Q4_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q4_k_from_gguf``."""
    return pack_q4_k_from_gguf(*_encode(w, quant_q4_k))


def pack_q4_k_from_gguf(raw, shape: tuple[int, int]) -> Q4KPack:
    """A pack straight from raw GGUF Q4_K super-blocks (144 B per 256
    values: fp16 d and dmin, 12 B of 6-bit scales and mins, 128 B of
    nibbles) laid row-major over the (F, D) disk layout. ``shape`` is
    (D, F), as the reference takes it."""
    D, Fo = shape
    blk, a, b = _k_blocks(raw, shape, 144, "Q4_K")
    qs = blk[:, 16:144].reshape(-1, 4, 32)
    q = np.stack([qs & 0x0F, qs >> 4], axis=2).reshape(Fo, D)  # logical rows
    return Q4KPack(qs=_nibble_pair(q), a=_bf16(a), b=_bf16(b))


def _q5_k_codes(blk: np.ndarray, Fo: int, D: int) -> np.ndarray:
    """The 5-bit codes of Q5_K super-blocks (176 B: fp16 d and dmin, 12 B of
    scales and mins, 32 B of fifth bits, 128 B of nibbles) widened to one
    byte per logical row: uint8 [F, D] in [0, 31]."""
    qh = blk[:, 16:48]                                          # (nb, 32)
    qs = blk[:, 48:176].reshape(-1, 4, 32)
    nib = np.stack([qs & 0x0F, qs >> 4], axis=2)                # (nb, 4, 2, 32)
    j = np.arange(4, dtype=np.uint8)[:, None]
    bit0 = (qh[:, None, :] >> (2 * j)) & 1                      # (nb, 4, 32)
    bit1 = (qh[:, None, :] >> (2 * j + 1)) & 1
    hbits = np.stack([bit0, bit1], axis=2)                      # (nb, 4, 2, 32)
    return (nib | (hbits << 4)).astype(np.uint8).reshape(Fo, D)


def pack_q5_ks(w: torch.Tensor | np.ndarray) -> Q5KSPack:
    """Quantize a dense weight ``w [F, D]`` to Q5_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q5_ks_from_gguf``."""
    return pack_q5_ks_from_gguf(*_encode(w, quant_q5_k))


def pack_q5_ks_from_gguf(raw, shape: tuple[int, int]) -> Q5KSPack:
    """The sub-byte pack straight from raw GGUF Q5_K super-blocks laid
    row-major over the (F, D) disk layout: the low 4 bits nibble-paired as
    Q4_K, the fifth bits eight codes a byte. ``shape`` is (D, F)."""
    D, Fo = shape
    blk, a, b = _k_blocks(raw, shape, 176, "Q5_K")
    q = _q5_k_codes(blk, Fo, D)
    hb = q >> 4                                                 # 0/1
    hl = hb[:, : D // 2].reshape(Fo, D // 8, 4)
    hh = hb[:, D // 2:].reshape(Fo, D // 8, 4)
    sh = np.arange(4, dtype=np.uint8)
    q5h = ((hl << sh) | (hh << (sh + 4))).sum(axis=2, dtype=np.uint8)
    return Q5KSPack(q5n=_nibble_pair(q), q5h=torch.from_numpy(q5h.view(np.int8)),
                    a=_bf16(a), b=_bf16(b))


def _four_bands(q: np.ndarray) -> np.ndarray:
    """2-bit codes [F, D] → the four-band plane [F, D/4]: row d + k·D/4 in
    bits 2k..2k+1 of byte d."""
    Fo, D = q.shape
    qb = q.reshape(Fo, 4, D // 4) & 3
    return (qb[:, 0] | qb[:, 1] << 2 | qb[:, 2] << 4 | qb[:, 3] << 6).astype(np.uint8)


def pack_q2_ks(w: torch.Tensor | np.ndarray) -> Q2KSPack:
    """Quantize a dense weight ``w [F, D]`` to Q2_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q2_ks_from_gguf``."""
    return pack_q2_ks_from_gguf(*_encode(w, quant_q2_k))


def pack_q2_ks_from_gguf(raw, shape: tuple[int, int]) -> Q2KSPack:
    """The sub-byte pack straight from raw GGUF Q2_K super-blocks (84 B per
    256 values: 16 B of 4-bit scales and mins, 64 B of 2-bit codes, fp16 d
    and dmin) laid row-major over the (F, D) disk layout: the codes four
    bands a byte, a and b per 16 rows. ``shape`` is (D, F)."""
    D, Fo = shape
    if D % 256:
        raise ValueError(f"Q2_K needs D % 256 == 0, got {D}")
    blk = np.frombuffer(np.ascontiguousarray(raw), np.uint8).reshape(-1, 84)
    scales = blk[:, 0:16]
    qs = blk[:, 16:80].reshape(-1, 2, 32)
    d = _fp16_field(blk, 80)
    dmin = _fp16_field(blk, 82)
    shifts = np.arange(4)[None, None, :, None]
    q = ((qs[:, :, None, :] >> (2 * shifts)) & 3).astype(np.uint8).reshape(Fo, D)
    a = (d * (scales & 0x0F)).reshape(Fo, D // SUB6)
    b = (dmin * (scales >> 4)).reshape(Fo, D // SUB6)
    return Q2KSPack(q2l=torch.from_numpy(_four_bands(q).view(np.int8)),
                    a=_bf16(a), b=_bf16(b))


def pack_q3_ks(w: torch.Tensor | np.ndarray) -> Q3KSPack:
    """Quantize a dense weight ``w [F, D]`` to Q3_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q3_ks_from_gguf``."""
    return pack_q3_ks_from_gguf(*_encode(w, quant_q3_k))


def pack_q3_ks_from_gguf(raw, shape: tuple[int, int]) -> Q3KSPack:
    """The sub-byte pack straight from raw GGUF Q3_K super-blocks (110 B per
    256 values: 32 B of third bits, 64 B of 2-bit codes, 12 B of 6-bit
    scales, fp16 d) laid row-major over the (F, D) disk layout: the low two
    bits four bands a byte, the third bits eight codes a byte, s per 16
    rows. ``shape`` is (D, F)."""
    D, Fo = shape
    if D % 256:
        raise ValueError(f"Q3_K needs D % 256 == 0, got {D}")
    blk = np.frombuffer(np.ascontiguousarray(raw), np.uint8).reshape(-1, 110)
    hmask = blk[:, 0:32]
    qs = blk[:, 32:96].reshape(-1, 2, 32)
    sc = _q3k_unpack_scales(blk[:, 96:108])                     # (nb, 16) signed
    d = _fp16_field(blk, 108)                                   # (nb, 1)
    shifts = np.arange(4)[None, None, :, None]
    lo = ((qs[:, :, None, :] >> (2 * shifts)) & 3).astype(np.uint8)
    g = np.arange(8)[None, :, None]
    hbit = ((hmask[:, None, :] >> g) & 1).reshape(-1, 2, 4, 32).astype(np.uint8)
    qu = (lo | (hbit << 2)).reshape(Fo, D)                      # 0..7, logical rows
    s = (d * sc).reshape(Fo, D // SUB6)
    hb = (qu >> 2).reshape(Fo, 4, D // 8, 2)                    # (band, t, row 2t + i)
    sh2 = np.arange(2, dtype=np.uint8)
    q3h = np.zeros((Fo, D // 8), np.uint8)
    for k in range(4):
        q3h |= (hb[:, k] << (2 * k + sh2)).sum(axis=2, dtype=np.uint8)
    return Q3KSPack(q3l=torch.from_numpy(_four_bands(qu).view(np.int8)),
                    q3h=torch.from_numpy(q3h.view(np.int8)), s=_bf16(s))


# --------------------------------------------------------------------------
# the byte-code packs of tp > 1 meshes


def pack_q4_k8_from_gguf(raw, shape: tuple[int, int]) -> Q4K8Pack:
    """The byte-code pack straight from raw GGUF Q4_K super-blocks laid
    row-major over the (F, D) disk layout: the 4-bit codes one byte per
    logical row, a and b per 32 rows. ``shape`` is (D, F)."""
    D, Fo = shape
    blk, a, b = _k_blocks(raw, shape, 144, "Q4_K")
    qs = blk[:, 16:144].reshape(-1, 4, 32)
    q = np.stack([qs & 0x0F, qs >> 4], axis=2).reshape(Fo, D)
    return Q4K8Pack(q4=torch.from_numpy(q.astype(np.int8)), a=_bf16(a), b=_bf16(b))


def pack_q4_k8(w: torch.Tensor | np.ndarray) -> Q4K8Pack:
    """Quantize a dense weight ``w [F, D]`` to Q4_K along D, on the host,
    into the byte-code pack."""
    return pack_q4_k8_from_gguf(*_encode(w, quant_q4_k))


def pack_q5_k_from_gguf(raw, shape: tuple[int, int]) -> Q5KPack:
    """The byte-code pack straight from raw GGUF Q5_K super-blocks laid
    row-major over the (F, D) disk layout: the 5-bit codes one byte per
    logical row, a and b per 32 rows. ``shape`` is (D, F)."""
    D, Fo = shape
    blk, a, b = _k_blocks(raw, shape, 176, "Q5_K")
    q = _q5_k_codes(blk, Fo, D)
    return Q5KPack(q5=torch.from_numpy(q.view(np.int8)), a=_bf16(a), b=_bf16(b))


def pack_q5_k(w: torch.Tensor | np.ndarray) -> Q5KPack:
    """Quantize a dense weight ``w [F, D]`` to Q5_K along D, on the host,
    into the byte-code pack."""
    return pack_q5_k_from_gguf(*_encode(w, quant_q5_k))


def pack_q6_k8_from_gguf(raw, shape: tuple[int, int]) -> Q6K8Pack:
    """The byte-code pack straight from raw GGUF Q6_K super-blocks laid
    row-major over the (F, D) disk layout: the 6-bit codes one signed byte
    per logical row, s per 16 rows. ``shape`` is (D, F)."""
    qb, s = _q6_k_codes(raw, shape)
    q = (qb.astype(np.int16) - 32).astype(np.int8)
    return Q6K8Pack(q6=torch.from_numpy(q), s=_bf16(s))


def pack_q6_k8(w: torch.Tensor | np.ndarray) -> Q6K8Pack:
    """Quantize a dense weight ``w [F, D]`` to Q6_K along D, on the host,
    into the byte-code pack."""
    return pack_q6_k8_from_gguf(*_encode(w, quant_q6_k))


def q5_k_matmul_plain(x: torch.Tensor, pack: Q5KPack,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The ``q5_k_matmul`` kernel's function (the reference's
    ``_q5k_kernel``), in plain PyTorch on any device: x [M, D] against a
    Q5_K byte-code pack, each weight ``a · q`` dequantized in x's dtype
    (one rounding), the product accumulated in f32, less ``bf16(Σ_32 x) @
    bᵀ`` with the block sums taken in f32 → [M, F] in ``out_dtype``
    (default x's). On the card ``ops.quant_matmul.dequant_matmul`` launches
    the kernel (``csrc/dequant_matmul.cu``)."""
    if pack.kind != "q5_k":
        raise ValueError(f"q5_k_matmul_plain: pack kind {pack.kind!r} (q5_k only)")
    return dequant_matmul_plain(x, pack, out_dtype)
