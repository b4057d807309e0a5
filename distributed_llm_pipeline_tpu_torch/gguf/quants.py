"""Quantized block codecs for GGUF tensor data (numpy, vectorized).

Replaces the reference's ``ggml-quants`` subsystem (llama.cpp submodule;
exercised because the committed demo model is Q6_K — reference
``orchestrator/src/main.rs:40`` — and BASELINE configs name Q4_0/Q4_K_M/Q4/Q8).

Dequantization targets the load path of this framework: quantized GGUF blobs
are decoded once, on the host, into arrays that live in device memory for the
lifetime of the server (the reference instead re-reads the GGUF per request —
``main.rs:35-57`` spawns a fresh engine process per chat message).

Encoders (`quantize`) exist so tests and tools can fabricate valid GGUF files
without any third-party dependency; they use simple per-block scale selection,
not llama.cpp's search-based quantizers, so they are *valid* encodings rather
than *optimal* ones. Round-trip error bounds are asserted in
``tests/test_quants.py``.

All layouts below are implemented from the public GGUF/ggml format
specification. A second, deliberately scalar implementation lives in
``tests/scalar_quants.py`` as an independent cross-check.
"""

from __future__ import annotations

import numpy as np

from .constants import GGMLType, QK, QK_K, block_geometry

# ---------------------------------------------------------------------------
# helpers


def _blocks(data: bytes | np.ndarray, nbytes: int) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data.view(np.uint8).reshape(-1)
    if arr.size % nbytes != 0:
        raise ValueError(f"data size {arr.size} not a multiple of block size {nbytes}")
    return arr.reshape(-1, nbytes)


def _fp16_field(blk: np.ndarray, off: int) -> np.ndarray:
    """Read a little-endian fp16 scalar field at byte offset `off` per block → (nblocks, 1) f32."""
    return blk[:, off : off + 2].copy().view("<f2").astype(np.float32)


def _store_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    """1/d with 0 → 0 (an all-zero block encodes as d=0, q=0)."""
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)


# ---------------------------------------------------------------------------
# simple 32-element blocks


def dequant_q4_0(data) -> np.ndarray:
    blk = _blocks(data, 18)
    d = _fp16_field(blk, 0)
    qs = blk[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 8.0
    return (q * d).reshape(-1)


def quant_q4_0(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK)
    amax_idx = np.argmax(np.abs(xb), axis=1)
    vmax = xb[np.arange(xb.shape[0]), amax_idx]
    d = vmax / -8.0
    inv = _safe_inv(d)
    q = np.clip(np.round(xb * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.zeros((xb.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def dequant_q4_1(data) -> np.ndarray:
    blk = _blocks(data, 20)
    d = _fp16_field(blk, 0)
    m = _fp16_field(blk, 2)
    qs = blk[:, 4:20]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def quant_q4_1(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK)
    mn, mx = xb.min(axis=1), xb.max(axis=1)
    d = (mx - mn) / 15.0
    inv = _safe_inv(d)
    q = np.clip(np.round((xb - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    out = np.zeros((xb.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:4] = _store_f16(mn[:, None]).reshape(-1, 2)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _q5_bits(blk: np.ndarray, qh_off: int, qs_off: int) -> np.ndarray:
    qh = blk[:, qh_off : qh_off + 4].copy().view("<u4").astype(np.uint32)  # (nb, 1)
    qs = blk[:, qs_off : qs_off + 16]
    nib = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.uint32)  # (nb, 32)
    hbit = (qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return (nib | (hbit << 4)).astype(np.float32)


def dequant_q5_0(data) -> np.ndarray:
    blk = _blocks(data, 22)
    d = _fp16_field(blk, 0)
    q = _q5_bits(blk, 2, 6)
    return ((q - 16.0) * d).reshape(-1)


def quant_q5_0(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK)
    amax_idx = np.argmax(np.abs(xb), axis=1)
    vmax = xb[np.arange(xb.shape[0]), amax_idx]
    d = vmax / -16.0
    inv = _safe_inv(d)
    q = np.clip(np.round(xb * inv[:, None]) + 16, 0, 31).astype(np.uint32)
    out = np.zeros((xb.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    qh = ((q >> 4) & 1) << np.arange(32, dtype=np.uint32)[None, :]
    out[:, 2:6] = qh.sum(axis=1, dtype=np.uint32)[:, None].view(np.uint8)[:, :4]
    nib = (q & 0x0F).astype(np.uint8)
    out[:, 6:22] = nib[:, :16] | (nib[:, 16:] << 4)
    return out.tobytes()


def dequant_q5_1(data) -> np.ndarray:
    blk = _blocks(data, 24)
    d = _fp16_field(blk, 0)
    m = _fp16_field(blk, 2)
    q = _q5_bits(blk, 4, 8)
    return (q * d + m).reshape(-1)


def quant_q5_1(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK)
    mn, mx = xb.min(axis=1), xb.max(axis=1)
    d = (mx - mn) / 31.0
    inv = _safe_inv(d)
    q = np.clip(np.round((xb - mn[:, None]) * inv[:, None]), 0, 31).astype(np.uint32)
    out = np.zeros((xb.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:4] = _store_f16(mn[:, None]).reshape(-1, 2)
    qh = ((q >> 4) & 1) << np.arange(32, dtype=np.uint32)[None, :]
    out[:, 4:8] = qh.sum(axis=1, dtype=np.uint32)[:, None].view(np.uint8)[:, :4]
    nib = (q & 0x0F).astype(np.uint8)
    out[:, 8:24] = nib[:, :16] | (nib[:, 16:] << 4)
    return out.tobytes()


def dequant_q8_0(data) -> np.ndarray:
    blk = _blocks(data, 34)
    d = _fp16_field(blk, 0)
    q = blk[:, 2:34].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def quant_q8_0(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK)
    d = np.abs(xb).max(axis=1) / 127.0
    inv = _safe_inv(d)
    q = np.clip(np.round(xb * inv[:, None]), -127, 127).astype(np.int8)
    out = np.zeros((xb.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# K-quants: 256-element super-blocks


def _k4_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte packed 6-bit (scale, min) pairs of Q4_K / Q5_K.

    scales: (nb, 12) uint8 → sc, mn each (nb, 8) float32.
    Sub-blocks j<4: sc = b[j] & 63, mn = b[j+4] & 63.
    Sub-blocks j>=4: sc = (b[j+4] & 0xF) | ((b[j-4] >> 6) << 4),
                     mn = (b[j+4] >> 4)  | ((b[j]   >> 6) << 4).
    """
    b = scales.astype(np.uint8)
    sc = np.empty(b.shape[:-1] + (8,), dtype=np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = (b[..., j] & 63).astype(np.float32)
        mn[..., j] = (b[..., j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[..., j] = ((b[..., j + 4] & 0x0F) | ((b[..., j - 4] >> 6) << 4)).astype(np.float32)
        mn[..., j] = ((b[..., j + 4] >> 4) | ((b[..., j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _k4_pack_scale_min(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _k4_scale_min. sc, mn: (nb, 8) ints in [0,63] → (nb, 12) uint8."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    for j in range(4):
        out[..., j] = (sc[..., j] & 63) | ((sc[..., j + 4] >> 4) << 6)
        out[..., j + 4] = (mn[..., j] & 63) | ((mn[..., j + 4] >> 4) << 6)
        out[..., j + 8] = (sc[..., j + 4] & 0x0F) | ((mn[..., j + 4] & 0x0F) << 4)
    return out


def dequant_q4_k(data) -> np.ndarray:
    blk = _blocks(data, 144)
    d = _fp16_field(blk, 0)       # (nb, 1)
    dmin = _fp16_field(blk, 2)
    sc, mn = _k4_scale_min(blk[:, 4:16])          # (nb, 8)
    qs = blk[:, 16:144].reshape(-1, 4, 32)        # 4 chunks of 64 elems
    q = np.stack([qs & 0x0F, qs >> 4], axis=2).astype(np.float32)  # (nb, 4, 2, 32)
    scs = sc.reshape(-1, 4, 2, 1)
    mns = mn.reshape(-1, 4, 2, 1)
    vals = d[:, :, None, None] * scs * q - dmin[:, :, None, None] * mns
    return vals.reshape(-1)


def quant_q4_k(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, 8, 32)  # (nb, sub, 32)
    mx = xb.max(axis=2)
    mn_v = np.minimum(xb.min(axis=2), 0.0)
    scale = (mx - mn_v) / 15.0
    minv = -mn_v
    d = scale.max(axis=1) / 63.0
    dmin = minv.max(axis=1) / 63.0
    d_safe = np.where(d == 0, 1, d)
    dmin_safe = np.where(dmin == 0, 1, dmin)
    sc = np.clip(np.round(scale / d_safe[:, None]), 0, 63)
    mnq = np.clip(np.round(minv / dmin_safe[:, None]), 0, 63)
    eff_scale = d[:, None] * sc
    eff_min = dmin[:, None] * mnq
    es_safe = np.where(eff_scale == 0, 1, eff_scale)
    q = np.clip(np.round((xb + eff_min[:, :, None]) / es_safe[:, :, None]), 0, 15).astype(np.uint8)
    q = np.where(eff_scale[:, :, None] == 0, 0, q)
    nb = xb.shape[0]
    out = np.zeros((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:4] = _store_f16(dmin[:, None]).reshape(-1, 2)
    out[:, 4:16] = _k4_pack_scale_min(sc, mnq)
    qc = q.reshape(nb, 4, 2, 32)
    out[:, 16:144] = (qc[:, :, 0] | (qc[:, :, 1] << 4)).reshape(nb, 128)
    return out.tobytes()


def dequant_q5_k(data) -> np.ndarray:
    blk = _blocks(data, 176)
    d = _fp16_field(blk, 0)
    dmin = _fp16_field(blk, 2)
    sc, mn = _k4_scale_min(blk[:, 4:16])
    qh = blk[:, 16:48]                             # (nb, 32)
    qs = blk[:, 48:176].reshape(-1, 4, 32)
    nib = np.stack([qs & 0x0F, qs >> 4], axis=2).astype(np.uint8)   # (nb, 4, 2, 32)
    j = np.arange(4)
    bit0 = (qh[:, None, :] >> (2 * j)[:, None]) & 1                  # (nb, 4, 32)
    bit1 = (qh[:, None, :] >> (2 * j + 1)[:, None]) & 1
    hbits = np.stack([bit0, bit1], axis=2).astype(np.uint8)          # (nb, 4, 2, 32)
    q = (nib | (hbits << 4)).astype(np.float32)
    scs = sc.reshape(-1, 4, 2, 1)
    mns = mn.reshape(-1, 4, 2, 1)
    vals = d[:, :, None, None] * scs * q - dmin[:, :, None, None] * mns
    return vals.reshape(-1)


def quant_q5_k(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, 8, 32)
    mx = xb.max(axis=2)
    mn_v = np.minimum(xb.min(axis=2), 0.0)
    scale = (mx - mn_v) / 31.0
    minv = -mn_v
    d = scale.max(axis=1) / 63.0
    dmin = minv.max(axis=1) / 63.0
    d_safe = np.where(d == 0, 1, d)
    dmin_safe = np.where(dmin == 0, 1, dmin)
    sc = np.clip(np.round(scale / d_safe[:, None]), 0, 63)
    mnq = np.clip(np.round(minv / dmin_safe[:, None]), 0, 63)
    eff_scale = d[:, None] * sc
    eff_min = dmin[:, None] * mnq
    es_safe = np.where(eff_scale == 0, 1, eff_scale)
    q = np.clip(np.round((xb + eff_min[:, :, None]) / es_safe[:, :, None]), 0, 31).astype(np.uint8)
    q = np.where(eff_scale[:, :, None] == 0, 0, q)
    nb = xb.shape[0]
    out = np.zeros((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 2:4] = _store_f16(dmin[:, None]).reshape(-1, 2)
    out[:, 4:16] = _k4_pack_scale_min(sc, mnq)
    qc = q.reshape(nb, 4, 2, 32)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for j in range(4):
        qh |= ((qc[:, j, 0] >> 4) & 1) << (2 * j)
        qh |= ((qc[:, j, 1] >> 4) & 1) << (2 * j + 1)
    out[:, 16:48] = qh
    out[:, 48:176] = ((qc[:, :, 0] & 0x0F) | ((qc[:, :, 1] & 0x0F) << 4)).reshape(nb, 128)
    return out.tobytes()


def dequant_q6_k(data) -> np.ndarray:
    blk = _blocks(data, 210)
    ql = blk[:, 0:128].reshape(-1, 2, 64)          # two 128-elem halves
    qh = blk[:, 128:192].reshape(-1, 2, 32)
    scales = blk[:, 192:208].view(np.int8).astype(np.float32)  # (nb, 16)
    d = _fp16_field(blk, 208)                      # (nb, 1)
    l_lo, l_hi = ql[:, :, :32], ql[:, :, 32:]
    q1 = (l_lo & 0x0F) | (((qh >> 0) & 3) << 4)    # elems   0..31 of half
    q2 = (l_hi & 0x0F) | (((qh >> 2) & 3) << 4)    # elems  32..63
    q3 = (l_lo >> 4) | (((qh >> 4) & 3) << 4)      # elems  64..95
    q4 = (l_hi >> 4) | (((qh >> 6) & 3) << 4)      # elems  96..127
    q = np.concatenate([q1, q2, q3, q4], axis=2).astype(np.float32) - 32.0  # (nb, 2, 128)
    sc = scales.reshape(-1, 16, 1)                 # per 16 elems
    vals = d[:, :, None] * sc * q.reshape(-1, 16, 16)
    return vals.reshape(-1)


def quant_q6_k(x: np.ndarray) -> bytes:
    xg = np.asarray(x, dtype=np.float32).reshape(-1, 16, 16)  # (nb, group, 16)
    s = np.abs(xg).max(axis=2) / 31.0                          # per-group scale
    d = np.abs(s).max(axis=1) / 127.0
    d_safe = np.where(d == 0, 1, d)
    scq = np.clip(np.round(s / d_safe[:, None]), -128, 127)
    eff = d[:, None] * scq
    eff_safe = np.where(eff == 0, 1, eff)
    q = np.clip(np.round(xg / eff_safe[:, :, None]) + 32, 0, 63).astype(np.uint8)
    q = np.where(eff[:, :, None] == 0, 32, q)
    nb = xg.shape[0]
    qh2 = q.reshape(nb, 2, 4, 32)                  # (nb, half, quarter, 32)
    out = np.zeros((nb, 210), dtype=np.uint8)
    lo = np.concatenate([
        (qh2[:, :, 0] & 0x0F) | ((qh2[:, :, 2] & 0x0F) << 4),
        (qh2[:, :, 1] & 0x0F) | ((qh2[:, :, 3] & 0x0F) << 4),
    ], axis=2)                                     # (nb, 2, 64)
    out[:, 0:128] = lo.reshape(nb, 128)
    hi = ((qh2[:, :, 0] >> 4) | ((qh2[:, :, 1] >> 4) << 2)
          | ((qh2[:, :, 2] >> 4) << 4) | ((qh2[:, :, 3] >> 4) << 6))
    out[:, 128:192] = hi.reshape(nb, 64)
    out[:, 192:208] = scq.astype(np.int8).view(np.uint8)
    out[:, 208:210] = _store_f16(d[:, None]).reshape(-1, 2)
    return out.tobytes()


def dequant_q2_k(data) -> np.ndarray:
    blk = _blocks(data, 84)
    scales = blk[:, 0:16]                          # low4 scale, high4 min, per 16 elems
    qs = blk[:, 16:80].reshape(-1, 2, 32)          # two 128-elem halves
    d = _fp16_field(blk, 80)
    dmin = _fp16_field(blk, 82)
    shifts = np.arange(4)[None, None, :, None]
    q = ((qs[:, :, None, :] >> (2 * shifts)) & 3).astype(np.float32)  # (nb, 2, 4, 32)
    q = q.reshape(-1, 16, 16)                      # 16 groups of 16, in elem order
    sc = (scales & 0x0F).astype(np.float32)[:, :, None]
    mn = (scales >> 4).astype(np.float32)[:, :, None]
    vals = d[:, :, None] * sc * q - dmin[:, :, None] * mn
    return vals.reshape(-1)


def quant_q2_k(x: np.ndarray) -> bytes:
    xg = np.asarray(x, dtype=np.float32).reshape(-1, 16, 16)
    mx = xg.max(axis=2)
    mn_v = np.minimum(xg.min(axis=2), 0.0)
    scale = (mx - mn_v) / 3.0
    minv = -mn_v
    d = scale.max(axis=1) / 15.0
    dmin = minv.max(axis=1) / 15.0
    d_safe = np.where(d == 0, 1, d)
    dmin_safe = np.where(dmin == 0, 1, dmin)
    sc = np.clip(np.round(scale / d_safe[:, None]), 0, 15).astype(np.uint8)
    mnq = np.clip(np.round(minv / dmin_safe[:, None]), 0, 15).astype(np.uint8)
    eff = d[:, None] * sc
    effm = dmin[:, None] * mnq
    eff_safe = np.where(eff == 0, 1, eff)
    q = np.clip(np.round((xg + effm[:, :, None]) / eff_safe[:, :, None]), 0, 3).astype(np.uint8)
    q = np.where(eff[:, :, None] == 0, 0, q)
    nb = xg.shape[0]
    out = np.zeros((nb, 84), dtype=np.uint8)
    out[:, 0:16] = sc | (mnq << 4)
    qq = q.reshape(nb, 2, 4, 32)                   # (nb, half, shift-group, 32)
    packed = (qq[:, :, 0] | (qq[:, :, 1] << 2) | (qq[:, :, 2] << 4) | (qq[:, :, 3] << 6))
    out[:, 16:80] = packed.reshape(nb, 64)
    out[:, 80:82] = _store_f16(d[:, None]).reshape(-1, 2)
    out[:, 82:84] = _store_f16(dmin[:, None]).reshape(-1, 2)
    return out.tobytes()


def _q3k_unpack_scales(scales: np.ndarray) -> np.ndarray:
    """Unpack Q3_K's 12-byte field into 16 signed 6-bit scales (already -32 biased)."""
    aux = scales.reshape(-1, 12).copy().view("<u4")       # (nb, 3)
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = aux[:, 2].copy()
    out = np.empty((aux.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (aux[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (aux[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((aux[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((aux[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    sc = out.view(np.uint8).reshape(-1, 16).astype(np.int32) - 32
    return sc.astype(np.float32)


def _q3k_pack_scales(sc: np.ndarray) -> np.ndarray:
    """Inverse of _q3k_unpack_scales. sc: (nb, 16) ints in [-32, 31] → (nb, 12) uint8."""
    u = (sc.astype(np.int32) + 32).astype(np.uint32).reshape(-1, 16)
    words = u.view(np.uint32).reshape(-1, 16)
    lo = words & 0x0F
    hi = words >> 4
    aux = np.zeros((u.shape[0], 3), dtype=np.uint32)
    for j in range(4):
        aux[:, 0] |= lo[:, j] << (8 * j)
        aux[:, 1] |= lo[:, 4 + j] << (8 * j)
        aux[:, 0] |= (lo[:, 8 + j] << 4) << (8 * j)
        aux[:, 1] |= (lo[:, 12 + j] << 4) << (8 * j)
        aux[:, 2] |= hi[:, j] << (8 * j + 0)
        aux[:, 2] |= hi[:, 4 + j] << (8 * j + 2)
        aux[:, 2] |= hi[:, 8 + j] << (8 * j + 4)
        aux[:, 2] |= hi[:, 12 + j] << (8 * j + 6)
    return aux.view(np.uint8).reshape(-1, 12)


def dequant_q3_k(data) -> np.ndarray:
    blk = _blocks(data, 110)
    hmask = blk[:, 0:32]                            # (nb, 32): bit g = high bit of elem in group g
    qs = blk[:, 32:96].reshape(-1, 2, 32)
    sc = _q3k_unpack_scales(blk[:, 96:108])         # (nb, 16)
    d = _fp16_field(blk, 108)
    shifts = np.arange(4)[None, None, :, None]
    lo = ((qs[:, :, None, :] >> (2 * shifts)) & 3).astype(np.int32)   # (nb, 2, 4, 32)
    g = np.arange(8)[None, :, None]
    hbit = ((hmask[:, None, :] >> g) & 1).reshape(-1, 2, 4, 32)       # group = half*4+shift
    q = (lo - np.where(hbit == 0, 4, 0)).astype(np.float32)
    q = q.reshape(-1, 16, 16)
    vals = d[:, :, None] * sc[:, :, None] * q
    return vals.reshape(-1)


def quant_q3_k(x: np.ndarray) -> bytes:
    xg = np.asarray(x, dtype=np.float32).reshape(-1, 16, 16)
    s = np.abs(xg).max(axis=2) / 4.0
    d = np.abs(s).max(axis=1) / 31.0
    d_safe = np.where(d == 0, 1, d)
    scq = np.clip(np.round(s / d_safe[:, None]), -32, 31)
    eff = d[:, None] * scq
    eff_safe = np.where(eff == 0, 1, eff)
    q = np.clip(np.round(xg / eff_safe[:, :, None]), -4, 3).astype(np.int32)
    q = np.where(eff[:, :, None] == 0, 0, q)
    nb = xg.shape[0]
    qu = (q + 4).astype(np.uint8)                   # 0..7: bit2 = hmask bit, low2 = qs
    qq = qu.reshape(nb, 2, 4, 32)
    out = np.zeros((nb, 110), dtype=np.uint8)
    hm = np.zeros((nb, 32), dtype=np.uint8)
    for half in range(2):
        for sh in range(4):
            hm |= ((qq[:, half, sh] >> 2) & 1) << (half * 4 + sh)
    out[:, 0:32] = hm
    packed = ((qq[:, :, 0] & 3) | ((qq[:, :, 1] & 3) << 2)
              | ((qq[:, :, 2] & 3) << 4) | ((qq[:, :, 3] & 3) << 6))
    out[:, 32:96] = packed.reshape(nb, 64)
    out[:, 96:108] = _q3k_pack_scales(scq)
    out[:, 108:110] = _store_f16(d[:, None]).reshape(-1, 2)
    return out.tobytes()


def dequant_q8_k(data) -> np.ndarray:
    blk = _blocks(data, 292)
    # multiply in f64 (exact: 24-bit x 8-bit mantissas), then overflow to ±inf
    # by hand at the f32 round-to-nearest boundary — |d|·127 can exceed f32 max
    # for adversarial bit patterns, and both the f32 multiply and the f64→f32
    # cast trip numpy's overflow warning while the native f32 path overflows
    # silently; this reproduces its ±inf bit-exactly without the warning
    d = blk[:, 0:4].copy().view("<f4").astype(np.float64)
    q = blk[:, 4:260].view(np.int8).astype(np.float64)
    prod = (q * d).reshape(-1)
    out = np.zeros(prod.shape, dtype=np.float32)
    # values with |x| >= 2^128 - 2^103 round to inf (f32 max is 2^128 - 2^104;
    # the tie at the halfway point goes to the even candidate, 2^128 → inf)
    big = np.abs(prod) >= 2.0**128 - 2.0**103
    out[~big] = prod[~big]
    out[big] = np.where(prod[big] > 0, np.inf, -np.inf)
    return out


def quant_q8_k(x: np.ndarray) -> bytes:
    xb = np.asarray(x, dtype=np.float32).reshape(-1, QK_K)
    d = np.abs(xb).max(axis=1) / 127.0
    inv = _safe_inv(d)
    q = np.clip(np.round(xb * inv[:, None]), -127, 127).astype(np.int8)
    nb = xb.shape[0]
    out = np.zeros((nb, 292), dtype=np.uint8)
    out[:, 0:4] = np.ascontiguousarray(d.astype("<f4")).view(np.uint8).reshape(nb, 4)
    out[:, 4:260] = q.view(np.uint8)
    bsums = q.reshape(nb, 16, 16).sum(axis=2).astype("<i2")
    out[:, 260:292] = np.ascontiguousarray(bsums).view(np.uint8).reshape(nb, 32)
    return out.tobytes()


# ---------------------------------------------------------------------------
# plain types


def dequant_f32(data) -> np.ndarray:
    return np.frombuffer(data, dtype="<f4").astype(np.float32)


def dequant_f16(data) -> np.ndarray:
    return np.frombuffer(data, dtype="<f2").astype(np.float32)


def dequant_bf16(data) -> np.ndarray:
    u = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
    return u.view(np.float32).copy()


def quant_bf16(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    # round-to-nearest-even on the dropped 16 bits; NaN bypasses rounding so the
    # payload can't carry past the sign bit and encode as ±0
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)
    rounded = np.where(np.isnan(x), (u >> 16).astype(np.uint32), rounded)
    return rounded.astype("<u2").tobytes()


# ---------------------------------------------------------------------------
# dispatch

DEQUANT: dict[GGMLType, callable] = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.Q8_K: dequant_q8_k,
}

QUANT: dict[GGMLType, callable] = {
    GGMLType.F32: lambda x: np.asarray(x, dtype="<f4").tobytes(),
    GGMLType.F16: lambda x: np.asarray(x, dtype="<f2").tobytes(),
    GGMLType.BF16: quant_bf16,
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q2_K: quant_q2_k,
    GGMLType.Q3_K: quant_q3_k,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
    GGMLType.Q8_K: quant_q8_k,
}


def dequantize(ggml_type: GGMLType, data, nelems: int | None = None) -> np.ndarray:
    """Decode raw GGUF tensor bytes to float32 (flat).

    The numpy codecs above are the semantics; this package carries no
    native decoder."""
    t = GGMLType(ggml_type)
    if t not in DEQUANT:
        raise NotImplementedError(f"no dequantizer for {t!r}")
    out = DEQUANT[t](data)
    if nelems is not None and out.size != nelems:
        raise ValueError(f"{t.name}: decoded {out.size} elements, expected {nelems}")
    return out


def quantize(ggml_type: GGMLType, x: np.ndarray) -> bytes:
    """Encode float32 data as raw GGUF tensor bytes."""
    t = GGMLType(ggml_type)
    if t not in QUANT:
        raise NotImplementedError(f"no quantizer for {t!r}")
    nel, _ = block_geometry(t)
    x = np.asarray(x)
    if x.size % nel != 0:
        raise ValueError(f"size {x.size} not a multiple of block length {nel} for {t.name}")
    return QUANT[t](x)
