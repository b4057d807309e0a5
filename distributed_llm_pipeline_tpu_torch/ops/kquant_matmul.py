"""Q6_K weights kept quantized on the device.

The counterpart of ``distributed_llm_pipeline_tpu/ops/kquant_matmul.py`` for
the Q6_K format (the reference's demo checkpoint is Q6_K,
``orchestrator/src/main.rs:40``). The GGUF super-blocks are re-packed once
at load into the JAX package's layout, transposed to out-features-major like
the port's ``F.linear`` weights; the quantized values are exact:

    Q6_K  w = s · q, q ∈ [-32, 31] per 16-row sub-block along D
        ql  int8 [F, D/2]   4-bit plane: byte j holds row j in its low
                            nibble and row j + D/2 in its high nibble
        qh  int8 [F, D/4]   2-bit plane: bits 2k..2k+1 of byte j hold row
                            j + k·D/4 (the four quarter bands k = 0..3)
        s   bf16 [F, D/16]  effective scale (ggml d · sc, rounded to bf16)

So band k (rows [k·D/4, (k+1)·D/4)) reads its low 4 bits from the low
nibbles of ``ql``'s first half (k = 0), its second half (k = 1), or the high
nibbles of those (k = 2, 3), and its top 2 bits from bits 2k of ``qh``.

The pack goes through the same dispatch and the same two kernels as Q8_0
(``ops/quant_matmul.py``): the W8A8 integer dots (sub-block 16, activation
group 256 where D/4 allows it, else 32) for M ≤ 32 and the fused dequant
above; each kernel decodes the bit planes itself (``csrc/quant_tile.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.quants import _fp16_field, quant_q6_k
from .quant_matmul import GROUP, QuantPack, _bf16

SUB6 = 16   # Q6_K sub-block length along D


class Q6KPack(QuantPack):
    kind = "q6_k"
    fields = ("ql", "qh", "s")
    sub = SUB6

    def _dense_shape(self) -> tuple[int, int]:
        return self.ql.shape[0], 2 * self.ql.shape[1]

    def _act_group(self) -> int:
        # the group must divide the band size D/4, so no group straddles a
        # band (D % 256 == 0, so 32 always divides)
        return GROUP if (self.shape[1] // 4) % GROUP == 0 else 32

    def codes_and_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        ql = self.ql.view(torch.uint8)
        qh = self.qh.view(torch.uint8)
        lo = torch.cat([ql & 0x0F, ql >> 4], dim=1)                 # [F, D]
        hi = torch.cat([(qh >> (2 * k)) & 3 for k in range(4)], dim=1)
        q = (lo | (hi << 4)).to(torch.int16) - 32                    # [-32, 31]
        return q.to(torch.int8), self.s


def pack_q6_k(w: torch.Tensor | np.ndarray) -> Q6KPack:
    """Quantize a dense weight ``w [F, D]`` to Q6_K along D, on the host:
    the GGUF encoder's blocks, then ``pack_q6_k_from_gguf``."""
    wn = torch.as_tensor(w).detach().to("cpu", torch.float32).numpy()
    Fo, D = wn.shape
    raw = np.frombuffer(quant_q6_k(np.ascontiguousarray(wn).reshape(-1)), np.uint8)
    return pack_q6_k_from_gguf(raw, (D, Fo))


def pack_q6_k_from_gguf(raw, shape: tuple[int, int]) -> Q6KPack:
    """A pack straight from raw GGUF Q6_K super-blocks (210 B per 256
    values) laid row-major over the (F, D) disk layout. ``shape`` is (D, F),
    as the reference takes it."""
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
    qb = np.concatenate([q1, q2, q3, q4], axis=2).reshape(Fo, D)   # [0, 63]
    s = (d * scales).reshape(Fo, D // SUB6)
    lo4 = qb & 0x0F
    ql_packed = (lo4[:, : D // 2] | (lo4[:, D // 2:] << 4)).astype(np.uint8)
    hi2 = (qb >> 4).reshape(Fo, 4, D // 4)
    qh_packed = (hi2[:, 0] | (hi2[:, 1] << 2) | (hi2[:, 2] << 4)
                 | (hi2[:, 3] << 6)).astype(np.uint8)
    return Q6KPack(ql=torch.from_numpy(ql_packed.view(np.int8)),
                   qh=torch.from_numpy(qh_packed.view(np.int8)), s=_bf16(s))
