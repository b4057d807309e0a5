"""GGUF / GGML on-disk format constants.

The reference delegates all model I/O to llama.cpp's GGUF loader (submodule,
exercised via ``-m *.gguf`` — reference ``orchestrator/src/main.rs:39-40``).
This module defines the wire-format constants for our own independent
implementation, written from the public GGUF specification: magic, value
types, ggml tensor types and their block geometries.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2 / Q4_3, removed upstream; never valid in files we accept.
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


QK = 32  # simple-quant block length
QK_K = 256  # K-quant super-block length

# type -> (block_nelems, block_nbytes)
BLOCK_GEOMETRY: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (QK, 2 + 16),
    GGMLType.Q4_1: (QK, 2 + 2 + 16),
    GGMLType.Q5_0: (QK, 2 + 4 + 16),
    GGMLType.Q5_1: (QK, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (QK, 2 + 32),
    GGMLType.Q8_1: (QK, 2 + 2 + 32),
    GGMLType.Q2_K: (QK_K, 16 + 64 + 2 + 2),          # 84
    GGMLType.Q3_K: (QK_K, 32 + 64 + 12 + 2),         # 110
    GGMLType.Q4_K: (QK_K, 2 + 2 + 12 + 128),         # 144
    GGMLType.Q5_K: (QK_K, 2 + 2 + 12 + 32 + 128),    # 176
    GGMLType.Q6_K: (QK_K, 128 + 64 + 16 + 2),        # 210
    GGMLType.Q8_K: (QK_K, 4 + 256 + 2 * 16),         # 292
}


def block_geometry(ggml_type: GGMLType) -> tuple[int, int]:
    try:
        return BLOCK_GEOMETRY[GGMLType(ggml_type)]
    except KeyError:
        raise NotImplementedError(f"unsupported ggml type {ggml_type!r}") from None


def tensor_nbytes(ggml_type: GGMLType, nelems: int) -> int:
    nel, nby = block_geometry(ggml_type)
    if nelems % nel != 0:
        raise ValueError(f"{nelems} elements not divisible by block size {nel} for {ggml_type!r}")
    return nelems // nel * nby
