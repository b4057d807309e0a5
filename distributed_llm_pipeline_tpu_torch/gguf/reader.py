"""GGUF file reader: header, metadata KVs, tensor table, mmap'd blob access.

Replaces the reference's GGUF loader (llama.cpp submodule; exercised via
``-m <model>.gguf`` at reference ``orchestrator/src/main.rs:39-40``, with
mmap per the reference design report's "disk offload (mmap)"). Supports GGUF
v2 and v3, little-endian.

The reader never materializes tensor data until asked: ``tensor_data`` returns
a zero-copy mmap slice, ``tensor_f32`` dequantizes to float32 on demand.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from .quants import dequantize

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
    GGUFValueType.BOOL: "<B",
}


@dataclass(frozen=True)
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy/C order (row-major); reversed from on-disk ggml ne[]
    ggml_type: GGMLType
    offset: int  # relative to data section start
    nbytes: int

    @property
    def nelems(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return bytes(b)

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise EOFError("truncated GGUF file")
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v


class GGUFReader:
    """Parses a GGUF file and exposes metadata + lazily-decoded tensors."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: dict[str, Any] = {}
        self.metadata_types: dict[str, int] = {}
        self.tensors: dict[str, TensorInfo] = {}
        try:
            self._parse()
        except BaseException:
            self.close()
            raise

    # -- parsing ------------------------------------------------------------

    def _read_string(self, cur: _Cursor) -> str:
        n = cur.scalar("<Q") if self.version >= 2 else cur.scalar("<I")
        return cur.take(n).decode("utf-8", errors="replace")

    def _read_value(self, cur: _Cursor, vtype: GGUFValueType):
        vtype = GGUFValueType(vtype)
        if vtype == GGUFValueType.STRING:
            return self._read_string(cur)
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(cur.scalar("<I"))
            count = cur.scalar("<Q") if self.version >= 2 else cur.scalar("<I")
            if etype in _SCALAR_FMT and etype != GGUFValueType.BOOL:
                fmt = _SCALAR_FMT[etype]
                size = struct.calcsize(fmt)
                raw = cur.take(size * count)
                return np.frombuffer(raw, dtype=np.dtype(fmt)).copy()
            return [self._read_value(cur, etype) for _ in range(count)]
        if vtype == GGUFValueType.BOOL:
            return bool(cur.scalar("<B"))
        return cur.scalar(_SCALAR_FMT[vtype])

    def _parse(self) -> None:
        cur = _Cursor(self._mm)
        magic = cur.scalar("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.scalar("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = cur.scalar("<Q")
        n_kv = cur.scalar("<Q")
        for _ in range(n_kv):
            key = self._read_string(cur)
            vtype = cur.scalar("<I")
            self.metadata[key] = self._read_value(cur, vtype)
            # original declared type, so re-encoders (tools/quantize.py) can
            # write metadata back without the writer re-inferring (and e.g.
            # downcasting FLOAT64 to FLOAT32)
            self.metadata_types[key] = vtype
        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        for _ in range(n_tensors):
            name = self._read_string(cur)
            n_dims = cur.scalar("<I")
            ne = [cur.scalar("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(cur.scalar("<I"))
            offset = cur.scalar("<Q")
            shape = tuple(reversed(ne))  # ggml ne[0] is the contiguous dim
            nelems = 1
            for s in ne:
                nelems *= s
            self.tensors[name] = TensorInfo(
                name=name,
                shape=shape,
                ggml_type=ggml_type,
                offset=offset,
                nbytes=tensor_nbytes(ggml_type, nelems),
            )
        pad = (-cur.pos) % self.alignment
        self.data_offset = cur.pos + pad

    # -- access -------------------------------------------------------------

    def tensor_data(self, name: str) -> memoryview:
        """Zero-copy view of a tensor's raw (possibly quantized) bytes."""
        ti = self.tensors[name]
        start = self.data_offset + ti.offset
        return memoryview(self._mm)[start : start + ti.nbytes]

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantize a tensor to float32 in its numpy (row-major) shape."""
        ti = self.tensors[name]
        flat = dequantize(ti.ggml_type, np.frombuffer(self.tensor_data(name), dtype=np.uint8), ti.nelems)
        return flat.reshape(ti.shape)

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
