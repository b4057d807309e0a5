"""GGUF v3 writer.

The reference has no writer (its GGUF files were produced by out-of-tree
llama.cpp converters). We need one so tests can fabricate bit-valid quantized
model files without any third-party dependency, and so tools can re-package
checkpoints as GGUF.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from .quants import quantize

_SCALAR_PACK = {
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
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, vtype))

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: GGMLType = GGMLType.F32) -> None:
        """array is in numpy (row-major) shape; stored with ggml ne[] reversed."""
        array = np.ascontiguousarray(array, dtype=np.float32)
        data = quantize(ggml_type, array.reshape(-1))
        self._tensors.append((name, array.shape, GGMLType(ggml_type), data))

    def add_tensor_bytes(self, name: str, shape: tuple[int, ...],
                         ggml_type: GGMLType, data: bytes) -> None:
        """Tensor bytes already encoded as ``ggml_type`` (numpy shape)."""
        t = GGMLType(ggml_type)
        if len(data) != tensor_nbytes(t, int(np.prod(shape))):
            raise ValueError(f"{name}: {len(data)} bytes for {t.name} {shape}")
        self._tensors.append((name, tuple(shape), t, bytes(data)))

    # -- encoding -----------------------------------------------------------

    def _enc_string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _enc_value(self, v: Any, vtype: GGUFValueType | None) -> tuple[GGUFValueType, bytes]:
        vtype = GGUFValueType(vtype) if vtype is not None else _infer_vtype(v)
        if vtype == GGUFValueType.STRING:
            return vtype, self._enc_string(str(v))
        if vtype == GGUFValueType.BOOL:
            return vtype, struct.pack("<B", 1 if v else 0)
        if vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                etype = {
                    np.dtype(np.float32): GGUFValueType.FLOAT32,
                    np.dtype(np.float64): GGUFValueType.FLOAT64,
                    np.dtype(np.int8): GGUFValueType.INT8,
                    np.dtype(np.int16): GGUFValueType.INT16,
                    np.dtype(np.int32): GGUFValueType.INT32,
                    np.dtype(np.uint16): GGUFValueType.UINT16,
                    np.dtype(np.uint32): GGUFValueType.UINT32,
                    np.dtype(np.int64): GGUFValueType.INT64,
                    np.dtype(np.uint64): GGUFValueType.UINT64,
                    np.dtype(np.uint8): GGUFValueType.UINT8,
                }.get(v.dtype)
                if etype is None:
                    v = v.tolist()
                else:
                    body = np.ascontiguousarray(v.astype(v.dtype.newbyteorder("<"))).tobytes()
                    return vtype, struct.pack("<IQ", int(etype), v.size) + body
            if len(v) == 0:
                return vtype, struct.pack("<IQ", int(GGUFValueType.UINT32), 0)
            etypes = {_infer_vtype(item) for item in v}
            if etypes <= {GGUFValueType.UINT32, GGUFValueType.UINT64, GGUFValueType.INT64}:
                if GGUFValueType.INT64 in etypes:
                    if any(item > 2**63 - 1 for item in v):
                        raise ValueError("int array mixes negatives with values beyond int64 range")
                    etype = GGUFValueType.INT64
                else:
                    etype = max(etypes)
            elif len(etypes) == 1:
                etype = etypes.pop()
            else:
                raise TypeError(f"mixed element types in GGUF array: {sorted(t.name for t in etypes)}")
            out = [struct.pack("<IQ", int(etype), len(v))]
            for item in v:
                _, enc = self._enc_value(item, etype)
                out.append(enc)
            return vtype, b"".join(out)
        return vtype, struct.pack(_SCALAR_PACK[vtype], v)

    def write(self) -> Path:
        kvs = list(self._kv)
        declared = [v for k, v, _ in kvs if k == "general.alignment"]
        if declared:
            # the metadata value is what readers will use — honor it
            self.alignment = int(declared[-1])
        elif self.alignment != GGUF_DEFAULT_ALIGNMENT:
            kvs.append(("general.alignment", self.alignment, GGUFValueType.UINT32))
        header = [struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(kvs))]
        for key, value, vtype in kvs:
            vt, enc = self._enc_value(value, vtype)
            header.append(self._enc_string(key) + struct.pack("<I", int(vt)) + enc)
        # tensor infos with data offsets aligned within the data section
        offset = 0
        infos = []
        blobs = []
        for name, shape, ggml_type, data in self._tensors:
            offset = -(-offset // self.alignment) * self.alignment
            ne = list(reversed(shape))
            infos.append(
                self._enc_string(name)
                + struct.pack("<I", len(ne))
                + struct.pack(f"<{len(ne)}Q", *ne)
                + struct.pack("<IQ", int(ggml_type), offset)
            )
            blobs.append((offset, data))
            offset += len(data)
        header.extend(infos)
        head = b"".join(header)
        pad = (-len(head)) % self.alignment
        with open(self.path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * pad)
            base = f.tell()
            for off, data in blobs:
                f.seek(base + off)
                f.write(data)
        return self.path
