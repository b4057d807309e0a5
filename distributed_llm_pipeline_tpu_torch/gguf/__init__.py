from .constants import GGMLType, GGUFValueType, block_geometry, tensor_nbytes
from .quants import dequantize, quantize
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "GGUFReader",
    "GGUFWriter",
    "TensorInfo",
    "block_geometry",
    "dequantize",
    "quantize",
    "tensor_nbytes",
]
