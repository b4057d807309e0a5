"""Model config, GGUF loading and the llama-family forward."""

from .config import PRESETS, ModelConfig
from .convert import load_params, params_from_jax, select_rope_factors
from .llama import Block, KVCache, LlamaModel, PagedKVCache, Params

__all__ = ["PRESETS", "Block", "KVCache", "LlamaModel", "ModelConfig",
           "PagedKVCache", "Params",
           "load_params", "params_from_jax", "select_rope_factors"]
