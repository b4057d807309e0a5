"""Build a tokenizer from GGUF metadata (``tokenizer.ggml.*`` keys)."""

from __future__ import annotations

from typing import Any

import numpy as np

from .base import Tokenizer, Vocab
from .bpe import BPETokenizer
from .spm import SPMTokenizer


def _get(md: dict[str, Any], key: str, default=None):
    v = md.get(key, default)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def vocab_from_metadata(md: dict[str, Any]) -> Vocab:
    tokens = _get(md, "tokenizer.ggml.tokens")
    if tokens is None:
        raise ValueError("GGUF metadata has no tokenizer.ggml.tokens")
    merges_raw = _get(md, "tokenizer.ggml.merges")
    merges = None
    if merges_raw is not None:
        merges = [tuple(m.split(" ", 1)) for m in merges_raw]
    model = md.get("tokenizer.ggml.model", "llama")
    return Vocab(
        tokens=list(tokens),
        scores=_get(md, "tokenizer.ggml.scores"),
        token_types=_get(md, "tokenizer.ggml.token_type"),
        merges=merges,
        bos_id=_get(md, "tokenizer.ggml.bos_token_id"),
        eos_id=_get(md, "tokenizer.ggml.eos_token_id"),
        unk_id=_get(md, "tokenizer.ggml.unknown_token_id"),
        pad_id=_get(md, "tokenizer.ggml.padding_token_id"),
        add_bos=bool(md.get("tokenizer.ggml.add_bos_token", model == "llama")),
        add_eos=bool(md.get("tokenizer.ggml.add_eos_token", False)),
        add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", model == "llama")),
        pre=md.get("tokenizer.ggml.pre", "default"),
        fim_pre_id=_fim(md, "prefix", "fim_pre"),
        fim_suf_id=_fim(md, "suffix", "fim_suf"),
        fim_mid_id=_fim(md, "middle", "fim_mid"),
        chat_template=md.get("tokenizer.chat_template"),
    )


def _fim(md: dict, old: str, new: str) -> int | None:
    """FIM token id under either GGUF naming generation (e.g. CodeLlama uses
    tokenizer.ggml.prefix_token_id; newer exports use fim_pre_token_id)."""
    for key in (f"tokenizer.ggml.{old}_token_id",
                f"tokenizer.ggml.{new}_token_id"):
        v = md.get(key)
        if v is not None:
            return int(v)
    return None


def tokenizer_from_metadata(md: dict[str, Any]) -> Tokenizer:
    model = md.get("tokenizer.ggml.model", "llama")
    vocab = vocab_from_metadata(md)
    if model == "llama":
        return SPMTokenizer(vocab)
    if model in ("gpt2", "bpe"):
        return BPETokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {model!r}")
