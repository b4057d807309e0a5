"""Tokenizer interfaces + shared vocab plumbing.

Replaces the reference's tokenizer (llama.cpp submodule, exercised via
``-p <prompt>`` — reference ``orchestrator/src/main.rs:41-42`` — with vocab
embedded in GGUF metadata). Two concrete algorithms cover the model families
the reference serves: SPM (Llama-2-style sentencepiece vocab) and byte-level
BPE (GPT-2 / Llama-3-style).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TokenType(enum.IntEnum):
    """llama.cpp-compatible token types from ``tokenizer.ggml.token_type``."""

    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Vocab:
    tokens: list[str]
    scores: list[float] | None = None
    token_types: list[int] | None = None
    merges: list[tuple[str, str]] | None = None
    bos_id: int | None = None
    eos_id: int | None = None
    unk_id: int | None = None
    pad_id: int | None = None
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    pre: str = "default"  # pretokenizer name (tokenizer.ggml.pre)
    # fill-in-middle special tokens (llama-server /infill; GGUF
    # tokenizer.ggml.{prefix,suffix,middle}_token_id or fim_*_token_id)
    fim_pre_id: int | None = None
    fim_suf_id: int | None = None
    fim_mid_id: int | None = None
    # Jinja chat template embedded in GGUF metadata (tokenizer.chat_template)
    chat_template: str | None = None

    token_to_id: dict[str, int] = field(init=False)

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    def type_of(self, token_id: int) -> TokenType:
        if self.token_types is None:
            return TokenType.NORMAL
        return TokenType(self.token_types[token_id])

    @property
    def special_tokens(self) -> dict[str, int]:
        """Tokens that must be matched verbatim before sub-word segmentation.
        Cached: scanning a 128k-vocab costs ~100 ms and encode() needs it on
        EVERY request (measured as the single largest host cost per serving
        request before caching)."""
        cached = getattr(self, "_special_tokens", None)
        if cached is None:
            cached = {}
            for i, t in enumerate(self.tokens):
                if self.type_of(i) in (TokenType.CONTROL, TokenType.USER_DEFINED):
                    cached[t] = i
            object.__setattr__(self, "_special_tokens", cached)
        return cached


def split_on_special(text: str, special: dict[str, int]) -> list[str | int]:
    """Split text into plain-text spans and special-token ids, longest match first."""
    if not special:
        return [text] if text else []
    ordered = sorted(special, key=len, reverse=True)
    out: list[str | int] = []
    pos = 0
    while pos < len(text):
        nxt = None
        nxt_at = len(text)
        for tok in ordered:
            at = text.find(tok, pos)
            if at != -1 and (at < nxt_at or (at == nxt_at and nxt is not None and len(tok) > len(nxt))):
                nxt, nxt_at = tok, at
        if nxt is None:
            out.append(text[pos:])
            break
        if nxt_at > pos:
            out.append(text[pos:nxt_at])
        out.append(special[nxt])
        pos = nxt_at + len(nxt)
    return out


class Tokenizer:
    """Abstract base: concrete classes implement _encode_text / _decode_tokens."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    @property
    def vocab_size(self) -> int:
        return len(self.vocab.tokens)

    @property
    def bos_id(self) -> int | None:
        return self.vocab.bos_id

    @property
    def eos_id(self) -> int | None:
        return self.vocab.eos_id

    def encode(self, text: str, add_bos: bool | None = None, add_eos: bool | None = None) -> list[int]:
        ids: list[int] = []
        add_bos = self.vocab.add_bos if add_bos is None else add_bos
        add_eos = self.vocab.add_eos if add_eos is None else add_eos
        if add_bos and self.vocab.bos_id is not None:
            ids.append(self.vocab.bos_id)
        for span in split_on_special(text, self.vocab.special_tokens):
            if isinstance(span, int):
                ids.append(span)
            else:
                ids.extend(self._encode_text(span))
        if add_eos and self.vocab.eos_id is not None:
            ids.append(self.vocab.eos_id)
        return ids

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        if skip_special:
            keep = (TokenType.NORMAL, TokenType.BYTE, TokenType.USER_DEFINED)
            ids = [i for i in ids if self.vocab.type_of(i) in keep]
        return self._decode_tokens(list(ids))

    def _encode_text(self, text: str) -> list[int]:
        raise NotImplementedError

    def _decode_tokens(self, ids: list[int]) -> str:
        raise NotImplementedError
