"""Byte-level BPE tokenizer (GPT-2 / Llama-3 family) over a GGUF-embedded vocab.

Standard byte-level BPE: pretokenize with a model-family regex, map raw bytes
through the GPT-2 byte↔unicode table, then merge adjacent pairs in merge-rank
order. Merges come from ``tokenizer.ggml.merges``; the pretokenizer regex is
selected by ``tokenizer.ggml.pre``.
"""

from __future__ import annotations

import functools

import regex as re

from .base import Tokenizer, Vocab

# Public pretokenizer patterns by family.
_PRE_PATTERNS = {
    "gpt2": r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
    "llama3": r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
}
_PRE_ALIASES = {
    "llama-v3": "llama3",
    "llama-bpe": "llama3",
    "default": "gpt2",
    "gpt-2": "gpt2",
    "mistral-bpe": "llama3",
}


@functools.cache
def byte_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte↔printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.cache
def unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in byte_to_unicode().items()}


class BPETokenizer(Tokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        if vocab.merges is None:
            raise ValueError("BPE tokenizer requires tokenizer.ggml.merges")
        self._ranks = {pair: i for i, pair in enumerate(vocab.merges)}
        pre = _PRE_ALIASES.get(vocab.pre, vocab.pre)
        self._pattern = re.compile(_PRE_PATTERNS.get(pre, _PRE_PATTERNS["gpt2"]))
        self._b2u = byte_to_unicode()
        self._u2b = unicode_to_byte()

    def _bpe(self, token: str) -> list[str]:
        parts = list(token)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def _encode_text(self, text: str) -> list[int]:
        ids: list[int] = []
        t2i = self.vocab.token_to_id
        for m in self._pattern.findall(text):
            mapped = "".join(self._b2u[b] for b in m.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = t2i.get(piece)
                if tid is not None:
                    ids.append(tid)
                elif self.vocab.unk_id is not None:
                    ids.append(self.vocab.unk_id)
        return ids

    def token_bytes(self, tid: int) -> bytes:
        tok = self.vocab.tokens[tid]
        if all(c in self._u2b for c in tok):
            return bytes(self._u2b[c] for c in tok)
        return tok.encode("utf-8")  # special tokens are plain text

    def _decode_tokens(self, ids: list[int]) -> str:
        return b"".join(self.token_bytes(t) for t in ids).decode("utf-8", errors="replace")
