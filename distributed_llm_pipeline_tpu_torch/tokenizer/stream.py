"""Incremental detokenization for streaming generation.

The reference streams whatever llama-cli prints to stdout, chunked at pipe
granularity (reference ``orchestrator/src/main.rs:83-95``, 64-byte reads).
We stream at token granularity but must still buffer partial UTF-8 sequences:
a byte-fallback token can be the first byte of a multi-byte character.
"""

from __future__ import annotations


class StreamDecoder:
    """Feeds token ids one at a time; emits only complete UTF-8 text."""

    def __init__(self, tokenizer, strip_leading_space: bool | None = None):
        self.tokenizer = tokenizer
        self._buf = b""
        self._first = True
        if strip_leading_space is None:
            strip_leading_space = getattr(tokenizer.vocab, "add_space_prefix", False)
        self._strip = strip_leading_space

    def feed(self, token_id: int) -> str:
        self._buf += self.tokenizer.token_bytes(token_id)
        # emit the longest decodable prefix
        for cut in range(len(self._buf), max(len(self._buf) - 4, -1), -1):
            try:
                text = self._buf[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self._buf = self._buf[cut:]
            if self._first and self._strip and text.startswith(" "):
                text = text[1:]
            if text:
                self._first = False
            return text
        return ""

    def flush(self) -> str:
        text = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return text
