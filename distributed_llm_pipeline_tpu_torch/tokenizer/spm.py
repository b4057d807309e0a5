"""SentencePiece-style (Llama-2 family) tokenizer over a GGUF-embedded vocab.

Score-driven greedy bigram merging with byte fallback, as sentencepiece's BPE
mode behaves: start from single characters, repeatedly merge the adjacent pair
whose concatenation is the in-vocab piece with the highest score (leftmost on
ties), until no merge applies; pieces absent from the vocab fall back to
``<0xNN>`` byte tokens, else UNK.
"""

from __future__ import annotations

import heapq

from .base import Tokenizer, TokenType, Vocab

SPM_SPACE = "▁"  # ▁


class SPMTokenizer(Tokenizer):
    def __init__(self, vocab: Vocab):
        super().__init__(vocab)
        if vocab.scores is None:
            raise ValueError("SPM tokenizer requires tokenizer.ggml.scores")
        self._byte_tokens: dict[int, int] = {}
        for i, t in enumerate(vocab.tokens):
            if vocab.type_of(i) == TokenType.BYTE or (
                len(t) == 6 and t.startswith("<0x") and t.endswith(">")
            ):
                try:
                    self._byte_tokens[int(t[3:5], 16)] = i
                except ValueError:
                    pass

    # -- encode -------------------------------------------------------------

    def _encode_text(self, text: str) -> list[int]:
        if not text:
            return []
        if self.vocab.add_space_prefix and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", SPM_SPACE)
        symbols = list(text)

        t2i = self.vocab.token_to_id
        scores = self.vocab.scores
        # best-bigram-first merging via a heap over a linked list of live
        # symbols — O(n log n), the same structure llama.cpp's SPM tokenizer
        # uses. A naive rescan-after-every-merge loop is O(n²) and takes
        # MINUTES on a long-context prompt (measured: 114k tokens → 268 s;
        # this path: < 1 s), which would dominate 128k-context TTFT.
        # Semantics are unchanged: highest score wins, leftmost on ties
        # (original positions never reorder, so the heap's position
        # tie-break reproduces the scan order); entries are validated
        # against the CURRENT symbol pair on pop, so stale entries from
        # earlier merges are skipped.
        n = len(symbols)
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap: list[tuple[float, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j < 0:
                return
            merged = symbols[i] + symbols[j]
            tid = t2i.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-scores[tid], i, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j < 0 or symbols[i] + symbols[j] != merged:
                continue  # stale: one side already merged away
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(i)
            if prv[i] >= 0:
                push(prv[i])
        symbols = [symbols[i] for i in range(n) if alive[i]]

        ids: list[int] = []
        for sym in symbols:
            tid = t2i.get(sym)
            if tid is not None:
                ids.append(tid)
                continue
            # byte fallback
            fell_back = True
            for b in sym.encode("utf-8"):
                bid = self._byte_tokens.get(b)
                if bid is None:
                    fell_back = False
                    break
                ids.append(bid)
            if not fell_back and self.vocab.unk_id is not None:
                ids.append(self.vocab.unk_id)
        return ids

    # -- decode -------------------------------------------------------------

    def token_bytes(self, tid: int) -> bytes:
        """Raw bytes one token contributes to the output stream."""
        if not hasattr(self, "_byte_rev"):
            self._byte_rev = {v: k for k, v in self._byte_tokens.items()}
        if tid in self._byte_rev:
            return bytes([self._byte_rev[tid]])
        return self.vocab.tokens[tid].replace(SPM_SPACE, " ").encode("utf-8")

    def _decode_tokens(self, ids: list[int]) -> str:
        text = b"".join(self.token_bytes(t) for t in ids).decode("utf-8", errors="replace")
        if self.vocab.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text
