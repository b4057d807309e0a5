"""Host-side constrained-decoding sampler shared by the single-stream engine
and the parallel-slot scheduler: the port's copy of
``distributed_llm_pipeline_tpu/runtime/constrained.py``.

llama.cpp's grammar sampling is per-slot state in its sampler chain
(reference N10/N13 — SURVEY.md §2.2): each step the candidate array is
filtered by the grammar's valid-prefix automaton, then sampled. This module
is that automaton-plus-sampler as one host-side object: the DEVICE proposes a
top-K shortlist, the host keeps candidates whose decoded text extends a valid
prefix of the constraint (built-in JSON acceptor, or a compiled GBNF
grammar), renormalizes, samples, and advances the automaton.

Kept host-side on purpose: a grammar automaton is pointer-chasing control
flow, which no accelerator runs well, while the shortlist is one tiny [K]
readback per token. The sampler draws from numpy's ``default_rng(seed)`` on
the host, as the reference does, so a seeded constrained stream does not
depend on the device's generator.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .engine import GenerationConfig, _utf8_prefix


def _utf8_delta(pending: bytes, b: bytes):
    """Strict incremental decode of ``pending + b`` where ``pending`` is the
    (≤3-byte) undecoded tail of everything emitted so far. Returns
    (new_text, new_pending, ok). A trailing INCOMPLETE multibyte sequence is
    ok (new_text may be ""); INVALID bytes reject the candidate —
    errors='ignore' would silently drop them and let byte-garbage tokens
    through the constraint filter. Working only on the tail keeps constrained
    decode O(token bytes), not O(total output) per candidate."""
    buf = pending + b
    try:
        return buf.decode("utf-8"), b"", True
    except UnicodeDecodeError as e:
        tail = buf[e.start:]
        if e.end == len(buf) and len(tail) <= 3 and _utf8_prefix(tail):
            return buf[: e.start].decode("utf-8"), tail, True
        return "", b"", False


class ConstrainedSampler:
    """Per-request constrained-decoding state: validator automaton, pending
    UTF-8 tail, RNG, and the candidate filter + sampler.

    ``pick(cand_v, cand_i)`` consumes one step's device shortlist and
    returns ``(token_id, delta_text)`` for the chosen continuation, or None
    when no candidate extends a valid prefix (callers may retry with a wider
    shortlist — the engine falls back to the full vocab — or end the
    stream). ``complete`` flips when the constraint is satisfied."""

    def __init__(self, gen: GenerationConfig,
                 token_bytes: Callable[[int], bytes], eos_id: int | None):
        if gen.json_mode and gen.grammar:
            raise ValueError("json mode and a GBNF grammar are mutually "
                             "exclusive constraints; pick one")
        if gen.grammar:
            from ..ops.gbnf import GrammarValidator, compile_grammar

            self.validator = GrammarValidator(compile_grammar(gen.grammar))
        else:
            from ..ops.json_constraint import JsonPrefixValidator

            self.validator = JsonPrefixValidator()
        self.gen = gen
        self.token_bytes = token_bytes
        self.eos_id = eos_id
        self.pending = b""
        self.rng = np.random.default_rng(
            gen.seed if gen.seed is not None else None)

    @property
    def complete(self) -> bool:
        return self.validator.complete

    def filter(self, cand_v, cand_i, cap: int | None = None,
               raw_max: float | None = None):
        """Candidates (descending-logit order) → the valid subset.
        Returns (keep_v, keep_i, deltas) with deltas[(bytes, text, pending)].
        ``raw_max`` anchors the min-p cutoff when cand_v is a TAIL of the
        distribution (fallback tiers) rather than starting at the true max."""
        gen = self.gen
        if raw_max is None:
            raw_max = float(cand_v[0]) if len(cand_v) else 0.0
        keep_v, keep_i, deltas = [], [], []
        for v, t in zip(cand_v, cand_i):
            t = int(t)
            if self.eos_id is not None and t == self.eos_id:
                continue  # the constraint's own completion ends generation
            if gen.min_p > 0.0 and float(v) < raw_max + np.log(gen.min_p):
                continue  # min-p relative to the raw top candidate
            b = self.token_bytes(t)
            if not b:
                continue  # control tokens contribute nothing
            delta, new_pending, ok = _utf8_delta(self.pending, b)
            if not ok:
                continue  # invalid UTF-8 bytes
            probe = self.validator.copy()
            if delta and not probe.feed(delta):
                continue
            if new_pending and not probe.in_string:
                # a dangling partial char can only complete into a non-ASCII
                # character, which the constraint only allows where some
                # terminal accepts one — admitting it elsewhere (even after
                # a valid delta like '1' + partial byte) deadlocks the NEXT
                # step
                continue
            keep_v.append(float(v))
            keep_i.append(t)
            deltas.append((b, delta, new_pending))
            if cap is not None and len(keep_v) >= cap:
                break
        return keep_v, keep_i, deltas

    def choose(self, keep_v: list[float]) -> int:
        """Sample an index from the surviving candidates with the usual
        temperature / top-p chain (keep_v is descending-logit order)."""
        gen = self.gen
        if gen.temperature <= 0.0:
            return 0
        lv = np.asarray(keep_v, np.float64) / gen.temperature
        p = np.exp(lv - lv.max())
        p /= p.sum()
        if gen.top_p < 1.0:
            order = np.argsort(-p)
            cum = np.cumsum(p[order])
            cut = cum - p[order] < gen.top_p
            cut[0] = True
            allowed = order[cut]
            mask = np.zeros_like(p, bool)
            mask[allowed] = True
            p = np.where(mask, p, 0.0)
            p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def pick(self, cand_v, cand_i, full_logits=None, cap: int = 64,
             shortlist: int | None = None) -> tuple[int, str] | None:
        """Filter + sample + ADVANCE the automaton for one step. The device
        shortlist is truncated by the request's top_k first; when it misses
        every valid token the fallback ladder keeps llama.cpp's full-array
        semantics (it filters the full candidate array) without paying a
        vocab-wide transfer per token:

        1. primary tier — first ``shortlist`` candidates (or all of cand_v
           when ``shortlist`` is None), every one probed, sampled over the
           full valid subset;
        2. the REST of cand_v (when wider than ``shortlist``) in descending
           order, first ``cap`` valid kept — a cheap already-read-back tier;
        3. ``full_logits`` — the whole vocab, descending; may be a zero-arg
           callable so the [V] row is only fetched from device on this rare
           double miss."""
        gen = self.gen
        cand_v = np.asarray(cand_v)
        cand_i = np.asarray(cand_i)
        rest_v = rest_i = None
        raw_max = float(cand_v[0]) if len(cand_v) else 0.0
        if shortlist is not None and len(cand_v) > shortlist:
            # the tail tier starts where the PROBED prefix ends: top_k < shortlist
            # truncates the primary tier, and ranks top_k..shortlist would
            # otherwise never be probed by any tier
            cut = gen.top_k if 0 < gen.top_k < shortlist else shortlist
            rest_v, rest_i = cand_v[cut:], cand_i[cut:]
            cand_v, cand_i = cand_v[:cut], cand_i[:cut]
        elif gen.top_k > 0:
            cand_v = cand_v[: gen.top_k]
            cand_i = cand_i[: gen.top_k]
        keep_v, keep_i, deltas = self.filter(cand_v, cand_i)
        if not keep_v and rest_v is not None and len(rest_v):
            keep_v, keep_i, deltas = self.filter(rest_v, rest_i, cap=cap,
                                                 raw_max=raw_max)
        if not keep_v and full_logits is not None:
            full = np.asarray(full_logits() if callable(full_logits)
                              else full_logits, np.float32)
            order = np.argsort(-full)
            keep_v, keep_i, deltas = self.filter(full[order], order, cap=cap,
                                                 raw_max=raw_max)
        if not keep_v:
            return None
        choice = self.choose(keep_v)
        tok = keep_i[choice]
        _, delta, self.pending = deltas[choice]
        if delta:
            self.validator.feed(delta)
        return tok, delta
