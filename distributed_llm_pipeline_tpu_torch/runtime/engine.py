"""The single-stream inference engine: load once, serve many.

The counterpart of ``distributed_llm_pipeline_tpu/runtime/engine.py`` for the
path ``dlp-serve --model m.gguf [--quant MODE]`` runs: one stream, a dense
KV cache, weights dequantized at load or, with ``quant``, kept quantized on
the device (``int8``, ``q8_0`` and the K-quant modes repack the projections
and the head at load; ``native`` serves the GGUF's own Q8_0 / Q2_K / Q3_K /
Q4_K / Q5_K / Q6_K blocks).
Weights go to the device once; a request costs its own prefill and decode. ``generate`` yields the same event
stream as the reference: ``log`` lines (placement and progress; the
placement line keeps the word "offloaded" that the UI highlights),
``token`` text, and a closing ``done`` summary.

Decode runs in chunks of ``DLP_DECODE_CHUNK`` steps (default 32). Each step
forwards and samples on the device; the sampled token feeds the next step
without leaving the device, and the host reads a chunk's tokens back once,
after the next chunk is already queued. The KV cache is written in place
(the reference donates it to XLA for the same effect).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no such request they raise.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import torch

from ..gguf import GGUFReader
from ..models import KVCache, LlamaModel, ModelConfig, PagedKVCache, Params
from ..models.convert import load_params, native_quant_layers, select_rope_factors
from ..models.convert import latent_default_rank, latent_factorize
from ..models.llama import (check_kv_mode, check_kv_quant, check_quant,
                            quantize_params, quantized_bytes)
from ..ops.latent_attention import LATENT_RANKS
from ..ops.quant_matmul import QuantPack
from ..ops.sampling import apply_penalties, sample
from ..tokenizer import StreamDecoder, Tokenizer, tokenizer_from_metadata
from ..utils import Event, done, log, token
from . import capabilities


@dataclass
class GenerationConfig:
    max_new_tokens: int = 200       # reference default: -n 200
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0              # 0 disables
    repeat_penalty: float = 1.0     # 1 disables
    repeat_last_n: int = 64         # penalty window
    presence_penalty: float = 0.0   # 0 disables
    frequency_penalty: float = 0.0  # 0 disables
    seed: int | None = None
    stop_on_eos: bool = True
    stop: tuple[str, ...] = ()      # stop strings


class StopMatcher:
    """Streaming stop-string detection with holdback.

    Emitted text lags the decoded text by ``max(len(stop)) - 1`` characters,
    so a stop string that lands across two token pieces is still caught
    before any part of it reaches the client. ``feed`` returns
    ``(text_safe_to_emit, stopped)``; once stopped, the held text is
    discarded (the stop string itself is never emitted)."""

    def __init__(self, stops: tuple[str, ...]):
        self.stops = tuple(s for s in stops if s)
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.buf = ""
        self.matched: str | None = None  # which stop string fired

    def feed(self, piece: str) -> tuple[str, bool]:
        self.buf += piece
        cuts = [(i, s) for i, s in ((self.buf.find(s), s)
                                    for s in self.stops) if i >= 0]
        if cuts:
            cut = min(i for i, _ in cuts)
            # earliest occurrence wins; ties go to the longest stop
            self.matched = max((s for i, s in cuts if i == cut), key=len)
            emit, self.buf = self.buf[:cut], ""
            return emit, True
        if not self.hold:
            emit, self.buf = self.buf, ""
        elif len(self.buf) > self.hold:
            emit, self.buf = self.buf[: -self.hold], self.buf[-self.hold:]
        else:
            emit = ""
        return emit, False

    def flush(self) -> str:
        rest, self.buf = self.buf, ""
        return rest

    def finish(self, tail: str) -> tuple[str, bool]:
        """End-of-stream drain: feed the final piece, then release any held
        text unless a stop matched."""
        emitted, hit = self.feed(tail)
        if hit:
            return emitted, True
        return emitted + self.flush(), False


def _utf8_prefix(tail: bytes) -> bool:
    """True when ``tail`` is a valid PREFIX of one multibyte UTF-8 char."""
    if not tail:
        return False
    lead = tail[0]
    if lead >= 0xF5 or 0x80 <= lead < 0xC2:  # continuation/overlong/too-high
        return False
    need = 2 if lead < 0xE0 else 3 if lead < 0xF0 else 4
    if len(tail) >= need:
        return False  # complete sequence would have decoded (or is invalid)
    return all(0x80 <= c < 0xC0 for c in tail[1:])


def _bucket(n: int, cap: int, minimum: int = 16, quantum: int = 1) -> int:
    """Prompt length padded to a power of two ≥ 16, capped at ``cap``: a
    small, fixed set of prefill shapes, as the reference buckets them. The
    cap must already be a multiple of ``quantum`` (see Engine.max_prompt);
    the buckets are quantum-multiples themselves for quantum 1 or 16."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


def check_token_ids(ids: list[int], vocab_size: int) -> list[int]:
    """Raise ``ValueError`` on a pre-tokenized prompt holding an id outside
    ``[0, vocab_size)``: the embedding gather would index past its table (a
    device-side assert on the card, which ends the process's CUDA context)
    or wrap a negative id."""
    bad = next((t for t in ids if not 0 <= t < vocab_size), None)
    if bad is not None:
        raise ValueError(f"token id {bad} outside the vocabulary [0, {vocab_size})")
    return ids


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the one asked for, else CUDA. With
    no CUDA device and no explicit request this raises; nothing falls back
    to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (device='cpu', or --cpu) to run there")
    return torch.device("cuda", torch.cuda.current_device())


class Engine:
    """Single-model, single-stream inference engine on one device.

    ``quant``: None (dense weights), ``"int8"``, ``"q8_0"``, ``"q2_k"``,
    ``"q3_k"``, ``"q4_k"``, ``"q5_k"`` or ``"q6_k"`` (pack the projections
    and the head at load) or ``"native"`` (serve the GGUF's stored Q8_0 /
    Q2_K / Q3_K / Q4_K / Q5_K / Q6_K projection blocks as they are); any
    other mode raises ``ValueError``.

    ``kv_quant="q8_0"`` keeps the KV cache and the slot pools in int8 codes
    with one f32 scale per cached vector. ``kv_mode``: ``"dense"``
    (per-head K/V) or ``"latent"`` (one rank-``kv_latent_rank`` latent per
    token per side, the bases factorized from wk / wv at load, before any
    weight packing); left None it is ``"latent"`` under
    ``DLP_KV_LATENT=1``, whose rank ``DLP_KV_LATENT_RANK`` may set, as in
    the reference. On the card the rank must be one the kernels take
    (``LATENT_RANKS``)."""

    def __init__(self, model_path: str | Path | None = None, *,
                 cfg: ModelConfig | None = None, params: Params | None = None,
                 tokenizer: Tokenizer | None = None, max_seq: int | None = None,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 quant: str | None = None, kv_quant: str | None = None,
                 kv_mode: str | None = None, kv_latent_rank: int | None = None):
        check_quant(quant)
        check_kv_quant(kv_quant)
        if kv_mode is not None:
            check_kv_mode(kv_mode)
        elif capabilities.env_kv_latent():
            kv_mode = "latent"
        self.device = resolve_device(device)
        if quant and self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"quant {quant!r} on the card serves bf16 "
                             f"activations, not {dtype}")
        self._events_on_load: list[Event] = []
        t0 = time.monotonic()
        # a repacked model loads on the host, packs there, then moves
        load_dev = "cpu" if quant not in (None, "native") else self.device
        pack_s = 0.0   # host time spent building packs
        if model_path is not None:
            with GGUFReader(model_path) as reader:
                cfg = ModelConfig.from_gguf_metadata(reader.metadata)
                eff_ctx = min(max_seq or cfg.max_seq_len, cfg.max_seq_len)
                cfg = select_rope_factors(reader, cfg, eff_ctx)
                self.tokenizer = tokenizer_from_metadata(reader.metadata)
                n_quant = sum(1 for t in reader.tensors.values()
                              if int(t.ggml_type) > 1)
                self._events_on_load.append(log(
                    f"model load: {Path(model_path).name} arch={cfg.arch} "
                    f"layers={cfg.n_layers} dim={cfg.dim} "
                    f"tensors={len(reader.tensors)} ({n_quant} quantized)"))
                packs = {}
                if quant == "native":
                    t_q = time.monotonic()
                    packs = native_quant_layers(reader, cfg)
                    pack_s = time.monotonic() - t_q
                    if not packs:
                        raise ValueError(
                            "--quant native: this GGUF stores no projection "
                            "weight stack as Q2_K, Q3_K, Q8_0, Q4_K, Q5_K or "
                            "Q6_K; use --quant int8, q8_0 or a K-quant mode to "
                            "requantize instead")
                    self._events_on_load.append(log(
                        f"serving {len({k.rsplit('.', 1)[1] for k in packs})} "
                        f"projection weight stacks from their native GGUF block "
                        f"format ({', '.join(sorted({p.kind for p in packs.values()}))})"))
                skip = frozenset(k.rsplit(".", 1)[1] for k in packs)
                params = load_params(reader, cfg, dtype=dtype, device=load_dev,
                                     skip=skip)
                params.update({k: p.to(self.device) for k, p in packs.items()})
        else:
            if cfg is None or tokenizer is None or params is None:
                raise ValueError("need model_path, or cfg + tokenizer + params")
            if quant == "native":
                raise ValueError("--quant native needs a GGUF model path")
            self.tokenizer = tokenizer
            params = {k: t.to(load_dev) if isinstance(t, QuantPack)
                      else t.to(device=load_dev, dtype=dtype)
                      for k, t in params.items()}
        self.kv_quant = kv_quant
        self.kv_mode = kv_mode or "dense"
        self.kv_latent_rank: int | None = None
        if self.kv_mode == "latent":
            # the SVD needs the dense wk / wv, so it runs before packing; the
            # bases stay dense
            if kv_latent_rank is None:
                env_rank = os.environ.get("DLP_KV_LATENT_RANK")
                kv_latent_rank = int(env_rank) if env_rank else None
            rank = int(kv_latent_rank or latent_default_rank(cfg))
            if self.device.type == "cuda" and rank not in LATENT_RANKS:
                raise ValueError(f"latent rank {rank}: the CUDA latent kernels "
                                 f"take ranks {LATENT_RANKS}")
            params = latent_factorize(params, cfg, rank)
            self.kv_latent_rank = rank
            khd = cfg.n_kv_heads * cfg.head_dim
            self._events_on_load.append(log(
                f"latent KV compression active (kv_mode=latent): rank {rank} of "
                f"{khd} per side via truncated SVD of wk/wv; the KV caches hold "
                f"2*{rank} elements a token instead of 2*{khd}"))
        if quant:
            if quant != "native":
                t_q = time.monotonic()
                params = quantize_params(params, cfg, quant)
                pack_s = time.monotonic() - t_q
                params = {k: t.to(self.device) for k, t in params.items()}
            stored, dense = quantized_bytes(params)
            self._events_on_load.append(log(
                f"weights quantized on the device ({quant}): "
                f"{stored / 2**20:.1f} MiB ({dense / 2**20:.1f} MiB as bf16), "
                f"packed on the host in {pack_s:.2f}s; matmuls run on the "
                f"packed weights (CUDA kernels)"))
        self.quant = quant
        self.cfg = cfg
        self.dtype = dtype
        self.model = LlamaModel(cfg, params)
        self.max_seq = min(max_seq or cfg.max_seq_len, cfg.max_seq_len)
        self.decode_chunk = max(1, int(os.environ.get("DLP_DECODE_CHUNK", "32")))
        self._prompt_quantum = 1   # prefill buckets are multiples of this
        self.forwards = 0   # model forwards run: one per prefill, one per decode step
        self._fused_resolved: dict[tuple[int, int], bool] = {}
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "CPU")
        self._events_on_load.append(log(
            f"device: 1x {dev} ({self.device}); all {cfg.n_layers} layers "
            f"offloaded to {self.device} ("
            f"{f'{quant} weights, ' if quant else 'dequantized '}"
            f"{str(dtype).split('.')[-1]})"))
        self._events_on_load.append(log(
            f"weights ready in {time.monotonic() - t0:.2f}s; kv cache capacity "
            f"{self.max_seq} tokens"
            f"{f' ({kv_quant})' if kv_quant else ''}"))

    @property
    def max_prompt(self) -> int:
        """Longest usable prompt: the largest quantum-multiple ≤ max_seq."""
        cap = self.max_seq - self.max_seq % self._prompt_quantum
        return cap if cap > 0 else self.max_seq

    def make_cache(self, batch: int = 1) -> KVCache:
        return KVCache.zeros(self.cfg, batch=batch, max_seq=self.max_seq,
                             dtype=self.dtype, device=self.device,
                             kv_quant=self.kv_quant, kv_mode=self.kv_mode,
                             latent_rank=self.kv_latent_rank)

    def make_paged_cache(self, n_slots: int, *, block_size: int | None = None,
                         n_blocks: int | None = None,
                         n_tables: int | None = None) -> PagedKVCache:
        """The pool variant of :meth:`make_cache`: one physical block pool
        per layer and fixed-width per-slot block tables, sized by
        ``runtime.paged.pool_geometry`` (the default holds every slot's
        full window)."""
        from .paged import pool_geometry, pool_sublane

        bs, nt, n = pool_geometry(self.max_seq, n_slots, block_size=block_size,
                                  n_blocks=n_blocks,
                                  min_block=pool_sublane(self.dtype, self.kv_quant))
        return PagedKVCache.zeros(self.cfg, n_blocks=n, block_size=bs,
                                  batch=n_slots, n_tables=n_tables or nt,
                                  dtype=self.dtype, device=self.device,
                                  kv_quant=self.kv_quant, kv_mode=self.kv_mode,
                                  latent_rank=self.kv_latent_rank)

    def slot_backend(self, n_slots: int, max_seq: int, *, block_size: int | None = None,
                     n_blocks: int | None = None):
        """The :class:`SlotScheduler`'s row store for this engine: slots over
        one paged block pool (``runtime.paged.PagedSlotBackend``)."""
        from .paged import PagedSlotBackend

        return PagedSlotBackend(self, n_slots, max_seq, block_size=block_size,
                                n_blocks=n_blocks)

    def resolve_fused_decode(self, block_size: int, n_slots: int) -> bool:
        """Whether paged decode steps of ``n_slots`` rows run the fused
        decode-step kernel (``ops/fused_decode.py``). Opt-in by
        ``DLP_FUSED_DECODE=1``; a latent pool degrades to unfused (reason
        ``latent-kv``), and a config the kernel cannot serve falls back with
        ``fused_supported``'s reason. The answer is cached per (block_size,
        n_slots) and its reason logged once in the load events."""
        key = (block_size, n_slots)
        if key in self._fused_resolved:
            return self._fused_resolved[key]
        if not capabilities.fused_requested():
            self._fused_resolved[key] = False
            return False
        if self.kv_mode == "latent":
            reason = "latent-kv"
        else:
            from ..ops.fused_decode import fused_supported

            wq = self.model.layers[0]._modules.get("wq")
            reason = fused_supported(
                self.cfg, weight_kind=wq.kind if wq is not None else None,
                batch=n_slots, act_bytes=torch.finfo(self.dtype).bits // 8,
                kv_int8=self.kv_quant == "q8_0")
        if reason is not None:
            capabilities.check_reason(reason)
        active = reason is None
        self._events_on_load.append(log(
            f"fused decode-step kernel active (DLP_FUSED_DECODE=1): RMSNorm + "
            f"QKV + RoPE + paged attention + O-proj in one launch per layer, "
            f"block_size {block_size}, {n_slots} rows" if active else
            f"fused decode requested (DLP_FUSED_DECODE=1) but falling back to "
            f"the unfused paged path: {reason}"))
        self._fused_resolved[key] = active
        return active

    def prefill(self, ids: list[int], cache: KVCache) -> torch.Tensor:
        """Run the prompt, padded to its bucket, into ``cache`` (from
        ``cache.length``); returns the last real position's logits [1, V].
        The padded positions write junk KV past the prompt; resetting
        ``cache.length`` to the true end masks it, and decode overwrites it
        in order."""
        n, start = len(ids), cache.length
        padded = torch.zeros((1, _bucket(n, self.max_prompt - start)), dtype=torch.long)
        padded[0, :n] = torch.tensor(ids, dtype=torch.long)
        logits = self.model.forward_last(padded.to(self.device), cache, n - 1)
        cache.length = start + n
        self.forwards += 1
        return logits

    @torch.inference_mode()
    def _sample(self, logits: torch.Tensor, gen: GenerationConfig,
                rng: torch.Generator, recent: torch.Tensor | None):
        """Penalties (when set) and the sampler chain: logits [B, V] → the
        next token [B, 1] and the updated recent-token window."""
        if recent is not None:
            logits = apply_penalties(logits, recent, gen.repeat_penalty,
                                     gen.presence_penalty, gen.frequency_penalty)
        nxt = sample(logits, rng, gen.temperature, gen.top_k, gen.top_p,
                     gen.min_p)[:, None]
        if recent is not None:
            recent = torch.cat([recent[:, 1:], nxt], dim=1)
        return nxt, recent

    def _decode_chunk(self, n: int, tok: torch.Tensor, cache: KVCache,
                      gen: GenerationConfig, rng: torch.Generator,
                      recent: torch.Tensor | None):
        """n forward + sample steps on the device, nothing read back:
        returns the chunk's tokens [n, B], the last token [B, 1] and the
        recent-token window."""
        toks = []
        for _ in range(n):
            logits = self.model(tok, cache)[:, -1]
            self.forwards += 1
            tok, recent = self._sample(logits, gen, rng, recent)
            toks.append(tok[:, 0])
        return torch.stack(toks), tok, recent

    def _to_host(self, t: torch.Tensor):
        """Queue a device→host copy of ``t``; returns a callable that waits
        for it and gives the values as a list."""
        if t.device.type != "cuda":
            return t.tolist
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()

        def read():
            ready.synchronize()
            return host.tolist()

        return read

    def generate(self, prompt: str | list[int],
                 gen: GenerationConfig | None = None) -> Iterator[Event]:
        """Streaming generation: yields log / token / done events."""
        gen = gen or GenerationConfig()
        yield from self._events_on_load
        ids = check_token_ids(list(prompt), self.cfg.vocab_size) \
            if isinstance(prompt, (list, tuple)) else self.tokenizer.encode(prompt)
        n_prompt = len(ids)
        if n_prompt >= self.max_prompt:
            ids = ids[-(self.max_prompt - 1):]
            yield log(f"prompt truncated to last {len(ids)} tokens (ctx {self.max_seq})")
        budget = max(0, min(gen.max_new_tokens, self.max_seq - len(ids)))
        yield log(f"prompt: {n_prompt} tokens; generating up to {budget} "
                  f"(ctx {self.max_seq}, t={gen.temperature}, top_k={gen.top_k}, "
                  f"top_p={gen.top_p})")
        if budget == 0:
            yield done("generated 0 tokens (no budget)", n_prompt=len(ids),
                       n_gen=0, finish_reason="length")
            return
        rng = torch.Generator(device=self.device)
        rng.manual_seed(gen.seed if gen.seed is not None else time.time_ns() % 2**31)
        recent = None
        if (gen.repeat_penalty != 1.0 or gen.presence_penalty != 0.0
                or gen.frequency_penalty != 0.0):
            W = max(1, gen.repeat_last_n)
            recent = torch.tensor([([-1] * W + ids)[-W:]], dtype=torch.long,
                                  device=self.device)
        stopper = StopMatcher(tuple(gen.stop)) if gen.stop else None
        sd = StreamDecoder(self.tokenizer)
        eos = self.tokenizer.eos_id

        t_start = time.monotonic()
        cache = self.make_cache()
        tok, recent = self._sample(self.prefill(ids, cache), gen, rng, recent)
        first = self._to_host(tok[:, 0])()[0]
        ttft = time.monotonic() - t_start
        yield log(f"prefill: {len(ids)} tokens in {ttft * 1000:.1f} ms (TTFT)")
        t_decode = time.monotonic()

        n_gen, finish_reason, stopped, stop_matched = 0, "length", False, False

        def take(t: int):
            """Account one sampled token: returns the text to emit (or None)
            and sets the stop state."""
            nonlocal n_gen, finish_reason, stopped, stop_matched
            if gen.stop_on_eos and eos is not None and t == eos:
                finish_reason, stopped = "stop", True
                return None
            n_gen += 1
            text = sd.feed(t)
            if stopper is not None:
                text, hit = stopper.feed(text)
                if hit:
                    finish_reason, stopped, stop_matched = "stop", True, True
            if n_gen >= budget:
                stopped = True
            return text

        text = take(first)
        if text:
            yield token(text)
        pending = None   # (read, n) of the chunk whose tokens are in flight
        while True:
            launched = None
            room = budget - n_gen - (pending[1] if pending else 0)
            n = min(self.decode_chunk, room, self.max_seq - cache.length)
            if not stopped and n > 0:
                toks, tok, recent = self._decode_chunk(n, tok, cache, gen, rng, recent)
                launched = (self._to_host(toks[:, 0]), n)
            if pending is not None and not stopped:
                # read the previous chunk while the one just queued runs
                for t in pending[0]():
                    text = take(t)
                    if text:
                        yield token(text)
                    if stopped:
                        break
            # once stopped, a chunk still in flight is junk past the stop
            pending = None if stopped else launched
            if pending is None:
                break
        tail = sd.flush()
        if not stop_matched:
            if stopper is not None:
                tail, hit = stopper.finish(tail)
                if hit:
                    finish_reason = "stop"
            if tail:
                yield token(tail)
        dt = time.monotonic() - t_decode
        tps = (n_gen - 1) / dt if n_gen > 1 and dt > 0 else float("nan")
        dt_e2e = time.monotonic() - t_start
        tps_e2e = n_gen / dt_e2e if n_gen and dt_e2e > 0 else float("nan")
        yield done(f"generated {n_gen} tokens | TTFT {ttft * 1000:.1f} ms | "
                   f"decode {tps:.2f} tok/s",
                   n_prompt=len(ids), n_gen=n_gen, finish_reason=finish_reason,
                   ttft_ms=ttft * 1000, tok_s=tps, tok_s_e2e=tps_e2e,
                   stop_match=stopper.matched if stopper else None)
