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
(the reference donates it to XLA for the same effect). With
``context_shift`` a stream runs past the context: when the cache is full
and no chunk is in flight, half the cached positions after ``keep`` are
dropped and the moved keys re-rotated (llama.cpp's shift).

A JSON-mode or grammar request decodes one forward a token instead: the
host picks each token from the device's shortlist of the logits
(``runtime/constrained.py``).

The engine keeps the last request's KV as a prefix cache: a prompt that
extends its ids by at least ``MIN_PREFIX`` tokens prefills only the rest.
``save_session`` / ``load_session`` keep it in a file (``save_kv_file``,
the reference's npz format, shared with the scheduler's slot files). The
other entry points: ``embed`` (pooled embeddings), ``infill_ids``
(fill-in-middle prompts), ``perplexity`` and ``generate_batch`` (several
prompts at once over a cache whose rows each have their own length).

``lora`` merges LoRA adapters (``models/lora.py``) into the dense host
weights at load, before any packing, factorization or device placement, as
the reference does. Every request is recorded in ``metrics``
(``utils/metrics.py``) at the reference's points and under its names; a
supervisor assigns its own registry there, so a restart keeps the history.
Every request also gets a trace (``utils/tracing.py``), every decode chunk
a step in the perf monitor (``utils/perf.py``), and the KV representation
and the fused decode step resolve on the capability lattice
(``runtime/capabilities.py``).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no such request they raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..gguf import GGUFReader
from ..models import KVCache, LlamaModel, ModelConfig, PagedKVCache, Params
from ..models.convert import load_params, native_quant_layers, select_rope_factors
from ..models.convert import latent_default_rank, latent_factorize
from ..models.llama import (POOLING_TYPES, check_kv_mode, check_kv_quant,
                            check_quant, quantize_params, quantized_bytes, shift_kv)
from ..ops.latent_attention import LATENT_RANKS
from ..ops.quant_matmul import QuantPack
from ..ops.sampling import (apply_penalties, bias_vector, lp_payload,
                            mirostat_init, mirostat_step, sample, sample_rows,
                            shortlist, topk_logprobs)
from ..tokenizer import StreamDecoder, Tokenizer, tokenizer_from_metadata
from ..utils import (TRACER, Event, Metrics, compile_entry, done, log,
                     preregister_boot_series, profiler_trace, rid_args, token)
from . import capabilities, faults

# the priority classes a request names, best first: slot grants, the mixed
# step's prefill budget and the queue-wait estimates are class-major
# (``runtime/scheduler.py``). Both serving dialects take the class name
PRIORITY_CLASSES = ("interactive", "normal", "batch")


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
    # (token_id, bias) pairs added to the raw logits before any filtering;
    # −inf bans a token
    logit_bias: tuple[tuple[int, float], ...] = ()
    seed: int | None = None
    stop_on_eos: bool = True
    stop: tuple[str, ...] = ()      # stop strings
    # top-N alternative logprobs per generated token, of the raw (biased,
    # unpenalized) distribution; None = off
    logprobs: int | None = None
    # wall-clock budget of the whole request: the engine anchors it at
    # generation start, the slots at submission (queue wait counts). Checked
    # at admission, after prefill and at every chunk boundary; an expired
    # request ends with finish reason "timeout", the tokens produced so far
    # delivered. None = no deadline
    deadline_ms: float | None = None
    # the request's priority class, one of PRIORITY_CLASSES; the slots grant
    # rows class-major, earliest deadline first within a class, and only a
    # batch-class row may be preempted. The single-stream engine ignores it
    priority: str = "normal"
    typical_p: float = 1.0          # 1 disables
    # mirostat v1/v2 (0 off): targets surprise τ with learning rate η and
    # replaces top-k, top-p, typical-p and min-p; single stream only
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # constrained decoding: the output is one valid JSON value, or a text
    # of the GBNF grammar given (llama.cpp --grammar); exclusive
    json_mode: bool = False
    grammar: str | None = None
    # llama.cpp's context shift: at the context limit, drop half the cached
    # positions after the first ``keep`` and re-rotate the rest instead of
    # stopping (off here; the CLI turns it on, as llama-cli does)
    context_shift: bool = False
    keep: int = 0


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


MIN_PREFIX = 16   # the shortest stored prefix a prompt reuses


def _bucket(n: int, cap: int, minimum: int = 16, quantum: int = 1) -> int:
    """Prompt length padded to a power of two ≥ 16, capped at ``cap``: a
    small, fixed set of prefill shapes, as the reference buckets them. The
    cap must already be a multiple of ``quantum`` (see Engine.max_prompt);
    the buckets are quantum-multiples themselves for quantum 1 or 16."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


# the npz dtype name of each cache dtype (the reference's ``str(k.dtype)``):
# 2-byte floats are stored as a uint16 view under their name
_KV_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": torch.float32, "int8": torch.int8}
_KV_NAMES = {v: k for k, v in _KV_DTYPES.items()}


def _kv_host(t: torch.Tensor) -> np.ndarray:
    """A cache slice as the file stores it: a 2-byte float as its uint16
    bits, any other dtype as itself."""
    t = t.detach().contiguous().cpu()
    if t.element_size() == 2 and t.is_floating_point():
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _kv_npz_arrays(ids: list[int], cache: KVCache, length: int) -> dict:
    """The npz array dict of the KV file: the token ids, the first
    ``length`` positions of K and V (axis -3 is the sequence axis; a
    2-byte float as a uint16 view, its dtype name beside it), the length,
    and on an int8 cache the per-vector scales ``ks`` / ``vs``. The
    reference's format: files cross the two packages both ways."""
    def cut(t: torch.Tensor) -> np.ndarray:
        return _kv_host(t[..., :length, :, :])

    extra = {}
    if cache.k_scale is not None:   # an int8 cache: the scales go too
        extra["ks"] = cut(cache.k_scale)
        extra["vs"] = cut(cache.v_scale)
    return dict(ids=np.asarray(ids, np.int32), k=cut(cache.k), v=cut(cache.v),
                dtype=np.bytes_(_KV_NAMES[cache.k.dtype]),
                length=np.asarray(length, np.int32), **extra)


def save_kv_file(path: str | Path, ids: list[int], cache: KVCache,
                 length: int) -> None:
    """Write ``length`` positions of a KV cache and their token ids to
    ``path`` (llama-cli's --prompt-cache file, llama-server's slot file):
    one format for the engine's session and the scheduler's slots. Only
    the first ``length`` positions are stored, so a short session on a long
    context writes a short file and loads under another ``--ctx-size``."""
    with open(path, "wb") as fh:  # np.savez(path) would append '.npz'
        np.savez(fh, **_kv_npz_arrays(ids, cache, length))


def _kv_from_npz(z, template: KVCache, max_len: int,
                 ) -> tuple[KVCache, list[int]] | None:
    """Fill ``template`` (a zeroed cache of the engine's layout) from an
    open npz: the stored positions first, the rest left as they are, the
    length set. None when the file does not match: another layout (every
    axis but the sequence one must be equal), a length past the template's
    capacity or ``max_len``, another dtype, or a dense file for an int8
    cache (or the reverse), which would change the numerics."""
    dt = _KV_DTYPES.get(z["dtype"].item().decode())
    ids = z["ids"].tolist()
    length = int(z["length"])
    k, v = z["k"], z["v"]
    quant = template.k_scale is not None
    has_scales = "ks" in z.files
    exp = tuple(template.k.shape)
    if (dt is None or k.shape[:-3] + k.shape[-2:] != exp[:-3] + exp[-2:]
            or k.shape[-3] != length or length > exp[-3] or length > max_len
            or dt != template.k.dtype or quant != has_scales):
        return None

    def put(dst: torch.Tensor, a: np.ndarray) -> None:
        t = torch.from_numpy(a.view(np.int16)).view(dt) if a.dtype == np.uint16 \
            else torch.from_numpy(a)
        dst[..., :length, :, :] = t.to(dst.device)

    put(template.k, k)
    put(template.v, v)
    if quant:
        put(template.k_scale, z["ks"])
        put(template.v_scale, z["vs"])
    template.length = length
    return template, ids[:length]


def load_kv_file(path: str | Path, template: KVCache, max_len: int,
                 ) -> tuple[KVCache, list[int]] | None:
    """Load a saved KV file into ``template``'s layout: (the cache with
    ``length`` set, the ids), or None when the file does not match (another
    model, context or quantization); callers then ignore the file."""
    with np.load(path) as z:
        return _kv_from_npz(z, template, max_len)


def check_token_ids(ids: list[int], vocab_size: int) -> list[int]:
    """Raise ``ValueError`` on a pre-tokenized prompt holding an id outside
    ``[0, vocab_size)``: the embedding gather would index past its table (a
    device-side assert on the card, which ends the process's CUDA context)
    or wrap a negative id."""
    bad = next((t for t in ids if not 0 <= t < vocab_size), None)
    if bad is not None:
        raise ValueError(f"token id {bad} outside the vocabulary [0, {vocab_size})")
    return ids


def check_sampler(gen: GenerationConfig) -> GenerationConfig:
    """The single-stream engine's checks of a request's sampler, as the
    reference's: ``ValueError`` on a mirostat version other than 0, 1 or 2,
    on mirostat with logprobs (its truncation is adaptive state, not a
    fixed distribution to report), and on a constrained request (JSON mode
    or a grammar) with mirostat, typical-p, the other constraint, logprobs,
    a penalty or a logit bias. A greedy request runs neither mirostat nor
    typical-p, so both are switched off for it."""
    if gen.mirostat not in (0, 1, 2):
        raise ValueError(f"mirostat must be 0, 1 or 2, got {gen.mirostat}")
    if gen.temperature <= 0.0 and (gen.mirostat or gen.typical_p < 1.0):
        gen = dataclasses.replace(gen, mirostat=0, typical_p=1.0)
    if gen.mirostat and gen.logprobs is not None:
        raise ValueError("mirostat does not combine with logprobs (its "
                         "truncation is adaptive state, not a fixed "
                         "distribution to report)")
    if gen.json_mode or gen.grammar:
        if gen.mirostat:
            raise ValueError("mirostat does not combine with constrained "
                             "sampling (the grammar re-filters and "
                             "renormalizes candidates host-side)")
        if gen.typical_p < 1.0:
            raise ValueError("typical_p does not combine with "
                             "constrained sampling (the grammar "
                             "re-filters candidates host-side); drop "
                             "one of the two")
        check_constraint_combination(gen)
    return gen


def check_constraint_combination(gen: GenerationConfig) -> None:
    """The checks a constrained request (JSON mode or a grammar) meets on
    every path, the slots included, each a ``ValueError`` in the
    reference's words: one constraint only, no logprobs, no penalty, no
    logit bias."""
    if not (gen.json_mode or gen.grammar):
        return
    if gen.json_mode and gen.grammar:
        raise ValueError("json mode and a GBNF grammar are mutually "
                         "exclusive constraints; pick one")
    if gen.logprobs is not None:
        raise ValueError("logprobs does not combine with constrained "
                         "sampling (the grammar re-filters and "
                         "renormalizes candidates host-side)")
    if (gen.repeat_penalty != 1.0 or gen.presence_penalty
            or gen.frequency_penalty):
        raise ValueError(
            "repeat/presence/frequency penalties do not compose "
            "with constrained sampling (the grammar re-filters "
            "candidates host-side); drop one of the two")
    if gen.logit_bias:
        raise ValueError(
            "logit_bias does not compose with constrained sampling "
            "(the grammar shortlists candidates from the raw "
            "distribution); drop one of the two")


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
    (``LATENT_RANKS``).

    ``lora``: ``[(adapter GGUF path, scale), ...]``, merged in order into
    the dense weights on the host before anything else touches them, so
    it composes with every ``quant`` but ``native`` (which raises
    ``ValueError``); ``lora_adapters`` records the list.

    The boot cell (KV representation on this backend) resolves through the
    capability lattice (``runtime/capabilities.resolve_boot``). ``perf`` is
    the engine's perf monitor (``utils/perf.py``; ``NULL_PERF`` under
    ``DLP_PERF=0``), and ``profile_dir``, when set, profiles each request
    with ``torch.profiler`` into that directory and joins the device
    timelines onto its trace."""

    # the lattice backend this engine resolves its boot cell on
    # (runtime/capabilities.py); ShardedEngine's is "mesh"
    capability_backend = "engine"

    def __init__(self, model_path: str | Path | None = None, *,
                 cfg: ModelConfig | None = None, params: Params | None = None,
                 tokenizer: Tokenizer | None = None, max_seq: int | None = None,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 quant: str | None = None, kv_quant: str | None = None,
                 kv_mode: str | None = None, kv_latent_rank: int | None = None,
                 lora: list[tuple[str, float]] | None = None):
        check_quant(quant)
        check_kv_quant(kv_quant)
        if kv_mode is not None:
            check_kv_mode(kv_mode)
        self.device = resolve_device(device)
        if quant and self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"quant {quant!r} on the card serves bf16 "
                             f"activations, not {dtype}")
        self._events_on_load: list[Event] = []
        self.metrics = Metrics()
        # the boot cell on the lattice: an explicit kv_mode pins the KV
        # representation, the DLP_KV_LATENT=1 default may degrade (counted
        # and logged)
        kv_mode, self.capability_resolution = capabilities.resolve_boot(
            kv_mode=kv_mode, kv_quant=kv_quant, backend=self.capability_backend,
            metrics=self.metrics)
        for d in self.capability_resolution.degradations:
            self._events_on_load.append(log(d.note))
        self.profile_dir: str | None = None   # set: per-request profiler traces
        self.lora_adapters: list[tuple[str, float]] = []
        t0 = time.monotonic()
        # a repacked model loads on the host, packs there, then moves; so
        # does one that merges adapters
        load_dev = ("cpu" if quant not in (None, "native") or lora
                    else self.device)
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
                if lora:
                    # merged into the dense host weights before any packing,
                    # factorization or placement (llama.cpp --lora)
                    if quant == "native":
                        raise ValueError(
                            "--lora merges into dense weights; --quant native "
                            "serves packed blocks — drop one of the two")
                    from ..models.lora import apply_lora

                    for line in apply_lora(params, cfg, list(lora)):
                        self._events_on_load.append(log(line))
                    self.lora_adapters = list(lora)
                    if not quant:
                        params = {k: t.to(self.device) for k, t in params.items()}
                params.update({k: p.to(self.device) for k, p in packs.items()})
        else:
            if cfg is None or tokenizer is None or params is None:
                raise ValueError("need model_path, or cfg + tokenizer + params")
            if quant == "native":
                raise ValueError("--quant native needs a GGUF model path")
            if lora:
                raise ValueError("--lora needs a GGUF model path")
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
        # model forwards run: one per prefill, decode step, embedding and
        # perplexity chunk
        self.forwards = 0
        self.context_shifts = 0   # context shifts applied
        # the prefix cache: the last request's KV and the token ids it holds.
        # A prompt that extends those ids (a chat's next turn, a repeated
        # system prompt) prefills only its suffix
        self.prefix_cache_enabled = True
        self._prefix_ids: list[int] = []
        self._prefix_cache: KVCache | None = None
        self.prefix_hits = 0      # requests that reused a stored prefix
        self.prefix_tokens = 0    # prompt tokens they did not prefill
        self._embed_caches: dict[int, KVCache] = {}
        self._fused_resolved: dict[tuple[int, int], bool] = {}
        self._register_boot_series()
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "CPU")
        # the perf monitor, built after packing and placement so its model
        # bytes are the resident (packed) size; the metrics resolve per call
        # because a supervisor swaps in its registry's after the build
        from ..utils.perf import (make_perf_monitor, metrics_reader,
                                  model_flops_per_token, params_nbytes)
        from .paged import kv_token_bytes

        self.perf = make_perf_monitor(
            model_bytes=params_nbytes(self.model),
            flops_per_token=model_flops_per_token(cfg),
            kv_bytes_per_token=kv_token_bytes(cfg, kv_quant, self.kv_mode,
                                              self.kv_latent_rank),
            platform=self.device.type, model=cfg.arch,
            metrics_fn=metrics_reader(self),
            device_name=dev if self.device.type == "cuda" else None)
        self._events_on_load.append(log(
            f"device: 1x {dev} ({self.device}); all {cfg.n_layers} layers "
            f"offloaded to {self.device} ("
            f"{f'{quant} weights, ' if quant else 'dequantized '}"
            f"{str(dtype).split('.')[-1]})"))
        self._events_on_load.append(log(
            f"weights ready in {time.monotonic() - t0:.2f}s; kv cache capacity "
            f"{self.max_seq} tokens"
            f"{f' ({kv_quant})' if kv_quant else ''}"))

    def _register_boot_series(self) -> None:
        """The documented boot schema at 0, the per-mode KV cost catalog and
        the labelled outcome family, as the reference registers them when
        an engine is built, so /metrics exports every series from the first
        scrape."""
        from .paged import kv_token_bytes

        m, cfg = self.metrics, self.cfg
        preregister_boot_series(m)
        rank = self.kv_latent_rank or latent_default_rank(cfg)
        for mode, args in (("dense", (None, "dense", None)),
                           ("q8_0", ("q8_0", "dense", None)),
                           ("latent", (None, "latent", rank)),
                           ("latent_q8_0", ("q8_0", "latent", rank))):
            m.set_gauge("kv_bytes_per_token", kv_token_bytes(cfg, *args),
                        labels={"mode": mode})
        m.set_gauge("kv_latent_rank", rank if self.kv_mode == "latent" else 0)
        for outcome in ("stop", "length", "abort", "error", "timeout"):
            m.inc("requests_finished_total", 0,
                  labels={"model": cfg.arch, "outcome": outcome})

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
        ``DLP_FUSED_DECODE=1``; the paged slot pool's fused cell resolves on
        the capability lattice (a latent pool degrades to unfused, reason
        ``latent-kv``, counted there), and a config the kernel cannot serve
        falls back with ``fused_supported``'s reason. The answer is cached
        per (block_size, n_slots) and its reason logged once in the load
        events."""
        key = (block_size, n_slots)
        if key in self._fused_resolved:
            return self._fused_resolved[key]
        if not capabilities.fused_requested():
            self.metrics.set_gauge("fused_decode_active", 0)
            self._fused_resolved[key] = False
            return False
        res = capabilities.resolve(
            {"kv_layout": "paged",
             "kv_repr": capabilities.kv_repr_label(self.kv_quant, self.kv_mode),
             "decode": "fused", "backend": "paged-slots", "role": "both"},
            metrics=self.metrics)
        if res.features["decode"] != "fused":
            reason = res.degradations[0].reason
        else:
            from ..ops.fused_decode import fused_supported

            wq = self.model.layers[0]._modules.get("wq")
            reason = fused_supported(
                self.cfg, weight_kind=wq.kind if wq is not None else None,
                batch=n_slots, act_bytes=torch.finfo(self.dtype).bits // 8,
                kv_int8=self.kv_quant == "q8_0")
            if reason is not None:
                # a per-config fallback: counted as the lattice counts its
                # rewrites, its family held to the declared vocabulary
                capabilities.check_reason(reason)
                self.metrics.inc("capability_degradations_total")
                self.metrics.inc("capability_degradations_total", labels={
                    "axis": "decode", "reason": capabilities.reason_family(reason)})
        if reason is not None:
            self.metrics.inc("fused_decode_fallbacks_total")
            self.metrics.inc("fused_decode_fallbacks_total",
                             labels={"reason": reason})
        active = reason is None
        self.metrics.set_gauge("fused_decode_active", 1 if active else 0)
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
                rng: torch.Generator, st: dict):
        """One step of the sampler chain on logits [B, V]: the bias on the raw
        logits, the raw logits kept for logprobs, the penalties, then
        mirostat or the typical-p / min-p / top-k / top-p chain. ``st``
        holds the device state that rides between steps (``recent``,
        ``mu``, ``bias``; None when off) and is updated in place. Returns
        the next token [B, 1] and, with ``gen.logprobs``, the tuple
        (sampled logprob [B], top values [B, N], top ids [B, N])."""
        if st["bias"] is not None:
            logits = logits + st["bias"].to(logits.dtype)
        raw = logits
        recent = st["recent"]
        if recent is not None:
            logits = apply_penalties(logits, recent, gen.repeat_penalty,
                                     gen.presence_penalty, gen.frequency_penalty)
        if gen.mirostat:
            nxt, st["mu"] = mirostat_step(
                logits, rng, st["mu"], version=gen.mirostat, tau=gen.mirostat_tau,
                eta=gen.mirostat_eta, temperature=gen.temperature)
        else:
            nxt = sample(logits, rng, gen.temperature, gen.top_k, gen.top_p,
                         gen.min_p, gen.typical_p)
        if recent is not None:
            st["recent"] = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
        lp = topk_logprobs(raw, nxt, gen.logprobs) if gen.logprobs is not None else None
        return nxt[:, None], lp

    def _decode_chunk(self, n: int, tok: torch.Tensor, cache: KVCache,
                      gen: GenerationConfig, rng: torch.Generator, st: dict):
        """n forward + sample steps on the device, nothing read back:
        returns the chunk's outputs (its tokens [n, B], and with logprobs
        the stacked logprob tensors [n, B(, N)]) and the last token [B, 1]."""
        toks, lps = [], []
        for _ in range(n):
            logits = self.model(tok, cache)[:, -1]
            self.forwards += 1
            tok, lp = self._sample(logits, gen, rng, st)
            toks.append(tok[:, 0])
            if lp is not None:
                lps.append(lp)
        outs = (torch.stack(toks),)
        if lps:
            outs += tuple(torch.stack(x) for x in zip(*lps))
        return outs, tok

    def _to_host(self, *ts: torch.Tensor):
        """Queue device→host copies of the tensors ``ts``; returns a callable
        that waits for them (one event) and gives their values as lists: one
        list for one tensor, else a tuple of them."""
        if ts[0].device.type != "cuda":
            def read_now():
                vals = tuple(t.tolist() for t in ts)
                return vals[0] if len(vals) == 1 else vals

            return read_now
        hosts = []
        for t in ts:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ready = torch.cuda.Event()
        ready.record()

        def read():
            ready.synchronize()
            vals = tuple(h.tolist() for h in hosts)
            return vals[0] if len(vals) == 1 else vals

        return read

    def generate(self, prompt: str | list[int],
                 gen: GenerationConfig | None = None, *,
                 trace_ctx: dict | None = None) -> Iterator[Event]:
        """Streaming generation: yields log / token / done events. Raises
        ``ValueError`` on a sampler combination the engine does not run.
        A JSON-mode or grammar request takes the constrained path, and
        ``ValueError`` also meets a non-positive ``deadline_ms``. Each
        request gets a trace (``utils/tracing.TRACER``) whose id rides the
        done event; ``trace_ctx`` (a parsed ``X-DLP-Trace`` header) stamps
        the propagated fleet context on it."""
        gen = gen or GenerationConfig()
        if gen.deadline_ms is not None and gen.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, "
                             f"got {gen.deadline_ms}")
        gen = check_sampler(gen)
        if gen.json_mode or gen.grammar:
            return self._generate_constrained(prompt, gen, trace_ctx)
        return self._generate(prompt, gen, trace_ctx)

    def _start_trace(self, trace_ctx: dict | None):
        """A request's lifecycle trace (``NULL_TRACE`` when tracing is off),
        with the propagated fleet context stamped on it."""
        trace = TRACER.start_request(kind="engine", model=self.cfg.arch)
        if trace and trace_ctx and trace_ctx.get("fleet_id"):
            trace.set_context(trace_ctx["fleet_id"], hop=trace_ctx.get("hop", 0),
                              attempt=trace_ctx.get("attempt", 0))
        return trace

    def _seal_trace(self, trace, n_prompt: int, n_gen: int) -> None:
        """The finally of a stream that ended without its done event: an
        ``abort`` (the client left) or, with an exception in flight, an
        ``error``."""
        if trace and not trace.done:
            exc = sys.exc_info()[0]
            trace.finish("abort" if exc in (None, GeneratorExit) else "error",
                         n_prompt=n_prompt, n_gen=n_gen, model=self.cfg.arch)

    def _join_profile(self, trace) -> None:
        """With ``profile_dir``, join the request's profiler run onto its
        trace and cap the runs kept on disk. The join decorates a complete
        request: a malformed trace file must not fail it."""
        if not (trace and self.profile_dir):
            return
        from ..utils.profile_trace import prune_profile_runs

        try:
            trace.join_profile(self.profile_dir)
            prune_profile_runs(self.profile_dir)
        except Exception:  # noqa: BLE001 — diagnostics only
            pass

    def _shift_cache(self, cache: KVCache, keep: int, drop: int) -> None:
        """The context shift of a dense cache (``models.llama.shift_kv``)."""
        shift_kv(cache, keep, drop, cache.length - drop, self.cfg)

    def _generate(self, prompt: str | list[int], gen: GenerationConfig,
                  trace_ctx: dict | None = None) -> Iterator[Event]:
        yield from self._events_on_load
        trace = self._start_trace(trace_ctx)
        # the deadline runs from generation start: this path has no queue
        deadline = (time.monotonic() + gen.deadline_ms / 1000.0
                    if gen.deadline_ms else None)
        try:
            if faults.ACTIVE:
                faults.check("tokenizer_error")
            ids = check_token_ids(list(prompt), self.cfg.vocab_size) \
                if isinstance(prompt, (list, tuple)) else self.tokenizer.encode(prompt)
        except Exception as e:
            trace.finish("error", error=repr(e))
            raise
        n_prompt = len(ids)
        # what the prefix cache keeps when the stream ends, however it ends:
        # the ids fed, the tokens emitted, whether the cache is sound (False
        # while a forward runs, so a crashed one is never reused) and
        # whether a context shift broke the mapping of ids to positions
        fed: list[int] | None = None
        out_tokens: list[int] = []
        n_gen, cache_valid, shifted, cache = 0, False, False, None
        recorded = False   # the request's traffic is in the metrics
        # the per-request profiler session (profile_dir), closed before the
        # trace is sealed so its run is on disk for the join
        prof = contextlib.ExitStack()
        try:
            if n_prompt >= self.max_prompt:
                ids = ids[-(self.max_prompt - 1):]
                yield log(f"prompt truncated to last {len(ids)} tokens "
                          f"(ctx {self.max_seq})")
            # latents cache projected post-rope K: the shift's re-rotation
            # pairs head_dim lanes, which the rank-r mixing destroyed, so no
            # exact shift exists; int8 K codes would need a requantizing pass
            shift_on = (gen.context_shift and not self.kv_quant
                        and self.kv_mode != "latent")
            budget = gen.max_new_tokens if shift_on else \
                max(0, min(gen.max_new_tokens, self.max_seq - len(ids)))
            yield log(f"prompt: {n_prompt} tokens; generating up to {budget} "
                      f"(ctx {self.max_seq}, t={gen.temperature}, top_k={gen.top_k}, "
                      f"top_p={gen.top_p})")
            if budget == 0:
                self.metrics.record_request(n_prompt=len(ids), n_gen=0,
                                            ttft_ms=float("nan"),
                                            tok_s=float("nan"))
                recorded = True
                trace.finish("length", n_prompt=len(ids), n_gen=0,
                             model=self.cfg.arch)
                yield done("generated 0 tokens (no budget)", n_prompt=len(ids),
                           n_gen=0, finish_reason="length", **rid_args(trace))
                return
            rng = torch.Generator(device=self.device)
            rng.manual_seed(gen.seed if gen.seed is not None
                            else time.time_ns() % 2**31)
            # the device state that rides between steps and chunks
            st = {"recent": None, "mu": None, "bias": None}
            if (gen.repeat_penalty != 1.0 or gen.presence_penalty != 0.0
                    or gen.frequency_penalty != 0.0):
                W = max(1, gen.repeat_last_n)
                st["recent"] = torch.tensor([([-1] * W + ids)[-W:]],
                                            dtype=torch.long, device=self.device)
            if gen.logit_bias:
                st["bias"] = bias_vector(gen.logit_bias, self.cfg.vocab_size,
                                         self.device)
            if gen.mirostat:
                st["mu"] = mirostat_init(gen.mirostat_tau, self.device)
            lp_mode = gen.logprobs is not None
            stopper = StopMatcher(tuple(gen.stop)) if gen.stop else None
            sd = StreamDecoder(self.tokenizer)
            eos = self.tokenizer.eos_id

            prof.enter_context(profiler_trace(self.profile_dir))
            if faults.ACTIVE:
                faults.check("prefill_oom")
            t_start = time.monotonic()
            cache, reuse_k = self._take_prefix_cache(ids)
            with compile_entry("engine_prefill") as sc:
                tok, lp = self._sample(self.prefill(ids[reuse_k:], cache), gen,
                                       rng, st)
            if sc.retrace and trace:
                trace.event("xla_recompile", entry=sc.name, compiles=sc.compiles)
            fed, cache_valid = list(ids), True
            first = self._to_host(tok[:, 0], *(lp or ()))()
            first_data = None
            if lp_mode:
                first_data = lp_payload(first[0][0], first[1][0], first[2][0],
                                        first[3][0], gen.logprobs)
                first = first[0]
            ttft = time.monotonic() - t_start
            if trace:
                trace.add_span("prefill", t_start, t_start + ttft,
                               n_prompt=n_prompt, reused=reuse_k)
            if reuse_k:
                self.prefix_hits += 1
                self.prefix_tokens += reuse_k
                self.metrics.inc("prefix_cache_hits_total")
                self.metrics.inc("prefix_cache_tokens_total", reuse_k)
                yield log(f"prefix cache hit: reused KV for {reuse_k} of "
                          f"{n_prompt} prompt tokens")
            yield log(f"prefill: {len(ids)} tokens in {ttft * 1000:.1f} ms (TTFT)")
            t_decode = time.monotonic()

            finish_reason, stopped, stop_matched = "length", False, False

            def take(t: int, data: dict | None):
                """Account one sampled token: returns its token event (or
                None) and sets the stop state. With logprobs every token
                gets an event, even while the decoder holds its bytes
                back."""
                nonlocal n_gen, finish_reason, stopped, stop_matched
                if gen.stop_on_eos and eos is not None and t == eos:
                    finish_reason, stopped = "stop", True
                    return None
                out_tokens.append(t)
                n_gen += 1
                text = sd.feed(t)
                if stopper is not None:
                    text, hit = stopper.feed(text)
                    if hit:
                        finish_reason, stopped, stop_matched = "stop", True, True
                if n_gen >= budget:
                    stopped = True
                return token(text, **(data or {})) if text or data is not None else None

            if deadline is not None and time.monotonic() > deadline:
                # the budget burned in prefill: no sampled token may be
                # emitted past it
                self.metrics.inc("requests_timed_out_total")
                if trace:
                    trace.event("deadline_exceeded", phase="prefill",
                                budget_ms=gen.deadline_ms)
                yield log("deadline exceeded during prefill; stopping")
                finish_reason, stopped = "timeout", True
            else:
                ev = take(first[0], first_data)
                if ev is not None:
                    yield ev
            # (read, n, launch time, cache length) of the chunk in flight
            pending = None
            chunk_i = 0   # consumed decode chunks: the trace's decode[i] spans
            t_rb = 0.0    # the last chunk's readback
            while True:
                if (deadline is not None and not stopped
                        and time.monotonic() > deadline):
                    # the tokens already emitted stand; the chunk in flight
                    # is past the budget and is dropped below
                    self.metrics.inc("requests_timed_out_total")
                    if trace:
                        trace.event("deadline_exceeded", phase="decode",
                                    budget_ms=gen.deadline_ms)
                    yield log("deadline exceeded; stopping")
                    finish_reason, stopped = "timeout", True
                launched = None
                room = budget - n_gen - (pending[1] if pending else 0)
                if (shift_on and not stopped and room > 0 and pending is None
                        and self.max_seq - cache.length < 2):
                    # the context is full and nothing is in flight: drop half
                    # the past after ``keep`` and re-rotate (llama.cpp's
                    # shift); the prefix cache is dropped when the stream ends
                    pos = cache.length
                    keep = max(0, min(gen.keep, pos - 2))
                    drop = max(1, (pos - keep) // 2)
                    cache_valid = False
                    self._shift_cache(cache, keep, drop)
                    cache_valid = shifted = True
                    self.context_shifts += 1
                    if trace:
                        trace.event("context_shift", drop=drop, keep=keep)
                    self.metrics.inc("context_shifts_total")
                    yield log(f"context shift: dropped {drop} cached positions "
                              f"(keep {keep}, {cache.length} remain of ctx "
                              f"{self.max_seq})")
                # a step needs a free position for its token and one more for
                # the token it samples; a chunk the context bounds is a power
                # of two, as the reference's, so both shift at the same
                # position
                ctx_room = self.max_seq - cache.length
                n = min(self.decode_chunk, room, ctx_room)
                if n == ctx_room:
                    n = 1 << (n.bit_length() - 1) if ctx_room >= 2 else 0
                if not stopped and n > 0:
                    cache_valid = False
                    t_launch = time.monotonic()
                    with compile_entry("engine_decode") as sc:
                        outs, tok = self._decode_chunk(n, tok, cache, gen, rng, st)
                    if sc.retrace and trace:
                        trace.event("xla_recompile", entry=sc.name,
                                    compiles=sc.compiles)
                    cache_valid = True
                    launched = (self._to_host(*(o[:, 0] for o in outs)), n,
                                t_launch, cache.length)
                if pending is not None and not stopped:
                    # read the previous chunk while the one just queued runs
                    got = pending[0]()
                    t_detok = time.monotonic()
                    # the chunk's step: from its launch, or from the previous
                    # chunk's readback when it was launched before that, to
                    # its own readback. Chunks overlap (the next is launched
                    # before this one is read), so their steps tile the
                    # stream's wall time instead of counting it twice
                    t_step = max(pending[2], t_rb)
                    t_rb = t_detok
                    if trace:
                        chunk_i += 1
                        trace.add_span(f"decode[{chunk_i}]", t_step, t_detok,
                                       tokens=pending[1])
                    if self.perf:
                        # the step ring (scan_steps: the forwards, one weight
                        # stream each)
                        self.perf.record_step(
                            "engine", t_step, t_detok, rows=1,
                            tokens=pending[1], scan_steps=pending[1],
                            kv_positions=pending[3], kind="decode")
                    toks = got[0] if lp_mode else got
                    for i, t in enumerate(toks):
                        data = (lp_payload(t, got[1][i], got[2][i], got[3][i],
                                           gen.logprobs) if lp_mode else None)
                        ev = take(t, data)
                        if ev is not None:
                            yield ev
                        if stopped:
                            break
                    if trace:
                        trace.add_span("detokenize", t_detok, time.monotonic())
                # once stopped, a chunk still in flight is junk past the stop
                pending = None if stopped else launched
                if pending is None and (stopped or not shift_on or n_gen >= budget):
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
            extra = {"mirostat_mu": float(st["mu"][0])} if gen.mirostat else {}
            self._record_finished(len(ids), n_gen, ttft * 1000, tps,
                                  finish_reason)
            recorded = True
            prof.close()
            if trace:
                self._join_profile(trace)
                trace.finish(finish_reason, n_prompt=len(ids), n_gen=n_gen,
                             ttft_ms=round(ttft * 1000, 3),
                             tok_s=None if tps != tps else round(tps, 2),
                             model=self.cfg.arch)
            yield done(f"generated {n_gen} tokens | TTFT {ttft * 1000:.1f} ms | "
                       f"decode {tps:.2f} tok/s",
                       n_prompt=len(ids), n_gen=n_gen, finish_reason=finish_reason,
                       ttft_ms=ttft * 1000, tok_s=tps, tok_s_e2e=tps_e2e,
                       stop_match=stopper.matched if stopper else None, **extra,
                       **rid_args(trace))
        finally:
            prof.close()
            if not recorded:
                self._record_aborted(len(ids), n_gen)
                self._seal_trace(trace, len(ids), n_gen)
            self._store_prefix(cache, fed, out_tokens, n_gen, cache_valid, shifted)

    def _record_finished(self, n_prompt: int, n_gen: int, ttft_ms: float,
                         tok_s: float, finish_reason: str) -> None:
        """A finished request's traffic and its outcome counters."""
        self.metrics.record_request(n_prompt=n_prompt, n_gen=n_gen,
                                    ttft_ms=ttft_ms, tok_s=tok_s)
        self.metrics.inc(f"requests_finished_{finish_reason}_total")
        self.metrics.inc("requests_finished_total",
                         labels={"model": self.cfg.arch, "outcome": finish_reason})

    def _record_aborted(self, n_prompt: int, n_gen: int) -> None:
        """A stream that ended without its done event (the client left, or
        the forward raised): its traffic still counts."""
        self.metrics.inc("requests_aborted_total")
        self.metrics.inc("prompt_tokens_total", n_prompt)
        self.metrics.inc("generated_tokens_total", n_gen)

    def _store_prefix(self, cache, fed: list[int] | None, out_tokens: list[int],
                      n_gen: int, cache_valid: bool, shifted: bool) -> None:
        """Keep a finished (or aborted) stream's cache as the prefix cache.
        Every emitted token but the newest has been fed, so the cache holds
        the ids fed and the first ``n_gen - 1`` tokens emitted; its length
        is cut there, so KV a chunk wrote past the stop is never reused.
        After a context shift (positions no longer follow the ids), a
        crashed forward, or with caching off, the stored prefix is
        dropped."""
        if shifted:
            self._prefix_ids, self._prefix_cache = [], None
        elif self.prefix_cache_enabled and cache_valid and fed is not None:
            n_fed_gen = max(0, n_gen - 1)
            self._prefix_ids = fed + out_tokens[:n_fed_gen]
            cache.length = len(fed) + n_fed_gen
            self._prefix_cache = cache
        elif not cache_valid or not self.prefix_cache_enabled:
            self._prefix_ids, self._prefix_cache = [], None

    def _take_prefix_cache(self, ids: list[int]) -> tuple[KVCache, int]:
        """A cache to prefill into, and how many prompt tokens it already
        holds: the stored prefix cache when its ids share at least
        ``MIN_PREFIX`` leading tokens with ``ids`` (at least one prompt
        token always runs, for the logits, and the suffix's bucket must fit
        behind the prefix), else a cache of length 0. A miss reuses the
        stored buffers with the length reset (their contents are masked as
        bucket padding is) rather than allocating new ones. The stored
        prefix is consumed either way."""
        stored, cache = self._prefix_ids, self._prefix_cache
        self._prefix_ids, self._prefix_cache = [], None
        if cache is None:
            return self.make_cache(batch=1), 0
        if self.prefix_cache_enabled:
            k = 0
            for a, b in zip(stored, ids):
                if a != b:
                    break
                k += 1
            k = min(k, len(ids) - 1)   # >= 1 suffix token must run for logits
            if k >= MIN_PREFIX and k + _bucket(
                    len(ids) - k, self.max_prompt,
                    quantum=self._prompt_quantum) <= self.max_seq:
                cache.length = k
                return cache, k
        cache.length = 0
        return cache, 0

    # -- constrained decoding (llama.cpp's grammar sampling: JSON mode, its
    # shipped json.gbnf, or a GBNF grammar) --------------------------------

    _JSON_TOPK = 64   # candidate shortlist read back per step

    def _shortlist(self, row: torch.Tensor) -> tuple[list[float], list[int]]:
        """The top ``_JSON_TOPK`` of one step's f32 logits [V], descending,
        values and ids read back in one synchronisation."""
        return self._to_host(*shortlist(row, self._JSON_TOPK))()

    def _generate_constrained(self, prompt: str | list[int], gen: GenerationConfig,
                              trace_ctx: dict | None = None) -> Iterator[Event]:
        """Constrained decoding in llama.cpp's candidates-then-grammar order:
        each step the device proposes its top-K shortlist, and the host keeps
        the candidates whose text extends a valid prefix of the constraint
        (JSON, or a compiled GBNF grammar), renormalizes and samples. The
        full [V] row is read back only when no shortlisted candidate is
        valid (a miss). One host round trip per token, one forward per
        token; generation ends when the constraint is satisfied. The done
        event carries ``constraint_complete`` (and ``json_complete``), the
        readbacks and the misses."""
        yield from self._events_on_load
        trace = self._start_trace(trace_ctx)
        try:
            ids = check_token_ids(list(prompt), self.cfg.vocab_size) \
                if isinstance(prompt, (list, tuple)) else self.tokenizer.encode(prompt)
        except Exception as e:
            trace.finish("error", error=repr(e))
            raise
        tally = {"n_gen": 0, "recorded": False}
        try:
            yield from self._constrained_stream(ids, gen, tally, trace)
        finally:
            if not tally["recorded"]:
                self._record_aborted(len(ids), tally["n_gen"])
                self._seal_trace(trace, len(ids), tally["n_gen"])
            # constrained decoding keeps no prefix: the stored one it may
            # have reused is consumed, and nothing new is stored
            self._prefix_ids, self._prefix_cache = [], None

    def _constrained_stream(self, ids: list[int], gen: GenerationConfig,
                            tally: dict, trace) -> Iterator[Event]:
        """The constrained path's prefill (the prefix cache's stored KV
        reused, as on the unconstrained path) and decode loop. ``tally``
        carries the tokens generated and whether the request was recorded
        out to the caller, which records an abort."""
        from .constrained import ConstrainedSampler

        n_prompt = len(ids)
        if n_prompt >= self.max_prompt:
            ids = ids[-(self.max_prompt - 1):]
            yield log(f"prompt truncated to last {len(ids)} tokens "
                      f"(ctx {self.max_seq})")
        budget = max(0, min(gen.max_new_tokens, self.max_seq - len(ids)))
        kind = "GBNF-grammar" if gen.grammar else "JSON"
        yield log(f"prompt: {n_prompt} tokens; generating up to {budget} "
                  f"{kind}-constrained (t={gen.temperature}, "
                  f"candidates={self._JSON_TOPK})")
        if budget == 0:
            self.metrics.record_request(n_prompt=len(ids), n_gen=0,
                                        ttft_ms=float("nan"), tok_s=float("nan"))
            tally["recorded"] = True
            trace.finish("length", n_prompt=len(ids), n_gen=0, model=self.cfg.arch)
            yield done("generated 0 tokens (no budget)", n_prompt=len(ids),
                       n_gen=0, finish_reason="length", **rid_args(trace))
            return
        sampler = ConstrainedSampler(gen, self.tokenizer.token_bytes,
                                     self.tokenizer.eos_id)
        stopper = StopMatcher(tuple(gen.stop)) if gen.stop else None
        t_start = time.monotonic()
        cache, reuse_k = self._take_prefix_cache(ids)
        row = self.prefill(ids[reuse_k:], cache)[0]
        ttft = time.monotonic() - t_start
        if trace:
            trace.add_span("prefill", t_start, t_start + ttft,
                           n_prompt=n_prompt, reused=reuse_k)
        if reuse_k:
            self.prefix_hits += 1
            self.prefix_tokens += reuse_k
        yield log(f"prefill: {len(ids)} tokens in {ttft * 1000:.1f} ms (TTFT)")
        t_decode = time.monotonic()
        n_gen, finish_reason = 0, "length"
        readbacks = misses = 0
        deadline = (t_start + gen.deadline_ms / 1000.0
                    if gen.deadline_ms else None)

        def full_row(r: torch.Tensor):
            nonlocal readbacks, misses
            readbacks += 1
            misses += 1
            return r.float().cpu().numpy()

        while n_gen < budget:
            if deadline is not None and time.monotonic() > deadline:
                self.metrics.inc("requests_timed_out_total")
                if trace:
                    trace.event("deadline_exceeded", phase="decode",
                                budget_ms=gen.deadline_ms)
                yield log("deadline exceeded; stopping")
                finish_reason = "timeout"
                break
            vals, idx = self._shortlist(row)
            readbacks += 1
            res = sampler.pick(vals, idx, full_logits=lambda r=row: full_row(r),
                               cap=self._JSON_TOPK)
            if res is None:
                # the constraint cannot be extended: an honest length-style
                # end ("stop" would tell clients to parse a truncated prefix)
                yield log("constrained mode: no token extends a valid "
                          "prefix; stopping")
                break
            tok_id, delta = res
            n_gen += 1
            tally["n_gen"] = n_gen
            if delta:   # exactly the validated text, nothing else
                if stopper is not None:
                    emitted, hit = stopper.feed(delta)
                    if emitted:
                        yield token(emitted)
                    if hit:
                        finish_reason = "stop"
                        break
                else:
                    yield token(delta)
            if sampler.complete:
                finish_reason = "stop"
                if stopper is not None:   # release the held-back tail
                    held, _ = stopper.finish("")
                    if held:
                        yield token(held)
                break
            if n_gen >= budget:
                break
            tok = torch.full((1, 1), tok_id, dtype=torch.long, device=self.device)
            row = self.model(tok, cache)[0, -1]
            self.forwards += 1
        if stopper is not None and finish_reason != "stop":
            held, _ = stopper.finish("")
            if held:
                yield token(held)
        dt = time.monotonic() - t_decode
        tps = (n_gen - 1) / dt if n_gen > 1 and dt > 0 else float("nan")
        self._record_finished(len(ids), n_gen, ttft * 1000, tps, finish_reason)
        tally["recorded"] = True
        if trace:
            trace.add_span("decode", t_decode, time.monotonic(), tokens=n_gen)
            trace.finish(finish_reason, n_prompt=len(ids), n_gen=n_gen,
                         ttft_ms=round(ttft * 1000, 3),
                         tok_s=None if tps != tps else round(tps, 2),
                         model=self.cfg.arch)
        yield done(f"generated {n_gen} tokens | TTFT {ttft * 1000:.1f} ms "
                   f"| decode {tps:.2f} tok/s | constraint "
                   f"{'satisfied' if sampler.complete else 'truncated'}",
                   n_prompt=len(ids), n_gen=n_gen, finish_reason=finish_reason,
                   ttft_ms=ttft * 1000, tok_s=tps,
                   json_complete=sampler.complete,
                   constraint_complete=sampler.complete,
                   readbacks=readbacks, shortlist_misses=misses, **rid_args(trace))

    # -- fill-in-middle (llama-server /infill) -----------------------------

    def infill_ids(self, input_prefix: str, input_suffix: str) -> list[int]:
        """The PSM-order fill-in-middle prompt: [bos] <FIM_PRE> prefix
        <FIM_SUF> suffix <FIM_MID>, as llama-server's /infill builds it.
        Raises ``ValueError`` when the vocabulary has no FIM tokens."""
        v = self.tokenizer.vocab
        if v.fim_pre_id is None or v.fim_suf_id is None \
                or v.fim_mid_id is None:
            raise ValueError(
                "this model's vocab has no fill-in-middle tokens "
                "(tokenizer.ggml.prefix/suffix/middle_token_id); /infill "
                "needs a FIM-trained checkpoint")
        pre = self.tokenizer.encode(input_prefix, add_bos=False)
        suf = self.tokenizer.encode(input_suffix, add_bos=False)
        # an oversized context is trimmed before the markers are placed (the
        # prompt's tail truncation would cut <FIM_PRE> / <FIM_SUF>): the
        # prefix's tail and the suffix's head stay, the text nearest the
        # hole, prefix-weighted as llama-server trims
        budget = self.max_prompt - 5   # bos + 3 markers + >= 1 decode margin
        if len(pre) + len(suf) > budget:
            # the suffix gets at most half, then each side takes the share
            # the other leaves unused
            keep_suf = min(len(suf), budget // 2)
            keep_pre = min(len(pre), budget - keep_suf)
            keep_suf = min(len(suf), budget - keep_pre)
            pre = pre[-keep_pre:] if keep_pre else []
            suf = suf[:keep_suf]
        ids: list[int] = []
        if v.add_bos and v.bos_id is not None:
            ids.append(v.bos_id)
        ids.append(v.fim_pre_id)
        ids += pre
        ids.append(v.fim_suf_id)
        ids += suf
        ids.append(v.fim_mid_id)
        return ids

    # -- embeddings (llama-server /embedding) ------------------------------

    def embed(self, text: str, with_count: bool = False, pooling: str = "mean"):
        """The L2-normalized pooled embedding of ``text`` (llama-server's
        ``/embedding``; ``pooling`` as its ``--pooling``: mean, cls or
        last), the prompt cut to ``max_prompt`` tokens. It runs on a dense
        scratch cache of the prompt's bucket, kept per bucket and on every
        KV mode: the prefix cache and the decode state are untouched.
        ``with_count`` also returns the number of tokens evaluated."""
        if pooling not in POOLING_TYPES:
            raise ValueError(f"unsupported pooling {pooling!r} "
                             f"(one of {', '.join(POOLING_TYPES)})")
        ids = self.tokenizer.encode(text)
        if len(ids) > self.max_prompt:
            ids = ids[: self.max_prompt]
        b = _bucket(len(ids), self.max_prompt, quantum=self._prompt_quantum)
        padded = torch.zeros((1, b), dtype=torch.long)
        padded[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        cache = self._embed_caches.get(b)
        if cache is None:
            # dense whatever the KV mode: the scratch serves one pass, so a
            # latent engine's embeddings stay exact, not rank-truncated
            cache = KVCache.zeros(self.cfg, batch=1, max_seq=b, dtype=self.dtype,
                                  device=self.device)
            self._embed_caches[b] = cache
        cache.length = 0   # the last call's contents are masked as padding
        vec = self.model.embed_pooled(padded.to(self.device), cache, len(ids),
                                      pooling)
        self.forwards += 1
        out = vec[0].tolist()
        return (out, len(ids)) if with_count else out

    # -- perplexity (llama-perplexity) -------------------------------------

    @torch.inference_mode()
    def perplexity(self, text: str, chunk: int = 128) -> dict:
        """The perplexity of ``text``: exp of the mean negative log-likelihood
        of each token given the ones before it, run in ``chunk``-token
        forwards through a dense cache so the logits stay [1, chunk, V].
        A text longer than the context is scored in independent
        ``max_seq``-token windows (llama-perplexity's non-overlapping
        default). Returns {"ppl", "nll", "n_tokens"}."""
        ids = self.tokenizer.encode(text)
        if len(ids) < 2:
            raise ValueError("perplexity needs at least 2 tokens")
        # the cache's capacity rounded up to a chunk multiple: the last
        # (padded) chunk's KV write then ends at the capacity instead of
        # running past it (the reference's update would clamp its start into
        # earlier positions and corrupt the window's KV; a slice write here
        # would fail)
        cap = -(-self.max_seq // chunk) * chunk
        cache = KVCache.zeros(self.cfg, batch=1, max_seq=cap, dtype=self.dtype,
                              device=self.device)
        nlls, total_n = [], 0
        for w0 in range(0, len(ids) - 1, self.max_seq):
            window = ids[w0: w0 + self.max_seq + 1]
            if len(window) < 2:
                break
            cache.length = 0
            # positions [0, n - 1) predict [1, n); a window's first token
            # is conditioned on nothing and never scored
            for c0 in range(0, len(window) - 1, chunk):
                piece = window[c0: c0 + chunk]
                tgt = window[c0 + 1: c0 + 1 + len(piece)]
                toks = torch.zeros((1, chunk), dtype=torch.long)
                toks[0, : len(piece)] = torch.tensor(piece, dtype=torch.long)
                logits = self.model(toks.to(self.device), cache, dense_kv=True)
                self.forwards += 1
                lp = torch.log_softmax(logits[0, : len(tgt)].float(), dim=-1)
                t = torch.tensor(tgt, dtype=torch.long, device=self.device)
                nlls.append(-lp.gather(-1, t[:, None]).sum())
                total_n += len(tgt)
        # each chunk's sum in f32, the total over chunks in f64, as the
        # reference adds its chunks' sums on the host
        total_nll = sum(torch.stack(nlls).tolist())
        return {"ppl": float(np.exp(total_nll / max(1, total_n))),
                "nll": total_nll, "n_tokens": total_n}

    # -- sessions (llama-cli --prompt-cache: the prefix cache on disk) -----

    def save_session(self, path: str | Path) -> bool:
        """Write the prefix cache and its token ids to ``path``; False when
        there is nothing to save."""
        if self._prefix_cache is None or not self._prefix_ids:
            return False
        c = self._prefix_cache
        save_kv_file(path, self._prefix_ids, c, int(c.length))
        return True

    def load_session(self, path: str | Path) -> int:
        """Load a saved session as the prefix cache. Returns the number of
        tokens it holds, 0 when the file does not match this engine (another
        model, context or KV layout), which is then ignored."""
        res = load_kv_file(path, self.make_cache(batch=1), self.max_seq)
        if res is None:
            return 0
        self._prefix_cache, self._prefix_ids = res
        return len(self._prefix_ids)

    def erase_session(self) -> None:
        """Drop the prefix cache (``POST /slots/0?action=erase``)."""
        self._prefix_ids, self._prefix_cache = [], None

    # -- batch generation (n > 1, a list of prompts) -----------------------

    def _batch_prefill(self, tokens: np.ndarray, lengths: np.ndarray,
                       ) -> tuple[torch.Tensor, KVCache]:
        """(tokens [B, bucket], true lengths [B]) → (each row's logits at its
        own last prompt position [B, V], a cache of B rows whose per-row
        lengths are ``lengths``)."""
        cache = self.make_cache(batch=tokens.shape[0])
        dev = self.device
        last = self.model.forward_rows_last(
            torch.from_numpy(tokens).long().to(dev), cache,
            torch.from_numpy(lengths - 1).to(dev))
        self.forwards += 1
        cache.length = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        return last, cache

    def _batch_step(self, tok: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One decode step of every row, each at its own length: tok [B] →
        logits [B, V]."""
        self.forwards += 1
        return self.model(tok[:, None], cache)[:, -1]

    @torch.inference_mode()
    def generate_batch(self, prompts: list[str],
                       gen: GenerationConfig | None = None) -> list[dict]:
        """Generate for several prompts at once (``n`` > 1, a list of
        prompts): one cache of a row per prompt, each row at its own length,
        every step one batched forward. Each row samples as ``generate``
        would, from a generator of its own; a row past its EOS or budget
        keeps computing junk that is discarded until the whole batch ends.
        Returns one dict per prompt: text, n_prompt, n_gen, finish_reason."""
        gen = gen or GenerationConfig()
        if gen.json_mode or gen.grammar:
            raise ValueError(
                "constrained sampling (json mode / GBNF grammar) is a "
                "single-stream feature (per-token candidate filtering); "
                "batched/n>1 requests cannot use it")
        if gen.logprobs is not None:
            raise ValueError(
                "logprobs is a single-stream feature; batched/n>1 requests "
                "cannot use it")
        if gen.mirostat and gen.temperature > 0.0:
            raise ValueError(
                "mirostat is a single-stream feature (per-request adaptive "
                "μ state); batched/n>1 requests cannot use it")
        B = len(prompts)
        if B == 0:
            return []
        # release the stored prefix before allocating the batch's rows
        self._prefix_ids, self._prefix_cache = [], None
        ids_list = []
        for p in prompts:
            ids = self.tokenizer.encode(p)
            if len(ids) >= self.max_prompt:
                ids = ids[-(self.max_prompt - 1):]
            ids_list.append(ids)
        lengths = np.array([len(i) for i in ids_list], np.int64)
        budgets = np.minimum(gen.max_new_tokens, self.max_seq - lengths)
        bucket = _bucket(int(lengths.max()), self.max_prompt,
                         quantum=self._prompt_quantum)
        tokens = np.zeros((B, bucket), np.int64)
        for r, ids in enumerate(ids_list):
            tokens[r, :len(ids)] = ids
        dev = self.device

        t_start = time.monotonic()
        last, cache = self._batch_prefill(tokens, lengths)
        penalized = (gen.repeat_penalty != 1.0 or gen.presence_penalty != 0.0
                     or gen.frequency_penalty != 0.0)
        W = max(1, gen.repeat_last_n)
        recent = None
        if penalized:
            win = np.full((B, W), -1, np.int64)
            for r, ids in enumerate(ids_list):
                w = min(W, len(ids))
                win[r, W - w:] = ids[-w:]
            recent = torch.from_numpy(win).to(dev)
        bias = (bias_vector(gen.logit_bias, self.cfg.vocab_size, dev)
                if gen.logit_bias else None)
        sampled = gen.temperature > 0.0
        gens: list[torch.Generator | None] = [None] * B
        if sampled:
            # one generator a row, seeded from the request's seed: the rows
            # of n > 1 over one prompt draw different samples
            seeder = torch.Generator().manual_seed(
                gen.seed if gen.seed is not None else time.time_ns() % 2**31)
            for r, s in enumerate(torch.randint(0, 2**62, (B,), generator=seeder)):
                gens[r] = torch.Generator(device=dev)
                gens[r].manual_seed(int(s))
        params = [torch.full((B,), v, dtype=dt, device=dev) for v, dt in (
            (gen.temperature, torch.float32), (gen.top_k, torch.long),
            (gen.top_p, torch.float32), (gen.min_p, torch.float32))]

        def draw(lg: torch.Tensor) -> torch.Tensor:
            nonlocal recent
            if bias is not None:
                lg = lg + bias.to(lg.dtype)
            if penalized:
                lg = apply_penalties(lg, recent, gen.repeat_penalty,
                                     gen.presence_penalty, gen.frequency_penalty)
            if not sampled:
                nxt = torch.argmax(lg, dim=-1)
            elif gen.typical_p < 1.0:
                # typical-p is not in the batched row chain: each row runs
                # the single-stream chain on its own generator
                nxt = torch.cat([sample(lg[r:r + 1], gens[r], gen.temperature,
                                        gen.top_k, gen.top_p, gen.min_p,
                                        gen.typical_p) for r in range(B)])
            else:
                nxt = sample_rows(lg, *params, gens)
            if penalized:
                recent = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
            return nxt

        tok = draw(last)
        eos = self.tokenizer.eos_id
        decoders = [StreamDecoder(self.tokenizer) for _ in range(B)]
        texts: list[list[str]] = [[] for _ in range(B)]
        n_gen = np.zeros(B, np.int64)
        finish = ["length"] * B
        active = budgets > 0

        def consume(row_toks: list[int]) -> bool:
            """One sampled token per active row through the EOS and budget
            checks; True while any row is still active."""
            for r in np.nonzero(active)[0]:
                t = int(row_toks[r])
                if gen.stop_on_eos and eos is not None and t == eos:
                    active[r] = False
                    finish[r] = "stop"
                    continue
                piece = decoders[r].feed(t)
                n_gen[r] += 1
                if piece:
                    texts[r].append(piece)
                if n_gen[r] >= budgets[r]:
                    active[r] = False
            return bool(active.any())

        alive = consume(tok.tolist())
        while alive:
            # n decode steps with on-device sampling, read back once
            room = int((budgets - n_gen)[active].max())
            n = min(self.decode_chunk, max(1, room))
            n = 1 << (n.bit_length() - 1)
            steps = []
            for _ in range(n):
                tok = draw(self._batch_step(tok, cache))
                steps.append(tok)
            for step_toks in torch.stack(steps).tolist():
                alive = consume(step_toks)
                if not alive:
                    break

        def final_text(r: int) -> tuple[str, str]:
            text = "".join(texts[r]) + decoders[r].flush()
            cuts = [i for i in (text.find(s) for s in gen.stop if s) if i >= 0]
            if cuts:   # a batch returns whole texts: cut at the stop
                return text[: min(cuts)], "stop"
            return text, finish[r]

        dt = time.monotonic() - t_start
        total = int(n_gen.sum())
        self.metrics.inc("requests_total", B)
        self.metrics.inc("prompt_tokens_total", int(lengths.sum()))
        self.metrics.inc("generated_tokens_total", total)
        if dt > 0 and total:
            self.metrics.observe("batch_tok_s", total / dt)
        finals = [final_text(r) for r in range(B)]
        return [{"text": finals[r][0], "n_prompt": int(lengths[r]),
                 "n_gen": int(n_gen[r]), "finish_reason": finals[r][1]}
                for r in range(B)]
