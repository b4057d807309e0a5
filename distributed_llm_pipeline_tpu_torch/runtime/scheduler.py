"""Continuous batching over parallel decode slots (``--parallel N``).

The counterpart of ``distributed_llm_pipeline_tpu/runtime/scheduler.py`` on
the single-device paged path: llama-server's ``-np N``, where concurrent
requests share one batched decode step. The batch is a fixed ``[n_slots]``
row dimension over one paged, ref-counted KV block pool
(``runtime/paged.py``):

- a request joins at the next chunk boundary. Its prompt prefill runs over
  the suffix the pool does not already hold: prompts that share full
  blocks with a resident slot share those physical blocks.
- a prompt suffix longer than ``prefill_chunk`` is fed as bounded chunks
  interleaved with the other rows' decode steps (the *mixed* step: a
  ``[B, prefill_chunk]`` token block in which each decode row carries one
  real token). Its last sub-chunk runs the ordinary bounded prefill, so
  chunked and unchunked admission give the same greedy output.
- with no prefill in flight, decode runs in chunks of up to
  ``decode_chunk`` steps with one host readback per chunk. The next chunk
  is queued before the previous one is read back; the next input token
  stays on the device, so host state is one chunk behind, as in the
  reference.

Each row has its own sampling parameters, its own generator and its own
row of the logit-bias matrix, so a seeded request's tokens do not depend on
its co-tenants. When any row asks for logprobs, every step also computes
the top ``LP_TOPK`` logprobs of each row's raw distribution, read back with
the step's tokens. Free rows compute
junk that is discarded; their writes are parked at ``max_seq``.

A constrained row (JSON mode or a GBNF grammar) picks its tokens on the
host (``runtime/constrained.py``): while one runs, every step also returns
the top ``CS_TOPK`` of each row's raw logits, and the loop runs serially,
one step a launch, each read back before the next is queued, so the host's
pick can replace the row's device token before the next step feeds it.
Its full [V] row is read back only when the shortlist holds no valid
candidate. Free rows keep decoding in the same batch.

The engine builds the backend that holds the rows (``Engine.slot_backend``):
over a :class:`ShardedEngine` (``--mesh``) they are dense pipeline-cache
rows on every rank instead (``parallel.engine.MeshSlotBackend``): a mixed
step is one pipeline chunk wide, and a row keeps its own retained prefix in
place.

A slot's retained KV is saved to, restored from and erased as the
engine's session files (``save_slot``, ``restore_slot``, ``erase_slot``,
llama-server's ``POST /slots/{id}``). They run on the worker thread
between steps (``_control``); a restored row's blocks join the prefix
index, so a prompt that extends its ids prefills only the suffix.

Not ported yet (the reference has them): preemption and the swap store, the
disaggregation handoff, the watchdog, poison/quarantine, load shedding,
tenants and quotas, metrics and tracing, the single-device dense slot
backend, and slot files on a mesh. Typical-p, mirostat and the context
shift stay on the single-stream engine, as in the reference: a request
that would run one is refused here.

The worker thread owns every device buffer and all slot state; it runs
under ``torch.inference_mode()`` and on the engine's device, both of which
are thread-local.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..ops.sampling import (apply_penalties, bias_vector, lp_payload, sample_rows,
                            shortlist, topk_logprobs)
from ..tokenizer import StreamDecoder
from ..utils import Event, done, log, token
from .engine import (MIN_PREFIX, Engine, GenerationConfig, StopMatcher, _bucket,
                     check_constraint_combination, check_token_ids)
from .paged import PoolExhausted, upload

RECENT_W = 64    # repeat-penalty window capacity per slot (llama.cpp default)
LP_TOPK = 20     # alternatives computed per step when any row wants logprobs
CS_TOPK = 512    # the device top-K of a constrained row read back per step;
                 # its full [V] row is fetched only when all of it misses

# per-row sampling parameters, one row each of the [8, B] parameter array
_TEMP, _TOP_K, _TOP_P, _MIN_P, _PEN, _PRES, _FREQ, _LAST_N = range(8)


class QueueFull(RuntimeError):
    """Admission refused: the wait queue is at capacity."""


@dataclass
class _Request:
    prompt: str | list[int]
    gen: GenerationConfig
    emit: Callable[[Event], None]
    abort: threading.Event
    submitted: float = field(default_factory=time.monotonic)


def _edf_key(req: _Request) -> tuple[float]:
    """The scheduling order of slot grants and of prefill chunk budgets.
    The reference orders by priority class, then earliest deadline, then
    submission time; the port's GenerationConfig has neither a class nor a
    deadline yet, so the order is submission time."""
    return (req.submitted,)


class _DeadlineQueue:
    """The admission queue: ``get_nowait`` pops the request with the
    smallest ``_edf_key``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._heap: list[tuple[tuple, int, _Request]] = []
        self._seq = 0  # heap tiebreak: _Request is not orderable

    def put(self, req: _Request) -> None:
        with self._lock:
            self._seq += 1
            heapq.heappush(self._heap, (_edf_key(req), self._seq, req))

    def get_nowait(self) -> _Request:
        with self._lock:
            if not self._heap:
                raise queue.Empty
            return heapq.heappop(self._heap)[2]

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = ("idx", "serial", "req", "decoder", "stopper", "ids", "n_gen",
                 "budget", "finish", "t_start", "t_decode", "ttft_ms",
                 "stopped", "stop_matched", "out_ids", "starved", "phase",
                 "pending", "prefix_k", "n_prompt", "sampler", "readbacks",
                 "misses")

    def __init__(self, idx: int, serial: int, req: _Request):
        self.idx = idx
        self.serial = serial
        self.req = req
        self.ids: list[int] = []
        self.n_gen = 0
        self.budget = 0
        # "prefill" rows feed ``pending`` prompt tokens through mixed
        # steps; "decode" rows sample
        self.phase = "decode"
        self.pending: list[int] = []
        self.prefix_k = 0   # prefix-cache reuse at admission
        self.n_prompt = 0   # prompt length before truncation
        self.out_ids: list[int] = []
        self.finish = "length"
        self.stopped = False
        self.stop_matched = False
        self.starved = False  # pool exhausted: finish after the in-flight
        #                       chunk's tokens are consumed
        self.decoder: StreamDecoder | None = None
        self.stopper: StopMatcher | None = None
        self.t_start = 0.0
        self.t_decode = 0.0
        self.ttft_ms = float("nan")
        self.sampler = None   # the ConstrainedSampler of a JSON / GBNF row
        self.readbacks = 0    # a constrained row's host reads: one a token,
        self.misses = 0       # and one more per full-row fetch (a miss)


def _row_param_array(gens: list[GenerationConfig | None]) -> np.ndarray:
    """The [8, B] per-row parameter array; rows without a request (None)
    get neutral values: greedy, no filter, no penalty."""
    p = np.zeros((8, len(gens)), np.float32)
    p[_TOP_P] = p[_PEN] = p[_LAST_N] = 1.0
    for r, g in enumerate(gens):
        if g is not None:
            p[:, r] = (g.temperature, g.top_k, g.top_p, g.min_p,
                       g.repeat_penalty, g.presence_penalty,
                       g.frequency_penalty,
                       min(RECENT_W, max(1, g.repeat_last_n)))
    return p


def _penalized(g: GenerationConfig) -> bool:
    return (g.repeat_penalty != 1.0 or g.presence_penalty != 0.0
            or g.frequency_penalty != 0.0)


def _sample_chain(lg: torch.Tensor, recent: torch.Tensor,
                  params: torch.Tensor | None, penalized: bool,
                  gens: list[torch.Generator | None],
                  bias: torch.Tensor | None = None, lp: bool = False,
                  cs: bool = False,
                  ) -> tuple[torch.Tensor, torch.Tensor, tuple | None, tuple | None]:
    """The per-step batched sampling chain, shared by decode chunks, mixed
    steps and the first token: the per-row bias ([B, V], None when no row
    is biased), penalties over each row's recent window, then the per-row
    sampler. logits [B, V] → (next tokens [B], the recent windows shifted
    by them, with ``lp`` the raw distribution's logprobs: the sampled
    token's [B], the top ``LP_TOPK`` values and ids [B, LP_TOPK], and with
    ``cs`` the constrained rows' shortlist: the top ``CS_TOPK`` values and
    ids of the raw f32 logits and the raw rows [B, V] themselves, which
    stay on the device). ``params`` ([8, B] on the device) may be None when
    no row is penalized or sampled."""
    if bias is not None:
        lg = lg + bias.to(lg.dtype)
    raw = lg
    if penalized:
        W = recent.shape[1]
        last_n = params[_LAST_N].long()
        rc = torch.where(torch.arange(W, device=lg.device)[None, :]
                         >= W - last_n[:, None], recent, -1)
        lg = apply_penalties(lg, rc, params[_PEN][:, None],
                             params[_PRES][:, None], params[_FREQ][:, None])
    if any(g is not None for g in gens):
        nxt = sample_rows(lg, params[_TEMP], params[_TOP_K], params[_TOP_P],
                          params[_MIN_P], gens)
    else:   # every row greedy: the sorted-first token is the argmax
        nxt = torch.argmax(lg, dim=-1)
    lps = topk_logprobs(raw, nxt, LP_TOPK) if lp else None
    cso = None
    if cs:
        rawf = raw.float()
        cso = (*shortlist(rawf, CS_TOPK), rawf)
    return nxt, torch.cat([recent[:, 1:], nxt[:, None]], dim=1), lps, cso


class SlotScheduler:
    """N parallel decode slots over one single-device :class:`Engine` (a
    paged pool) or a :class:`ShardedEngine` (dense rows on every rank).

    ``generate(prompt, gen)`` has the event contract of ``Engine.generate``
    and is safe to call from many threads at once: each concurrent request
    streams from its own call while all of them decode in one batched step.
    """

    def __init__(self, engine: Engine, n_slots: int = 4,
                 decode_chunk: int | None = None, max_queue: int = 64,
                 kv_block: int | None = None,
                 kv_pool_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 prefill_chunked: bool | None = None):
        if n_slots < 2:
            raise ValueError("--parallel needs at least 2 slots")
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.n_slots = int(n_slots)
        self.max_seq = engine.max_seq
        self.max_queue = max_queue
        self.decode_chunk = int(decode_chunk or engine.decode_chunk or 32)
        # the engine's KV representation (int8 codes under kv_quant, rank-r
        # latents under kv_mode "latent") sizes the pool; the backend asks
        # the engine once whether decode steps run the fused kernel
        self.kv_quant = engine.kv_quant
        self.kv_mode = engine.kv_mode
        self.kv_latent_rank = engine.kv_latent_rank
        self._backend = engine.slot_backend(self.n_slots, self.max_seq,
                                            block_size=kv_block,
                                            n_blocks=kv_pool_blocks)
        self.fused_decode = self._backend.fused
        # the chunk width is also the mixed step's fixed lane count, and the
        # finishing sub-chunk reuses the pow2 prompt buckets
        pc = int(prefill_chunk if prefill_chunk is not None
                 else os.environ.get("DLP_PREFILL_CHUNK", "64"))
        if pc < 16 or pc & (pc - 1):
            raise ValueError(f"prefill_chunk must be a power of two >= 16, "
                             f"got {pc}")
        pc = min(pc, getattr(self._backend, "max_mixed_width", pc))
        self.prefill_chunk = min(pc, self.max_seq)
        if prefill_chunked is None:
            prefill_chunked = os.environ.get("DLP_PREFILL_CHUNKED", "1") != "0"
        self.prefill_chunked = bool(prefill_chunked)
        # the counts the tests and chip_smoke.py read, under the
        # reference's metric names
        self.counters = dict.fromkeys(
            ("prefill_tokens_total", "paged_prefix_hits_total",
             "paged_prefix_tokens_total", "prefill_steps_stolen_total",
             "kv_cow_copies_total"), 0)
        self.forwards = 0   # paged model forwards (each runs every layer)
        self._alloc_state()
        self._slots: list[_Slot | None] = [None] * self.n_slots
        self._serial = 0
        self._subq = _DeadlineQueue()
        # operations run on the worker thread between steps (slot files)
        self._ctlq: queue.Queue[tuple[Callable[[], Any], queue.Queue]] = queue.Queue()
        self._closed = threading.Event()
        self._wake = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="slot-scheduler")
        self._worker.start()

    def _alloc_state(self) -> None:
        """(Re)allocate the pool and the per-row device chains: one
        definition for boot and for recovery after a device error."""
        B = self.n_slots
        self._bufs = self._backend.alloc()
        # per-slot KV provenance: the token ids whose KV each row still
        # holds after its request finished (the per-slot prefix cache)
        self._row_ids: list[list[int]] = [[] for _ in range(B)]
        self._pos = np.zeros(B, np.int64)          # valid KV rows (host truth)
        # the next token and the recent window of each row live on the
        # device between chunks: the next chunk launches before the previous
        # one is read back, so a host copy would be one chunk stale
        self._tok_dev = torch.zeros(B, dtype=torch.long, device=self.device)
        self._recent_dev = torch.full((B, RECENT_W), -1, dtype=torch.long,
                                      device=self.device)
        self._gens: list[torch.Generator | None] = [None] * B
        # the per-row logit-bias matrix [B, V], made on the first biased
        # request; a row is set when its request arms and zeroed when an
        # unbiased one takes it (``_bias_rows``: the rows not all zero)
        self._bias_dev: torch.Tensor | None = None
        self._bias_rows: set[int] = set()

    # -- public API ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._subq.qsize()

    @property
    def slots_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def submit(self, prompt: str | list[int],
               gen: GenerationConfig | None = None, *,
               emit: Callable[[Event], None],
               abort: threading.Event | None = None) -> _Request:
        """Enqueue a request; its events flow through ``emit`` (called from
        the scheduler thread). Raises when the scheduler is closed or the
        wait queue is full, on a token id outside the vocabulary, and
        (``ValueError``) on a sampler the slots do not run: typical-p or
        mirostat on a sampled request, a constraint with another
        constraint, logprobs, a penalty or a bias, a context shift, more
        than ``LP_TOPK`` logprobs."""
        if self._closed.is_set():
            raise RuntimeError("scheduler is closed")
        if isinstance(prompt, (list, tuple)):
            check_token_ids(prompt, self.cfg.vocab_size)
        g = gen or GenerationConfig()
        if g.temperature > 0.0 and (g.mirostat or g.typical_p < 1.0):
            raise ValueError(
                "mirostat / typical_p are single-stream features (per-request "
                "adaptive state / entropy filtering are not in the batched "
                "row sampler); send them through the engine path")
        check_constraint_combination(g)
        if g.context_shift:
            raise ValueError("context shift is a single-stream feature "
                             "(per-row shifted windows are not supported); "
                             "use the engine path")
        if g.logprobs is not None and g.logprobs > LP_TOPK:
            raise ValueError(f"logprobs alternatives capped at {LP_TOPK} "
                             f"on the parallel-slot path")
        if self._subq.qsize() >= self.max_queue:
            raise QueueFull(f"request queue full ({self.max_queue})")
        req = _Request(prompt, gen or GenerationConfig(), emit,
                       abort or threading.Event())
        self._subq.put(req)
        if self._closed.is_set():
            # close() may have drained the queue between the check and the
            # put: drain again so this request still gets its terminal event
            self._drain_queue("scheduler closed")
        self._wake.set()
        return req

    def generate(self, prompt: str | list[int],
                 gen: GenerationConfig | None = None) -> Iterator[Event]:
        """Blocking per-request event stream, safe from any thread. Closing
        the generator aborts the request at the next chunk boundary."""
        q: queue.Queue[Event] = queue.Queue()
        abort = threading.Event()
        self.submit(prompt, gen, emit=q.put, abort=abort)
        try:
            while True:
                ev = q.get()
                yield ev
                if ev.kind == "done":
                    return
        finally:
            abort.set()

    def slot_states(self) -> list[dict]:
        """llama-server's ``GET /slots`` shape: one dict per slot."""
        out = []
        for i, s in enumerate(self._slots):
            if s is None:
                out.append({"id": i, "state": "idle", "n_decoded": 0})
            else:
                out.append({"id": i, "state": "processing", "n_decoded": s.n_gen,
                            "n_prompt": len(s.ids),
                            "params": {"temperature": s.req.gen.temperature,
                                       "top_k": s.req.gen.top_k,
                                       "top_p": s.req.gen.top_p,
                                       "n_predict": s.req.gen.max_new_tokens}})
        return out

    def generate_text(self, prompt: str | list[int],
                      gen: GenerationConfig | None = None) -> str:
        return "".join(e.content for e in self.generate(prompt, gen)
                       if e.kind == "token")

    def close(self) -> None:
        self._closed.set()
        self._wake.set()
        self._worker.join(timeout=30)

    # -- worker loop --------------------------------------------------------

    def _loop(self) -> None:
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with torch.inference_mode(), ctx:
            pending: tuple | None = None
            while not self._closed.is_set():
                try:
                    self._run_controls()
                    self._sweep_starved()
                    self._finish_prefills()
                    self._admit()
                    running, prefilling = self._active_rows()
                    if any(self._slots[r].sampler is not None for r, _ in running):
                        # a constrained row's next token is the host's pick
                        # from this step's shortlist: no launch overlaps a
                        # readback while one runs
                        if pending is not None:
                            self._consume(*pending)
                            pending = None
                            # consuming may have finished rows
                            running, prefilling = self._active_rows()
                        if running or prefilling:
                            launched = self._launch_any(running, prefilling)
                            if launched is not None:
                                self._consume(*launched)
                        continue
                    launched = None
                    if running or prefilling:
                        launched = self._launch_any(running, prefilling)
                    # read the previous chunk while the one just queued runs
                    if pending is not None:
                        self._consume(*pending)
                    pending = launched
                    if pending is None and not running and not prefilling:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                except Exception as e:
                    # a device or runtime failure must not kill the worker:
                    # every blocked consumer would hang. Fail the in-flight
                    # requests with terminal events and rebuild the device
                    # state
                    pending = None
                    self._fail_all(e)
            self._drain_queue("scheduler closed")
            self._drain_controls("scheduler closed")
            for s in self._slots:
                if s is not None:
                    self._finish(s, "error", note="scheduler closed")

    # -- operations on the worker thread ------------------------------------

    def _run_controls(self) -> None:
        while True:
            try:
                fn, out = self._ctlq.get_nowait()
            except queue.Empty:
                return
            try:
                out.put(("ok", fn()))
            except Exception as e:   # relayed to the blocked caller, who raises it
                out.put(("err", e))

    def _drain_controls(self, reason: str) -> None:
        """Fail every queued operation at once: nothing runs them after the
        worker exits."""
        while True:
            try:
                _, out = self._ctlq.get_nowait()
            except queue.Empty:
                return
            out.put(("err", RuntimeError(reason)))

    def _control(self, fn: Callable[[], Any], timeout: float = 120.0):
        """Run ``fn`` on the worker thread between steps and return its
        result; raises whatever ``fn`` raised."""
        if threading.current_thread() is self._worker:
            return fn()
        if self._closed.is_set():
            raise RuntimeError("scheduler is closed")
        out: queue.Queue = queue.Queue()
        self._ctlq.put((fn, out))
        self._wake.set()
        if self._closed.is_set():
            # close() may have passed its last drain between the check and
            # the put: drain again, so the caller fails now, not at timeout
            self._drain_controls("scheduler closed")
        try:
            status, val = out.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("scheduler control operation timed out") from None
        if status == "err":
            raise val
        return val

    # -- slot files (llama-server POST /slots/{id}?action=...) --------------

    def _check_slot_files(self, slot_id: int) -> None:
        if not hasattr(self._backend, "gather"):
            raise NotImplementedError("slot save/restore/erase on a mesh "
                                      "(--mesh) is not ported yet")
        if not 0 <= slot_id < self.n_slots:
            raise ValueError(f"slot id {slot_id} out of range "
                             f"(0..{self.n_slots - 1})")

    def save_slot(self, slot_id: int, path) -> int:
        """Write slot ``slot_id``'s retained KV and its token ids to ``path``
        in the engine's session format (slot files and ``--prompt-cache``
        files are interchangeable). Returns the tokens saved, 0 when the
        slot retains nothing; raises ``RuntimeError`` while the slot is
        busy."""
        self._check_slot_files(slot_id)

        def do() -> int:
            if self._slots[slot_id] is not None:
                raise RuntimeError(f"slot {slot_id} is busy (processing); "
                                   "save it between requests")
            ids = self._row_ids[slot_id]
            if not ids:
                return 0
            from .engine import save_kv_file

            save_kv_file(path, ids, self._backend.gather(self._bufs, slot_id),
                         len(ids))
            return len(ids)

        return self._control(do)

    def restore_slot(self, slot_id: int, path) -> int:
        """Load a saved KV file into idle slot ``slot_id``. Returns the
        tokens restored, 0 when the file does not match this engine's
        layout. A prompt that extends those ids prefills only its suffix."""
        self._check_slot_files(slot_id)

        def do() -> int:
            if self._slots[slot_id] is not None:
                raise RuntimeError(f"slot {slot_id} is busy (processing); "
                                   "restore it between requests")
            from .engine import load_kv_file

            res = load_kv_file(path, self._backend.row_cache(), self.max_seq)
            if res is None:
                return 0
            rc, ids = res
            # the row's provenance goes before adopt_row releases its blocks:
            # should the adoption fail, no stale ids claim KV that is gone
            self._row_ids[slot_id] = []
            self._bufs = self._backend.adopt_row(self, self._bufs, rc, slot_id,
                                                 len(ids))
            self._backend.register_prefix(slot_id, ids)
            self._row_ids[slot_id] = ids
            return len(ids)

        return self._control(do)

    def erase_slot(self, slot_id: int) -> None:
        """Drop idle slot ``slot_id``'s retained prefix."""
        self._check_slot_files(slot_id)

        def do() -> None:
            if self._slots[slot_id] is not None:
                raise RuntimeError(f"slot {slot_id} is busy (processing)")
            self._row_ids[slot_id] = []
            self._backend.release_row(slot_id)

        self._control(do)

    def _active_rows(self) -> tuple[list[tuple[int, int]], list[_Slot]]:
        """(decode rows, prefill-phase slots) eligible for the next launch.
        Decode rows whose optimistic position reached max_seq can produce no
        further valid tokens (their stopping chunk is in flight)."""
        running = [(s.idx, s.serial) for s in self._slots
                   if s is not None and not s.stopped and not s.starved
                   and s.phase == "decode" and self._pos[s.idx] < self.max_seq]
        prefilling = [s for s in self._slots
                      if s is not None and not s.stopped and not s.starved
                      and s.phase == "prefill"]
        return running, prefilling

    def _launch_any(self, running: list[tuple[int, int]],
                    prefilling: list[_Slot]):
        """Any row in prefill phase forces the mixed step; otherwise decode
        runs as a chunk."""
        if prefilling:
            return self._launch_mixed(running, prefilling)
        return self._launch(running)

    def _finish_prefills(self) -> None:
        """Run the finishing sub-chunk for every prefill-phase row whose
        remaining suffix fits one chunk-bounded bucket. A mixed step still in
        flight was queued earlier on the same stream, so its KV writes come
        first."""
        for slot in list(self._slots):
            if (slot is not None and slot.phase == "prefill"
                    and not slot.stopped and not slot.starved
                    and len(slot.pending) <= self.prefill_chunk):
                self._finish_prefill(slot)

    def _finish_prefill(self, slot: _Slot) -> None:
        """Chunked prefill's final sub-chunk: the remaining suffix runs the
        bounded-bucket prefill with the fed tokens as the reused prefix,
        then the row samples its first token on the unchunked path."""
        r = slot.idx
        fill = len(slot.ids) - len(slot.pending)
        try:
            logits, fill = self._backend.prefill_row(self, r, slot.ids, fill)
        except PoolExhausted as e:
            # no pool room for the suffix bucket: the server is overloaded
            self._finish(slot, "error", note=f"engine error: {e!r}")
            return
        self._pos[r] = len(slot.ids)
        self._first_token(slot, logits, slot.prefix_k, slot.n_prompt)

    def _sweep_starved(self) -> None:
        """Finish pool-starved slots. Runs at the top of the loop, after the
        chunk in flight when the slot was marked has been read back, so its
        last tokens were delivered."""
        for slot in list(self._slots):
            if slot is None or not slot.starved or slot.stopped:
                continue
            if slot.phase == "prefill":
                # nothing was sampled: a "length" finish would present an
                # empty completion as a success
                self._finish(slot, "error",
                             note="kv block pool exhausted during prefill "
                                  "(raise DLP_KV_POOL_BLOCKS or lower "
                                  "concurrency)")
                continue
            self._emit(slot.req, log(
                "kv block pool exhausted: generation stopped early "
                "(raise DLP_KV_POOL_BLOCKS or lower concurrency)"))
            slot.stopped = True
            self._finish(slot, "length")

    def _fail_all(self, e: Exception) -> None:
        """Fail every in-flight request with a terminal event and rebuild
        the pool and the device chains."""
        for s in self._slots:
            if s is not None:
                self._finish(s, "error", note=f"engine error: {e!r}")
        self._slots = [None] * self.n_slots
        try:
            self._alloc_state()
        except Exception:
            # the device is gone: closing makes every later submit fail fast
            self._closed.set()

    def _drain_queue(self, reason: str) -> None:
        while True:
            try:
                req = self._subq.get_nowait()
            except queue.Empty:
                return
            self._emit(req, done(f"request dropped: {reason}", n_prompt=0,
                                 n_gen=0, finish_reason="error", error=reason))

    @staticmethod
    def _emit(req: _Request, ev: Event) -> None:
        try:
            req.emit(ev)
        except Exception:  # a vanished consumer must never wedge the worker
            pass

    # -- admission and the first token --------------------------------------

    def _admit(self) -> None:
        """Assign waiting requests to free slots."""
        while True:
            free = [i for i in range(self.n_slots) if self._slots[i] is None]
            if not free:
                return
            try:
                req = self._subq.get_nowait()
            except queue.Empty:
                return
            if req.abort.is_set():
                self._emit(req, done("request aborted while queued",
                                     n_prompt=0, n_gen=0,
                                     finish_reason="abort"))
                continue
            try:
                self._assign(free, req)
            except PoolExhausted as e:
                # the server is overloaded, not the request: a terminal
                # event for this request, siblings untouched
                self._emit(req, done(f"engine error: {e!r}", n_prompt=0,
                                     n_gen=0, finish_reason="error",
                                     error=repr(e)))

    def _pick_slot(self, free: list[int], ids: list[int]) -> tuple[int, int]:
        """(slot, reusable-prefix length): the free slot whose retained KV
        shares the longest usable prefix with the new prompt; with no
        match, the one holding the least retained KV."""
        eng = self.engine
        best_r = min(free, key=lambda r: len(self._row_ids[r]))
        best_k = 0
        for r in free:
            k = 0
            for a, b in zip(self._row_ids[r], ids):
                if a != b:
                    break
                k += 1
            k = min(k, len(ids) - 1)  # >= 1 suffix token must run for logits
            if k < MIN_PREFIX:
                continue
            if k + _bucket(len(ids) - k, eng.max_prompt,
                           quantum=eng._prompt_quantum) > self.max_seq:
                continue
            if k > best_k:
                best_r, best_k = r, k
        return best_r, best_k

    def _assign(self, free: list[int], req: _Request) -> None:
        """Prefill one row of the pool and emit the first token, or start a
        chunked prefill."""
        eng = self.engine
        gen = req.gen
        self._serial += 1
        for ev in eng._events_on_load:
            self._emit(req, ev)
        ids = list(req.prompt) if isinstance(req.prompt, (list, tuple)) \
            else eng.tokenizer.encode(req.prompt)
        n_prompt = len(ids)
        if n_prompt >= eng.max_prompt:
            ids = ids[-(eng.max_prompt - 1):]
        r, reuse_k = self._pick_slot(free, ids)
        slot = _Slot(r, self._serial, req)
        if n_prompt >= eng.max_prompt:
            self._emit(req, log(f"prompt truncated to last {len(ids)} tokens "
                                f"(ctx {self.max_seq})"))
        slot.ids = ids
        slot.n_prompt = n_prompt
        slot.budget = max(0, min(gen.max_new_tokens, self.max_seq - len(ids)))
        self._emit(req, log(
            f"slot {r}/{self.n_slots}: prompt {n_prompt} tokens; generating "
            f"up to {slot.budget} (ctx {self.max_seq}, t={gen.temperature}, "
            f"top_k={gen.top_k}, top_p={gen.top_p})"))
        if _penalized(gen) and gen.repeat_last_n > RECENT_W:
            self._emit(req, log(
                f"repeat_last_n {gen.repeat_last_n} clamped to {RECENT_W} "
                f"(parallel-slot window capacity)"))
        if slot.budget == 0:
            self._emit(req, done("generated 0 tokens (no budget)",
                                 n_prompt=len(ids), n_gen=0,
                                 finish_reason="length"))
            return
        slot.t_start = time.monotonic()
        self._row_ids[r] = []  # the row is being overwritten either way
        if self.prefill_chunked and len(ids) - reuse_k > self.prefill_chunk:
            # chunked admission: claim the row's blocks host-side only; the
            # suffix is fed through mixed steps (_launch_mixed) and the last
            # sub-chunk reuses the bounded prefill (_finish_prefill)
            reuse_k = self._backend.begin_prefill(self, r, ids, reuse_k)
            self._note_reuse(slot, reuse_k)
            slot.phase = "prefill"
            slot.pending = ids[reuse_k:]
            slot.prefix_k = reuse_k
            self._pos[r] = reuse_k
            self._slots[r] = slot
            return
        logits, reuse_k = self._backend.prefill_row(self, r, ids, reuse_k)
        self._note_reuse(slot, reuse_k)
        self._pos[r] = len(ids)
        self._first_token(slot, logits, reuse_k, n_prompt)

    def _note_reuse(self, slot: _Slot, reuse_k: int) -> None:
        if reuse_k:
            self._emit(slot.req, log(
                f"prefix cache hit (slot {slot.idx}): reused KV for "
                f"{reuse_k} of {len(slot.ids)} prompt tokens"))

    def _arm_bias_row(self, r: int, gen: GenerationConfig) -> torch.Tensor | None:
        """Set row ``r`` of the bias matrix to the request's vector (returned,
        for the first token), or zero the row a biased request left."""
        if gen.logit_bias:
            vec = bias_vector(gen.logit_bias, self.cfg.vocab_size, self.device)
            if self._bias_dev is None:
                self._bias_dev = torch.zeros((self.n_slots, self.cfg.vocab_size),
                                             dtype=torch.float32, device=self.device)
            self._bias_dev[r] = vec
            self._bias_rows.add(r)
            return vec
        if r in self._bias_rows:
            self._bias_dev[r] = 0.0
            self._bias_rows.discard(r)
        return None

    def _first_token(self, slot: _Slot, logits: torch.Tensor, reuse_k: int,
                     n_prompt: int) -> None:
        """Sample the prompt's first token from the prefill logits [1, V]
        and arm the row's device chains: the one post-prefill path, shared
        by unchunked admission and the chunked finishing sub-chunk."""
        r = slot.idx
        req = slot.req
        gen = req.gen
        dev = self.device
        vec = self._arm_bias_row(r, gen)
        slot.phase = "decode"
        slot.pending = []
        window = np.asarray(([-1] * RECENT_W + slot.ids)[-RECENT_W:], np.int64)
        if gen.json_mode or gen.grammar:
            self._first_constrained(slot, logits[0], window, n_prompt)
            return
        rng = None
        if gen.temperature > 0.0:
            seed = gen.seed if gen.seed is not None else time.time_ns() % (2**31)
            rng = torch.Generator(device=dev)
            rng.manual_seed(seed)
        params = None
        if rng is not None or _penalized(gen):
            params = upload(_row_param_array([gen]), dev)
        lp_mode = gen.logprobs is not None
        first, recent, lps, _ = _sample_chain(
            logits, upload(window[None], dev), params, _penalized(gen), [rng],
            bias=None if vec is None else vec[None], lp=lp_mode)
        got = self._readback(first, *(lps or ()))()
        first_data = None
        if lp_mode:
            first_data = lp_payload(got[0][0], got[1][0], got[2][0], got[3][0],
                                    gen.logprobs)
            got = got[0]
        t0 = got[0]
        self._gens[r] = rng
        self._tok_dev[r] = first[0]
        # the first token enters the penalty window like every later one
        self._recent_dev[r] = recent[0]
        slot.ttft_ms = (time.monotonic() - slot.t_start) * 1000
        slot.t_decode = time.monotonic()
        self._emit(req, log(f"prefill: {n_prompt} tokens in "
                            f"{slot.ttft_ms:.1f} ms (TTFT)"))
        slot.decoder = StreamDecoder(self.engine.tokenizer)
        slot.stopper = StopMatcher(tuple(gen.stop)) if gen.stop else None
        self._slots[r] = slot
        self._accept(slot, t0, first_data)
        if slot.stopped:
            self._finish(slot, slot.finish)

    def _first_constrained(self, slot: _Slot, row: torch.Tensor,
                           window: np.ndarray, n_prompt: int) -> None:
        """A constrained row's first token: the host's pick from the top
        ``Engine._JSON_TOPK`` of the prefill logits [V], the full row on a
        miss. The pick becomes the row's device token; the row has no
        generator."""
        from .constrained import ConstrainedSampler

        r = slot.idx
        req = slot.req
        tok = self.engine.tokenizer
        slot.sampler = ConstrainedSampler(req.gen, tok.token_bytes, tok.eos_id)
        cap = self.engine._JSON_TOPK
        vals, idx = self._readback(*shortlist(row, cap))()
        slot.readbacks += 1
        res = slot.sampler.pick(vals, idx, cap=cap,
                                full_logits=lambda: self._fetch_row(slot, row))
        self._gens[r] = None
        slot.ttft_ms = (time.monotonic() - slot.t_start) * 1000
        slot.t_decode = time.monotonic()
        self._emit(req, log(f"prefill: {n_prompt} tokens in "
                            f"{slot.ttft_ms:.1f} ms (TTFT)"))
        slot.stopper = StopMatcher(tuple(req.gen.stop)) if req.gen.stop else None
        self._slots[r] = slot
        if res is None:
            self._no_extension(slot)
        else:
            t, delta = res
            self._tok_dev[r] = t
            self._recent_dev[r] = upload(np.append(window[1:], t), self.device)
            self._constrained_accept(slot, t, delta)
        if slot.stopped:
            self._finish(slot, slot.finish)

    def _fetch_row(self, slot: _Slot, row: torch.Tensor) -> np.ndarray:
        """A constrained row's full f32 logits [V] on the host: the
        sampler's last tier, read only when no shortlisted token is valid."""
        slot.readbacks += 1
        slot.misses += 1
        return row.float().cpu().numpy()

    def _no_extension(self, slot: _Slot) -> None:
        """No token extends the constraint: an honest length-style end."""
        self._emit(slot.req, log("constrained mode: no token extends a "
                                 "valid prefix; stopping"))
        slot.finish = "length"
        slot.stopped = True

    def _advance_constrained(self, slot: _Slot, sl_v: list[float],
                             sl_i: list[int], raw: torch.Tensor) -> None:
        """One constrained step of a row: the host's pick from the step's
        device shortlist (descending), whose first ``Engine._JSON_TOPK``
        are the primary tier, then the rest, then the row's full logits
        ``raw`` [V]. The pick replaces the row's device-sampled token (junk) as the
        next step's input and as the newest entry of its recent window."""
        cap = self.engine._JSON_TOPK
        res = slot.sampler.pick(sl_v, sl_i, cap=cap, shortlist=cap,
                                full_logits=lambda: self._fetch_row(slot, raw))
        slot.readbacks += 1
        if res is None:
            self._no_extension(slot)
            return
        t, delta = res
        r = slot.idx
        self._tok_dev[r] = t
        self._recent_dev[r, -1] = t
        self._constrained_accept(slot, t, delta)

    def _constrained_accept(self, slot: _Slot, t: int, delta: str) -> None:
        """Feed one host-picked token through the row's stop / budget /
        completion chain: its text is the validator's exact delta, not the
        stream decoder's."""
        slot.n_gen += 1
        slot.out_ids.append(t)
        if delta:
            if slot.stopper is not None:
                emitted, hit = slot.stopper.feed(delta)
                if emitted:
                    self._emit(slot.req, token(emitted))
                if hit:
                    slot.finish = "stop"
                    slot.stopped = True
                    slot.stop_matched = True
                    return
            else:
                self._emit(slot.req, token(delta))
        if slot.sampler.complete:
            slot.finish = "stop"
            slot.stopped = True
            if slot.stopper is not None:   # release the held-back tail
                held, _ = slot.stopper.finish("")
                if held:
                    self._emit(slot.req, token(held))
                slot.stop_matched = True   # _finish must not drain again
            return
        if slot.n_gen >= slot.budget:
            slot.stopped = True

    def _accept(self, slot: _Slot, t: int, data: dict | None = None) -> None:
        """Feed one sampled token through the slot's EOS/stop/budget chain.
        Sets ``slot.stopped`` when the row is done; the caller finishes it.
        ``data`` is the token's logprob payload: with it every token gets an
        event, even while the decoder holds its bytes back."""
        gen = slot.req.gen
        eos = self.engine.tokenizer.eos_id
        if gen.stop_on_eos and eos is not None and t == eos:
            slot.finish = "stop"
            slot.stopped = True
            return
        slot.n_gen += 1
        slot.out_ids.append(t)
        piece = slot.decoder.feed(t)
        if slot.stopper is not None:
            piece, hit = slot.stopper.feed(piece)
            if piece or data is not None:
                self._emit(slot.req, token(piece, **(data or {})))
            if hit:
                slot.finish = "stop"
                slot.stopped = True
                slot.stop_matched = True
                return
        elif piece or data is not None:
            self._emit(slot.req, token(piece, **(data or {})))
        if slot.n_gen >= slot.budget:
            slot.stopped = True

    def _finish(self, slot: _Slot, finish_reason: str, note: str = "") -> None:
        """Emit the terminal event and free the slot."""
        r = slot.idx
        if self._slots[r] is slot:
            self._slots[r] = None
            self._pos[r] = 0
            if finish_reason in ("stop", "length"):
                # every emitted token but the newest has been fed, so the
                # row's KV is valid for prompt + n_gen - 1 tokens; a row
                # finishing mid-prefill fed only part of its prompt
                if slot.phase == "prefill":
                    self._row_ids[r] = slot.ids[:len(slot.ids) - len(slot.pending)]
                else:
                    self._row_ids[r] = \
                        slot.ids + slot.out_ids[:max(0, slot.n_gen - 1)]
            else:
                self._row_ids[r] = []
        n_gen = slot.n_gen
        dt = time.monotonic() - slot.t_decode if slot.t_decode else 0.0
        tps = (n_gen - 1) / dt if n_gen > 1 and dt > 0 else float("nan")
        # end-of-stream drain: on a stop-string match the held text is
        # discarded; on EOS or budget the decoder's remainder and the text
        # the matcher held back are output
        if finish_reason != "abort" and not slot.stop_matched \
                and (slot.decoder is not None or slot.stopper is not None):
            # a constrained row has no stream decoder: its text is the
            # validator's, and only the matcher may hold some back
            tail = slot.decoder.flush() if slot.decoder is not None else ""
            if slot.stopper is not None:
                tail, hit = slot.stopper.finish(tail)
                if hit:
                    finish_reason = "stop"
            if tail:
                self._emit(slot.req, token(tail))
        msg = note or (f"generated {n_gen} tokens | TTFT "
                       f"{slot.ttft_ms:.1f} ms | decode {tps:.2f} tok/s")
        extra = {"error": note} if finish_reason == "error" and note else {}
        if slot.sampler is not None:   # the engine's constrained done event
            extra.update(json_complete=slot.sampler.complete,
                         constraint_complete=slot.sampler.complete,
                         readbacks=slot.readbacks, shortlist_misses=slot.misses)
        self._emit(slot.req, done(msg, n_prompt=len(slot.ids), n_gen=n_gen,
                                  finish_reason=finish_reason,
                                  ttft_ms=slot.ttft_ms, tok_s=tps, **extra))

    # -- decode -------------------------------------------------------------

    def _row_params(self, running: list[tuple[int, int]]):
        """The per-row sampling parameters of a launch: the [8, B] array on
        the device (None when no row needs it), whether any row is
        penalized, each row's generator (None for greedy, idle and
        constrained rows: a constrained row's device token is replaced by
        the host's pick, so it samples greedily with neutral parameters and
        draws from no generator), the bias matrix (None when no running row
        is biased), whether any row wants logprobs and whether any row is
        constrained."""
        gens_cfg: list[GenerationConfig | None] = [None] * self.n_slots
        rngs: list[torch.Generator | None] = [None] * self.n_slots
        cs = False
        for r, _ in running:
            if self._slots[r].sampler is not None:
                cs = True
                continue
            g = self._slots[r].req.gen
            gens_cfg[r] = g
            if g.temperature > 0.0:
                rngs[r] = self._gens[r]
        penalized = any(g is not None and _penalized(g) for g in gens_cfg)
        params = None
        if penalized or any(g is not None for g in rngs):
            params = upload(_row_param_array(gens_cfg), self.device)
        biased = any(g is not None and g.logit_bias for g in gens_cfg)
        lp = any(g is not None and g.logprobs is not None for g in gens_cfg)
        return params, penalized, rngs, self._bias_dev if biased else None, lp, cs

    def _readback(self, *ts: torch.Tensor) -> Callable:
        """Queue device→host copies of ``ts`` (their own copies: the device
        chains are written in place later); returns a callable that waits
        for them and gives their values as lists (one list for one tensor,
        else a tuple of them)."""
        if ts[0].device.type != "cuda":
            vals = tuple(t.tolist() for t in ts)
            return lambda: vals[0] if len(vals) == 1 else vals
        return self.engine._to_host(*ts)

    def _launch(self, running: list[tuple[int, int]]):
        """Queue one decode chunk for all running rows; returns the handle
        ``_consume`` reads next iteration."""
        B = self.n_slots
        pos = self._pos
        # serial mode: one step while a constrained row runs
        n = 1 if any(self._slots[r].sampler is not None for r, _ in running) \
            else self.decode_chunk
        for r, _ in running:
            n = min(n, self.max_seq - int(pos[r]))
        n = max(1, 1 << (max(1, n).bit_length() - 1))  # pow2: few variants
        # allocate / copy-on-write the blocks this chunk writes and upload
        # changed tables; rows the exhausted pool cannot extend finish
        # gracefully. This precedes the step_pos build: a halted row's write
        # range is not writable, so it is parked at max_seq like a free row
        stopped = self._backend.prepare_chunk(self, running, n)
        if stopped:
            halted = set(stopped)
            for r, serial in stopped:
                slot = self._slots[r]
                if slot is not None and slot.serial == serial:
                    # finish after the in-flight chunk's valid tokens are
                    # consumed (_sweep_starved)
                    slot.starved = True
            running = [rw for rw in running if rw not in halted]
            if not running:
                return None
        # free rows still compute junk steps: their writes are parked at
        # max_seq, outside any row's reusable prefix
        active = {r for r, _ in running}
        step_pos = np.asarray([int(pos[r]) if r in active else self.max_seq
                               for r in range(B)], np.int32)
        params, penalized, rngs, bias, lp, cs = self._row_params(running)
        cache = self._backend.cache(self._bufs, upload(step_pos, self.device))
        tok, recent = self._tok_dev, self._recent_dev
        toks, lps = [], []
        cso = None
        for _ in range(n):
            lg = self._backend.vstep(tok, cache)
            self.forwards += 1
            tok, recent, step_lp, cso = _sample_chain(lg, recent, params, penalized,
                                                      rngs, bias, lp, cs)
            toks.append(tok)
            if lp:
                lps.append(step_lp)
        self._tok_dev, self._recent_dev = tok, recent
        for r, _ in running:
            self._pos[r] += n
        outs = [torch.stack(toks)] + [torch.stack(x) for x in zip(*lps)]
        if cso is not None:
            outs += [cso[0][None], cso[1][None]]
        return (self._readback(*outs), n, running, (), lp,
                None if cso is None else cso[2])

    def _launch_mixed(self, running: list[tuple[int, int]],
                      prefilling: list[_Slot]):
        """Queue one mixed prefill + decode step: the fixed [B,
        prefill_chunk] token block carries one real token per decode row
        (lane 0, fed from the device chain) and up to the chunk budget of
        pending prompt tokens per prefill row; ``n_tok`` marks the real
        lanes, parked rows carry none."""
        B = self.n_slots
        Tc = self.prefill_chunk
        pos = self._pos
        # the earliest request takes the step's token budget. The
        # (max_seq - Tc) cap keeps the finishing sub-chunk's bucket inside
        # max_seq
        budget = Tc
        feeds: dict[int, int] = {}
        for s in sorted(prefilling, key=lambda s: _edf_key(s.req)):
            feed = max(0, min(budget, len(s.pending) - 1,
                              (self.max_seq - Tc) - int(pos[s.idx])))
            feeds[s.idx] = feed
            budget -= feed
        widths = {r: 1 for r, _ in running}
        widths.update(feeds)
        rows_all = running + [(s.idx, s.serial) for s in prefilling]
        stopped = self._backend.prepare_chunk(self, rows_all, widths)
        if stopped:
            halted = set(stopped)
            for r, serial in stopped:
                slot = self._slots[r]
                if slot is not None and slot.serial == serial:
                    slot.starved = True
            running = [rw for rw in running if rw not in halted]
            prefilling = [s for s in prefilling
                          if (s.idx, s.serial) not in halted]
            if not running and not prefilling:
                return None
        # one upload: the token block, then n_tok, from_chain and step_pos
        packed = np.zeros((B, Tc + 3), np.int64)
        packed[:, Tc + 2] = self.max_seq
        for r, _ in running:
            packed[r, Tc:] = (1, 1, pos[r])
        fed: dict[int, int] = {}
        for s in prefilling:
            f = fed[s.idx] = feeds.get(s.idx, 0)
            packed[s.idx, :f] = s.pending[:f]
            packed[s.idx, Tc] = f
            packed[s.idx, Tc + 2] = pos[s.idx]
        params, penalized, rngs, bias, lp, cs = self._row_params(running)
        dev = upload(packed, self.device)
        block, n_tok = dev[:, :Tc], dev[:, Tc]
        block[:, 0] = torch.where(dev[:, Tc + 1].bool(), self._tok_dev, block[:, 0])
        cache = self._backend.cache(self._bufs, dev[:, Tc + 2].to(torch.int32))
        lg = self._backend.mstep(block, n_tok, cache)
        self.forwards += 1
        self._tok_dev, self._recent_dev, lps, cso = _sample_chain(
            lg, self._recent_dev, params, penalized, rngs, bias, lp, cs)
        if running:
            # in-flight streams paid a wide step instead of a decode chunk
            self.counters["prefill_steps_stolen_total"] += 1
        for r, _ in running:
            self._pos[r] += 1
        prefill_meta = []
        for s in prefilling:
            f = fed[s.idx]
            self._pos[s.idx] += f
            if f:
                del s.pending[:f]
                self.counters["prefill_tokens_total"] += f
            prefill_meta.append((s.idx, s.serial))
        outs = [self._tok_dev] + list(lps or ()) + list(cso[:2] if cso else ())
        return (self._readback(*(o[None] for o in outs)), 1, running,
                tuple(prefill_meta), lp, None if cso is None else cso[2])

    def _consume(self, read: Callable, n: int, rows: list[tuple[int, int]],
                 prefill: tuple = (), lp: bool = False,
                 cs_raw: torch.Tensor | None = None) -> None:
        """Read back a finished chunk and route its tokens (and, to the rows
        that asked, their logprobs) to their slots; a constrained row (a
        one-step chunk, ``cs_raw`` its raw logits [B, V] on the device)
        takes the host's pick from its shortlist instead."""
        got = read()
        toks = got[0] if lp or cs_raw is not None else got   # [n][B]
        if cs_raw is not None:
            cs_v, cs_i = got[4 if lp else 1], got[5 if lp else 2]   # [1][B][K]
        for r, serial in rows:
            slot = self._slots[r]
            if slot is None or slot.serial != serial:
                continue  # freed in an earlier chunk: a junk row
            if slot.req.abort.is_set():
                self._finish(slot, "abort")
                continue
            if slot.sampler is not None:
                self._advance_constrained(slot, cs_v[0][r], cs_i[0][r], cs_raw[r])
                if slot.stopped:
                    self._finish(slot, slot.finish)
                continue
            want = slot.req.gen.logprobs if lp else None
            for i in range(n):
                t = int(toks[i][r])
                data = None if want is None else lp_payload(
                    t, got[1][i][r], got[2][i][r], got[3][i][r], want)
                self._accept(slot, t, data)
                if slot.stopped:
                    break
            if slot.stopped:
                self._finish(slot, slot.finish)
        for r, serial in prefill:
            slot = self._slots[r]
            if slot is None or slot.serial != serial or slot.stopped:
                continue
            if slot.req.abort.is_set():
                self._finish(slot, "abort")
