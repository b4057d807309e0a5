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

Request-lifecycle resilience and SLO scheduling, as the reference's:

- admission is ordered by priority class (``interactive`` < ``normal`` <
  ``batch``), then earliest deadline, then submission time (``_edf_key``),
  and the mixed step's prefill budget follows the same order;
- ``deadline_ms`` is anchored at submission and checked at admission,
  after prefill, at every fed chunk and at every chunk boundary; an expired
  request ends with finish reason ``timeout`` and keeps its KV;
- ``shed_check`` turns a full queue, a deadline the queue would already
  blow or an over-quota tenant into a 429 decision, a stalled device into
  a 503 and a poisoned request into a 400, each with a Retry-After;
- an exception tied to one row quarantines that row alone (its blocks are
  released two consumed steps later, after the steps in flight); a request
  that crashed its slot ``poison_limit`` times is refused;
- a watchdog thread fails the requests of a device step that outlives the
  stall budget and sheds new work until the step returns (a CUDA kernel
  cannot be interrupted: the worker waits in its readback as before);
- on the single-device pool, queued interactive work with no free row
  preempts a batch-class row: its KV and sampling chains go out through
  the handoff wire format (``runtime/disagg.py``) into a bounded host-RAM
  swap store (``runtime/swapstore.py``), the row is freed, and the request
  resumes later with zero re-prefill.

The scheduler records into the engine's metrics registry
(``utils/metrics.py``) at the reference's points and under its names:
traffic, outcomes, queue waits, prefill tokens, prefix hits, sheds,
timeouts, quarantines, stalls, preemptions and swaps by result, and the
queue, slot and pool gauges. ``counters`` is a read-only view of the
counters this scheduler recorded (the registry is shared by every
scheduler of an engine and every model of a server). Every request gets a
trace (``utils/tracing.py``: admit, queue, prefill, ``prefill_chunk[i]``,
``decode[i]``, detokenize, the swap spans and the lifecycle events) whose
id rides its done event, and every step is recorded in the engine's perf
monitor (``utils/perf.py``) under ``paged`` or ``mesh``.

The engine may be a ``serving.supervisor.SupervisedEngine``: the scheduler
then reads the current engine through it, and a repeat stall restarts it
and rebuilds the backend against the new engine. Not ported yet (the
reference has them): the disaggregation handoff registry and roles (and
their trace events), the single-device dense slot backend, and slot files
on a mesh.
Typical-p, mirostat and the context shift stay on the single-stream
engine, as in the reference: a request that would run one is refused here.

The worker thread owns every device buffer and all slot state; it runs
under ``torch.inference_mode()`` and on the engine's device, both of which
are thread-local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import os
import queue
import threading
import time
from collections import OrderedDict
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..ops.sampling import (apply_penalties, bias_vector, lp_payload, sample_rows,
                            shortlist, topk_logprobs)
from ..tokenizer import StreamDecoder
from ..utils import (NULL_TRACE, TRACER, Event, Metrics, compile_entry, done, log,
                     rid_args, token)
from . import faults
from .engine import (MIN_PREFIX, PRIORITY_CLASSES, Engine, GenerationConfig,
                     StopMatcher, _bucket, check_constraint_combination,
                     check_token_ids)
from .paged import PagedSlotBackend, PoolExhausted, upload

RECENT_W = 64    # repeat-penalty window capacity per slot (llama.cpp default)
LP_TOPK = 20     # alternatives computed per step when any row wants logprobs
CS_TOPK = 512    # the device top-K of a constrained row read back per step;
                 # its full [V] row is fetched only when all of it misses
POISON_KEEP = 256   # poisoned-request fingerprints kept (LRU-bounded)
CLASS_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}

# per-row sampling parameters, one row each of the [8, B] parameter array
_TEMP, _TOP_K, _TOP_P, _MIN_P, _PEN, _PRES, _FREQ, _LAST_N = range(8)


# the counters every scheduler reads as 0 before they first fire
_COUNTER_KEYS = ("prefill_tokens_total", "paged_prefix_hits_total",
                 "paged_prefix_tokens_total", "prefill_steps_stolen_total",
                 "kv_cow_copies_total", "requests_shed_total",
                 "requests_timed_out_total", "requests_poisoned_total",
                 "slots_quarantined_total", "watchdog_stalls_total")


class CounterView(Mapping):
    """A read-only view of what the engine's metrics registry counted since
    the scheduler started, under the registry's names: flat names, labelled
    ones as ``name{k="v"}`` (the snapshot's keys); the counters every
    scheduler keeps read 0 before they fire. ``metrics`` reads the current
    registry (a supervisor may swap it in)."""

    def __init__(self, metrics: Callable[[], Metrics]):
        self._metrics = metrics
        self._m0 = metrics()
        self._base = self._m0.snapshot()["counters"]

    def _now(self) -> dict:
        m = self._metrics()
        base = self._base if m is self._m0 else {}
        return {k: v - base.get(k, 0)
                for k, v in m.snapshot()["counters"].items()}

    def __getitem__(self, key: str):
        now = self._now()
        if key not in now and key not in _COUNTER_KEYS:
            raise KeyError(key)
        return now.get(key, 0)

    def __iter__(self):
        return iter(dict.fromkeys((*_COUNTER_KEYS, *self._now())))

    def __len__(self) -> int:
        return len(set(_COUNTER_KEYS) | set(self._now()))

    def __repr__(self) -> str:
        return repr(dict(self))


class QueueFull(RuntimeError):
    """Admission refused: the wait queue is at capacity, or the tenant is
    over its quota (a 429 with Retry-After at the serving layer)."""


class PoisonedRequest(RuntimeError):
    """Admission refused: this exact request has crashed its slot
    ``poison_limit`` times; admitting it again would quarantine another
    slot for a deterministic failure."""


class SchedulerStalled(RuntimeError):
    """Admission refused: a device step is past its stall budget and the
    worker is blocked behind it (a 503 with Retry-After at the serving
    layer; admission resumes when the step returns)."""


@dataclass
class _Request:
    prompt: str | list[int]
    gen: GenerationConfig
    emit: Callable[[Event], None]
    abort: threading.Event
    submitted: float = field(default_factory=time.monotonic)
    # the tenant the request is charged to (quotas, the victim's fair
    # share) and, once preempted, its swap-store entry and its parked slot
    # (decoder, stop matcher, out_ids: host state that needs no bytes). Not
    # on GenerationConfig: the poison fingerprint hashes the config
    tenant: str = "default"
    swap: str | None = None
    swap_slot: Any = None
    # the request's lifecycle trace (utils/tracing.py), minted at submit
    trace: Any = NULL_TRACE


def _rid(req: _Request) -> dict:
    """``request_id`` kwargs for a terminal ``done`` event: the one id
    shared by the SSE stream, the JSON finish log and /debug/trace."""
    return rid_args(req.trace)


def _edf_key(req: _Request) -> tuple[int, float, float]:
    """The scheduling order of slot grants and of prefill chunk budgets:
    priority class rank first, the earliest absolute deadline within a
    class (no deadline sorts last), submission time as the tiebreak."""
    dl = (req.submitted + req.gen.deadline_ms / 1000.0
          if req.gen.deadline_ms else float("inf"))
    return (CLASS_RANK.get(req.gen.priority, CLASS_RANK["normal"]),
            dl, req.submitted)


class _DeadlineQueue:
    """The admission queue: ``get_nowait`` pops the request with the
    smallest ``_edf_key``, and it keeps each tenant's queued count."""

    def __init__(self):
        self._lock = threading.Lock()
        self._heap: list[tuple[tuple, int, _Request]] = []
        self._seq = 0  # heap tiebreak: _Request is not orderable
        self._n_tenant: dict[str, int] = {}

    def put(self, req: _Request) -> None:
        with self._lock:
            self._seq += 1
            t = req.tenant
            self._n_tenant[t] = self._n_tenant.get(t, 0) + 1
            heapq.heappush(self._heap, (_edf_key(req), self._seq, req))

    def get_nowait(self) -> _Request:
        with self._lock:
            if not self._heap:
                raise queue.Empty
            req = heapq.heappop(self._heap)[2]
            t = req.tenant
            n = self._n_tenant.get(t, 0) - 1
            if n > 0:
                self._n_tenant[t] = n
            else:
                self._n_tenant.pop(t, None)
            return req

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    def depth_for(self, rank: int) -> int:
        """Queued requests granted a slot before a new arrival of class
        ``rank`` (the same or a better class): the per-class wait
        estimate's depth."""
        with self._lock:
            return sum(1 for key, _, _ in self._heap if key[0] <= rank)

    def tenant_depth(self, tenant: str) -> int:
        """Queued requests charged to ``tenant``."""
        with self._lock:
            return self._n_tenant.get(tenant, 0)


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = ("idx", "serial", "req", "decoder", "stopper", "ids", "n_gen",
                 "budget", "finish", "t_start", "t_decode", "ttft_ms",
                 "stopped", "stop_matched", "out_ids", "starved", "phase",
                 "pending", "prefix_k", "n_prompt", "sampler", "readbacks",
                 "misses", "deadline", "abandoned", "chunk_i")

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
        # the monotonic deadline, anchored at submission (queue wait counts
        # against it); None = no deadline
        self.deadline = (req.submitted + req.gen.deadline_ms / 1000.0
                         if req.gen.deadline_ms else None)
        # the watchdog already emitted this slot's terminal event; the
        # worker only reclaims its bookkeeping when the step returns
        self.abandoned = False
        self.chunk_i = 0   # the trace's decode[i] / prefill_chunk[i] spans


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
                 prefill_chunked: bool | None = None,
                 stall_budget_s: float | None = None,
                 poison_limit: int | None = None,
                 preempt: bool | None = None,
                 swap_store_mb: int | None = None,
                 swap_ttl_s: float | None = None,
                 tenant_quota: int | None = None):
        if n_slots < 2:
            raise ValueError("--parallel needs at least 2 slots")
        # a SupervisedEngine or the engine itself; ``engine`` reads through
        # the supervisor, so a restart's new engine serves every later step
        self._src = engine
        base = self.engine
        self.cfg = base.cfg
        self.device = base.device
        self.n_slots = int(n_slots)
        self.max_seq = base.max_seq
        self.max_queue = max_queue
        self.decode_chunk = int(decode_chunk or base.decode_chunk or 32)
        # the engine's KV representation (int8 codes under kv_quant, rank-r
        # latents under kv_mode "latent") sizes the pool; the backend asks
        # the engine once whether decode steps run the fused kernel
        self.kv_quant = base.kv_quant
        self.kv_mode = base.kv_mode
        self.kv_latent_rank = base.kv_latent_rank
        self._kv_block, self._kv_pool_blocks = kv_block, kv_pool_blocks
        self._backend = base.slot_backend(self.n_slots, self.max_seq,
                                          block_size=kv_block,
                                          n_blocks=kv_pool_blocks)
        self.fused_decode = self._backend.fused
        # the perf monitor's step-ring label of this scheduler's steps
        self._backend_label = ("paged" if isinstance(self._backend, PagedSlotBackend)
                               else "mesh")
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
        self.counters = CounterView(lambda: self.metrics)
        self.forwards = 0   # paged model forwards (each runs every layer)
        # -- preemption: a batch-class victim's KV and sampling chains go
        # through the handoff wire format into the bounded host-RAM swap
        # store; single-device pool only (the mesh's rows are not gathered)
        if preempt is None:
            preempt = os.environ.get("DLP_PREEMPT", "1") != "0"
        self.preempt = bool(preempt) and isinstance(self._backend, PagedSlotBackend)
        swap_mb = (int(os.environ.get("DLP_SWAP_STORE_MB", "256"))
                   if swap_store_mb is None else int(swap_store_mb))
        swap_ttl = (float(os.environ.get("DLP_SWAP_TTL_S", "60"))
                    if swap_ttl_s is None else float(swap_ttl_s))
        from .swapstore import SwapStore

        # worker-thread owned, as every slot structure; on_evict fires inside
        # put(), on the worker too
        self._swap_store = SwapStore(
            max(1, swap_mb) * 2 ** 20, swap_ttl, metrics=self.metrics,
            on_evict=lambda sid: self._drop_swapped(sid, "evicted"))
        self._swapped: dict[str, _Request] = {}   # sid -> the parked request
        self._swap_seq = 0
        self._force_preempt = 0   # preempt_now() requests not yet served
        # per-tenant in-flight quota (0 = unlimited): queued plus resident
        self.tenant_quota = (int(os.environ.get("DLP_TENANT_QUOTA", "0"))
                             if tenant_quota is None else int(tenant_quota))
        self._alloc_state()
        self._slots: list[_Slot | None] = [None] * self.n_slots
        self._serial = 0
        self._subq = _DeadlineQueue()
        # operations run on the worker thread between steps (slot files)
        self._ctlq: queue.Queue[tuple[Callable[[], Any], queue.Queue]] = queue.Queue()
        self._closed = threading.Event()
        self._wake = threading.Event()
        # -- the poisoned-request detector: fingerprint -> slot failures.
        # Written by the worker only; a serving thread's read racing an
        # update admits or refuses against the previous count
        self.poison_limit = (int(os.environ.get("DLP_POISON_LIMIT", "3"))
                             if poison_limit is None else int(poison_limit))
        self._poison: OrderedDict[int, int] = OrderedDict()
        # quarantined rows whose blocks are released once the steps in
        # flight at quarantine time are consumed: [countdown, row]
        self._release_q: list[list[int]] = []
        # request wall-time EWMAs, overall and per class: the wait estimate
        # shedding and Retry-After run on (worker-written, read lock-free)
        self._avg_request_s = 1.0
        self._avg_class_s = {c: 1.0 for c in PRIORITY_CLASSES}
        # -- the decode watchdog: the device-step window [launch, readback]
        # the watchdog thread holds against the stall budget
        self.stall_budget_s = (
            float(os.environ.get("DLP_WATCHDOG_STALL_S", "60"))
            if stall_budget_s is None else float(stall_budget_s))
        self._step_lock = threading.Lock()
        self._step_t0: float | None = None    # guarded by _step_lock
        self._step_rows: tuple = ()           # guarded by _step_lock
        self._step_flagged = False            # this window already reported
        self._stall_streak = 0                # guarded by _step_lock
        self._needs_restart = False           # repeat-stall escalation
        self._stalled = threading.Event()     # shed new work while wedged
        self._export_queue_gauges()   # gauges present from the first scrape
        # the last step's readback (worker-owned): a step launched before it
        # starts there in the step ring and the traces
        self._t_rb = 0.0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="slot-scheduler")
        self._worker.start()
        self._watchdog = None
        if self.stall_budget_s > 0:
            self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                              name="slot-watchdog")
            self._watchdog.start()

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

    # -- the engine, read through a supervisor ------------------------------

    @property
    def engine(self) -> Engine:
        return getattr(self._src, "engine", self._src)

    @property
    def metrics(self) -> Metrics:
        """The engine's current registry (a supervisor may swap it), shared
        by every scheduler of the engine and every model of a registry."""
        return self.engine.metrics

    # -- public API ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._subq.qsize()

    @property
    def slots_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def queue_full(self) -> bool:
        return self._subq.qsize() >= self.max_queue

    def _count_finished(self, outcome: str) -> None:
        """The per-outcome counters, flat and labelled by model."""
        self.metrics.inc(f"requests_finished_{outcome}_total")
        self.metrics.inc("requests_finished_total",
                         labels={"model": self.cfg.arch, "outcome": outcome})

    def _export_queue_gauges(self) -> None:
        """Publish the admission state: queue depth, the wait estimate
        shedding runs on, slot occupancy and the pool's occupancy. The port
        has one pool role ("both", gauge 0) and pins no handoff."""
        m = self.metrics
        m.set_gauge("queue_depth", self._subq.qsize())
        m.set_gauge("queue_wait_est_s", round(self.estimated_wait_s(), 3))
        m.set_gauge("slots_active", self.slots_active)
        m.set_gauge("slots_total", self.n_slots)
        m.set_gauge("pool_role", 0)
        m.set_gauge("kv_handoffs_pinned", 0)
        if isinstance(self._backend, PagedSlotBackend):
            self._backend.export_gauges(self)

    # -- load shedding and the poisoned-request detector ---------------------

    @staticmethod
    def _fingerprint(prompt, gen: GenerationConfig) -> int:
        """The identity of a request for the poison detector: the exact
        prompt and sampling config."""
        p = tuple(prompt) if isinstance(prompt, (list, tuple)) else prompt
        return hash((p, dataclasses.astuple(gen)))

    def _record_poison(self, req: _Request) -> int:
        """Count one slot failure against the request's fingerprint; LRU-
        bounded, so a client cycling prompts cannot grow it without end."""
        fp = self._fingerprint(req.prompt, req.gen)
        n = self._poison.pop(fp, 0) + 1
        self._poison[fp] = n
        while len(self._poison) > POISON_KEEP:
            self._poison.popitem(last=False)
        return n

    def estimated_wait_s(self, priority: str | None = None) -> float:
        """Rough seconds a new request would queue before a slot frees: the
        requests granted ahead of it (the same or a better class) spread
        over the slots, times the EWMA request time (per class when
        ``priority`` is given). An estimate for shedding, not a promise."""
        if priority is None:
            return (self._subq.qsize() / self.n_slots) * self._avg_request_s
        rank = CLASS_RANK.get(priority, CLASS_RANK["normal"])
        ahead = self._subq.depth_for(rank)
        return (ahead / self.n_slots) * self._avg_class_s.get(
            priority, self._avg_request_s)

    def tenant_load(self, tenant: str) -> int:
        """In-flight requests charged to ``tenant``: queued (a preempted
        request waits in the queue, so it keeps counting) plus resident."""
        n = self._subq.tenant_depth(tenant)
        for s in self._slots:
            if s is not None and s.req.tenant == tenant:
                n += 1
        return n

    def shed_check(self, gen: GenerationConfig | None = None,
                   prompt=None, tenant: str | None = None) -> dict | None:
        """Admission control for the serving layer: None admits; otherwise
        ``{reason, retry_after_s, status}`` describes the refusal (429 full
        queue, unmeetable deadline or over-quota tenant, 503 stalled
        device, 400 poisoned request), which the caller answers with a
        ``Retry-After`` header. Counts every shed, and records a (pinned)
        shed trace whose ``request_id`` rides the refusal: a refused request
        still has a lifecycle."""

        def shed(reason: str, status: int, retry_after: int) -> dict:
            out = {"reason": reason, "retry_after_s": retry_after,
                   "status": status}
            rid = TRACER.record_shed(reason, status, model=self.cfg.arch)
            if rid:
                out["request_id"] = rid
            return out

        if self._stalled.is_set():
            self.metrics.inc("requests_shed_total")
            return shed("device step stalled; scheduler is recovering",
                        503, max(1, int(self.stall_budget_s)))
        # Retry-After reflects the queue this class would see under EDF
        wait = self.estimated_wait_s(gen.priority if gen is not None else None)
        retry = max(1, int(wait) + 1)
        if self.queue_full:
            self.metrics.inc("requests_shed_total")
            return shed(f"request queue full ({self.max_queue})", 429, retry)
        if (gen is not None and gen.deadline_ms is not None
                and wait * 1000.0 > gen.deadline_ms):
            # a request that would spend its whole deadline queued is dead
            # on arrival: refuse it now rather than burn a slot
            self.metrics.inc("requests_shed_total")
            self.metrics.inc("requests_timed_out_total")
            return shed(f"cannot finish before deadline: estimated "
                        f"queue wait {wait:.1f}s exceeds deadline "
                        f"{gen.deadline_ms:.0f}ms", 429, retry)
        if (self.tenant_quota > 0 and tenant is not None
                and self.tenant_load(tenant) >= self.tenant_quota):
            # only the over-quota tenant is refused
            self.metrics.inc("requests_shed_total")
            return shed(f"tenant {tenant!r} over quota "
                        f"({self.tenant_quota} in-flight requests)", 429, retry)
        if prompt is not None and gen is not None:
            fails = self._poison.get(self._fingerprint(prompt, gen), 0)
            if fails >= self.poison_limit:
                self.metrics.inc("requests_poisoned_total")
                return shed(f"request refused: it crashed its slot "
                            f"{fails} times (poison_limit "
                            f"{self.poison_limit})", 400, retry)
        return None

    def submit(self, prompt: str | list[int],
               gen: GenerationConfig | None = None, *,
               emit: Callable[[Event], None],
               abort: threading.Event | None = None,
               tenant: str | None = None,
               trace_ctx: dict | None = None) -> _Request:
        """Enqueue a request; its events flow through ``emit`` (called from
        the scheduler thread). Raises when the scheduler is closed,
        ``SchedulerStalled`` while a device step is past its stall budget,
        ``PoisonedRequest`` for a request that crashed its slot
        ``poison_limit`` times, ``QueueFull`` when the wait queue is full or
        ``tenant`` is over its quota, and ``ValueError`` on a token id
        outside the vocabulary, a non-positive deadline, an unknown
        priority class and a sampler the slots do not run: typical-p or
        mirostat on a sampled request, a constraint with another
        constraint, logprobs, a penalty or a bias, a context shift, more
        than ``LP_TOPK`` logprobs. The request's trace is minted here;
        ``trace_ctx`` stamps a propagated fleet context on it."""
        g = gen or GenerationConfig()
        if self._closed.is_set():
            raise RuntimeError("scheduler is closed")
        if self._stalled.is_set():
            # the worker is blocked behind a stalled step: queueing would
            # only grow the casualty list
            self.metrics.inc("requests_shed_total")
            TRACER.record_shed("device step stalled", 503, model=self.cfg.arch)
            raise SchedulerStalled(
                "scheduler stalled: a device step exceeded its "
                f"{self.stall_budget_s:.0f}s stall budget; shedding new work")
        if isinstance(prompt, (list, tuple)):
            check_token_ids(prompt, self.cfg.vocab_size)
        if g.deadline_ms is not None and g.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, "
                             f"got {g.deadline_ms}")
        if g.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {g.priority!r} "
                f"(one of {', '.join(PRIORITY_CLASSES)})")
        fails = self._poison.get(self._fingerprint(prompt, g), 0)
        if fails >= self.poison_limit:
            self.metrics.inc("requests_poisoned_total")
            TRACER.record_shed(f"poisoned request ({fails} slot crashes)", 400,
                               model=self.cfg.arch)
            raise PoisonedRequest(
                f"request refused: it crashed its slot {fails} times "
                f"(poison_limit {self.poison_limit}); re-admission would "
                "quarantine another slot for a deterministic failure")
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
        if self.queue_full:
            self.metrics.inc("requests_shed_total")
            TRACER.record_shed(f"request queue full ({self.max_queue})", 429,
                               model=self.cfg.arch)
            raise QueueFull(f"request queue full ({self.max_queue})")
        if (self.tenant_quota > 0 and tenant is not None
                and self.tenant_load(tenant) >= self.tenant_quota):
            # a preempted request is requeued by the worker without passing
            # here, so preemption never sheds its own victim
            self.metrics.inc("requests_shed_total")
            TRACER.record_shed(f"tenant {tenant!r} over quota", 429,
                               model=self.cfg.arch)
            raise QueueFull(f"tenant {tenant!r} over quota "
                            f"({self.tenant_quota} in-flight requests)")
        req = _Request(prompt, g, emit, abort or threading.Event(),
                       tenant=tenant or "default")
        req.trace = TRACER.start_request(kind="slots", model=self.cfg.arch)
        if req.trace:
            if trace_ctx and trace_ctx.get("fleet_id"):
                req.trace.set_context(trace_ctx["fleet_id"],
                                      hop=trace_ctx.get("hop", 0),
                                      attempt=trace_ctx.get("attempt", 0))
            req.trace.event("admit", queue_depth=self._subq.qsize())
        self._subq.put(req)
        if self._closed.is_set():
            # close() may have drained the queue between the check and the
            # put: drain again so this request still gets its terminal event
            self._drain_queue("scheduler closed")
        self._wake.set()
        return req

    def generate(self, prompt: str | list[int],
                 gen: GenerationConfig | None = None, *,
                 tenant: str | None = None,
                 trace_ctx: dict | None = None) -> Iterator[Event]:
        """Blocking per-request event stream, safe from any thread. Closing
        the generator aborts the request at the next chunk boundary.
        ``tenant`` charges the request to a quota bucket."""
        q: queue.Queue[Event] = queue.Queue()
        abort = threading.Event()
        self.submit(prompt, gen, emit=q.put, abort=abort, tenant=tenant,
                    trace_ctx=trace_ctx)
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
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)

    # -- preemption and the swap store ---------------------------------------
    # With queued interactive work and no free row, a batch-class victim's KV
    # and sampling chains are serialized out through the handoff wire format
    # into the swap store, its row is freed for the interactive request, and
    # the victim re-admits when a row frees, with zero prefill. All state is
    # the worker's. The only safe point for the gather is after the step in
    # flight has been consumed (``_loop`` consumes it first): host slot
    # state is one step behind while a step is in flight.

    def preempt_now(self) -> None:
        """Force one preemption at the next safe point (a victim
        permitting). The request is counted on the worker thread, as every
        control operation runs; the swap happens in the loop."""

        def do() -> None:
            self._force_preempt += 1

        self._control(do)
        self._wake.set()

    def _preempt_wanted(self) -> bool:
        """Is there pressure (queued interactive work with no free row, a
        forced preemption, or an armed ``preempt_storm``) and a victim? The
        victim is looked for first, so an armed fault's firing is never
        spent on a pass that could not preempt."""
        if not self.preempt or self._closed.is_set():
            return False
        if self._find_victim() is None:
            return False
        if self._force_preempt > 0:
            return True
        if faults.ACTIVE and faults.fires("preempt_storm"):
            return True
        if self._subq.depth_for(CLASS_RANK["interactive"]) == 0:
            return False
        deferred = self._deferred_rows()
        return not any(self._slots[i] is None and i not in deferred
                       for i in range(self.n_slots))

    def _find_victim(self) -> _Slot | None:
        """The slot to preempt, or None. Only batch-class, decode-phase,
        unconstrained rows that have sampled a token qualify, never a row
        whose release a quarantine deferred. Fair share: the victim comes
        from the tenant holding the most slots, and within it the least
        urgent request (the largest ``_edf_key``) loses its row."""
        deferred = self._deferred_rows()
        batch = CLASS_RANK["batch"]
        cands = [s for s in self._slots
                 if s is not None and s.phase == "decode"
                 and not s.stopped and not s.starved and not s.abandoned
                 and s.sampler is None and s.n_gen >= 1
                 and CLASS_RANK.get(s.req.gen.priority,
                                    CLASS_RANK["normal"]) >= batch
                 and s.idx not in deferred]
        if not cands:
            return None
        active: dict[str, int] = {}
        for s in self._slots:
            if s is not None:
                active[s.req.tenant] = active.get(s.req.tenant, 0) + 1
        tenant = max(sorted({c.req.tenant for c in cands}),
                     key=lambda t: active.get(t, 0))
        pool = [c for c in cands if c.req.tenant == tenant]
        return max(pool, key=lambda s: _edf_key(s.req))

    def _preempt_one(self) -> None:
        """One preemption attempt at the loop's safe point. A forced request
        is spent whether or not the swap lands, so an unswappable victim
        cannot spin the loop."""
        victim = self._find_victim()
        if self._force_preempt > 0:
            self._force_preempt -= 1
        if victim is not None:
            if victim.req.trace:
                # who lost the slot, and why they qualified
                victim.req.trace.event(
                    "preempt_victim", row=victim.idx, tenant=victim.req.tenant,
                    n_gen=victim.n_gen, priority=victim.req.gen.priority)
            self._swap_out(victim)

    def _swap_out(self, slot: _Slot) -> bool:
        """Serialize ``slot``'s KV and device-side sampling chains (the next
        token, the penalty window, the generator's state) into the swap
        store, free the row and requeue the request under its own EDF key:
        interactive arrivals outrank it, so the freed row goes to the
        pressure that caused the preemption."""
        from .disagg import save_handoff_bytes

        r = slot.idx
        req = slot.req
        full_ids = slot.ids + slot.out_ids[:max(0, slot.n_gen - 1)]
        if int(self._pos[r]) != len(full_ids):
            # not at the safe point after all (a stopping row's last chunk,
            # a row parked at max_seq): skip; the loop may retry later
            return False
        # the span covers serialize + store put: the out half of the swap
        sp = req.trace.begin_span("swap_out", row=r, n_gen=slot.n_gen)
        try:
            rc = self._backend.gather(self._bufs, r)
            extras = {"tok": self._tok_dev[r].cpu().numpy(),
                      "recent": self._recent_dev[r].cpu().numpy()}
            if self._gens[r] is not None:
                extras["rng"] = self._gens[r].get_state().numpy()
            data = save_handoff_bytes(full_ids, rc, len(full_ids),
                                      np.zeros((1, 1), np.float32),
                                      kv_mode=self.kv_mode, extras=extras)
            self._swap_seq += 1
            sid = f"s{self._swap_seq}-{os.urandom(4).hex()}"
            if not self._swap_store.put(sid, data):
                # the payload alone exceeds the whole store: keep the victim
                # resident rather than evict every sibling for it
                self._emit(req, log(
                    f"preemption aborted (slot {r}): swapped state "
                    f"({len(data)} bytes) exceeds DLP_SWAP_STORE_MB"))
                return False
            if req.trace:
                sp.args["bytes"] = len(data)
        finally:
            sp.end()
        req.swap = sid
        req.swap_slot = slot
        self._swapped[sid] = req
        # free the row now; its retained ids keep the blocks warm, so a
        # re-admission into the same row is a re-point with no copy
        self._slots[r] = None
        self._pos[r] = 0
        self._row_ids[r] = full_ids
        self.metrics.inc("preemptions_total", labels={"class": req.gen.priority})
        self.metrics.inc("kv_swaps_total", labels={"result": "out"})
        if req.trace:
            req.trace.event("swap_out", row=r, bytes=len(data), n_gen=slot.n_gen)
        self._emit(req, log(
            f"preempted (slot {r}): {slot.n_gen} tokens generated; KV + "
            f"sampling state swapped out ({len(data)} bytes); resumes "
            f"when a slot frees"))
        self._subq.put(req)
        return True

    def _restore_swapped(self, free: list[int], req: _Request) -> None:
        """Re-admit a preempted request: its KV and sampling chains come back
        with no prefill forward and no prefill count. Fast path: a free row
        still holds exactly its ids (re-point, no device copy). Slow path:
        ``adopt_row`` writes the payload into another free row's fresh
        blocks. A missing or unloadable payload ends the request with a
        typed Retry-After error."""
        from .disagg import handoff_extras, load_handoff_bytes

        sid = req.swap
        slot = req.swap_slot
        self._swapped.pop(sid, None)
        # the span covers store take, load and adopt or re-point: the
        # return half of the swap; the finally closes it on the typed-error
        # early returns too
        sp = req.trace.begin_span("swap_in", swap=sid)
        try:
            data = self._swap_store.take(sid)
            if data is None:
                req.swap_slot = None
                self._swap_error(req, slot, "expired in the swap store", "dropped")
                return
            loaded = load_handoff_bytes(data, self._backend.row_cache(), self.max_seq)
            if loaded is None:
                req.swap_slot = None
                self._swap_error(req, slot, "no longer matches this "
                                 "pool's KV representation", "dropped")
                return
            rc, ids, _logits, _text = loaded
            full_ids = list(ids)
            extras = handoff_extras(data)
            r = next((i for i in free if self._row_ids[i] == full_ids), None)
            if r is None:
                r = min(free, key=lambda i: len(self._row_ids[i]))
                # the restore_slot order: drop the row's provenance before
                # adopt_row releases its old blocks
                self._row_ids[r] = []
                self._bufs = self._backend.adopt_row(self, self._bufs, rc, r,
                                                     len(full_ids))
                self._backend.register_prefix(r, full_ids)
                self._row_ids[r] = list(full_ids)
            # a fresh serial: rows of a stale step carrying the old one are
            # dropped by _consume's serial check
            self._serial += 1
            slot.serial = self._serial
            slot.idx = r
            self._pos[r] = len(full_ids)
            dev = self.device
            self._tok_dev[r] = int(extras["tok"])
            self._recent_dev[r] = upload(extras["recent"], dev)
            rng = None
            if "rng" in extras:
                rng = torch.Generator(device=dev)
                rng.set_state(torch.from_numpy(extras["rng"]))
            self._gens[r] = rng
            self._arm_bias_row(r, req.gen)
            if req.trace:
                sp.args["row"] = r
        finally:
            sp.end()
        req.swap = None
        req.swap_slot = None
        self.metrics.inc("kv_swaps_total", labels={"result": "in"})
        if req.trace:
            req.trace.event("swap_in", row=r, n_gen=slot.n_gen)
        self._emit(req, log(
            f"resumed from swap (slot {r}): {len(full_ids)} tokens "
            f"resident; zero re-prefill"))
        self._slots[r] = slot
        if slot.deadline is not None and time.monotonic() > slot.deadline:
            # the budget burned while parked: a timeout, the KV kept
            self._timeout(slot)

    def _swap_error(self, req: _Request, slot: _Slot | None, why: str,
                    result: str) -> None:
        """The terminal of a preempted request whose swapped state is gone
        (TTL expiry, eviction, a representation change): finish reason
        ``error`` with ``retry_after_s``, never a silent hang."""
        self.metrics.inc("kv_swaps_total", labels={"result": result})
        n_prompt = len(slot.ids) if slot is not None else 0
        n_gen = slot.n_gen if slot is not None else 0
        retry = max(1, int(self.estimated_wait_s(req.gen.priority)) + 1)
        msg = (f"request was preempted and its swapped state {why}; "
               f"resubmit (Retry-After {retry}s)")
        # the tokens delivered before the preemption stay counted
        self.metrics.record_request(
            n_prompt=n_prompt, n_gen=n_gen,
            ttft_ms=slot.ttft_ms if slot is not None else float("nan"),
            tok_s=float("nan"))
        self._count_finished("error")
        if req.trace:
            req.trace.finish("error", n_prompt=n_prompt, n_gen=n_gen, error=msg,
                             model=self.cfg.arch)
        self._emit(req, done(msg, n_prompt=n_prompt, n_gen=n_gen,
                             finish_reason="error", error=msg,
                             retry_after_s=retry, **_rid(req)))

    def _sweep_swaps(self) -> None:
        """Loop-top TTL sweep: every expired entry's request gets its typed
        terminal now (``_drop_swapped``)."""
        if not self._swapped:
            return
        for sid in self._swap_store.sweep():
            self._drop_swapped(sid, "expired")

    def _drop_swapped(self, sid: str, result: str) -> None:
        """A swap entry died before re-admission (``expired`` by the sweep,
        ``evicted`` by a sibling's put): emit the typed terminal. The
        request's queue entry keeps ``req.swap`` set, so ``_admit`` and
        ``_drain_queue`` drop it silently later."""
        req = self._swapped.pop(sid, None)
        self._swap_store.take(sid)
        if req is None:
            return
        why = ("expired in the swap store (DLP_SWAP_TTL_S)"
               if result == "expired"
               else "was evicted from the swap store (DLP_SWAP_STORE_MB)")
        slot = req.swap_slot
        req.swap_slot = None
        self._swap_error(req, slot, why, result)

    def _discard_swap(self, req: _Request) -> None:
        """Release a live swap entry whose request ends another way (abort,
        a deadline in the queue, close); the caller emits the terminal."""
        sid = req.swap
        self._swapped.pop(sid, None)
        self._swap_store.take(sid)
        self.metrics.inc("kv_swaps_total", labels={"result": "dropped"})
        req.swap = None
        req.swap_slot = None

    # -- worker loop --------------------------------------------------------

    def _loop(self) -> None:
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with torch.inference_mode(), ctx:
            pending: tuple | None = None
            while not self._closed.is_set():
                try:
                    with self._step_lock:
                        needs_restart = self._needs_restart
                        self._needs_restart = False
                    if needs_restart:
                        # the repeat-stall escalation lands here, on the
                        # worker, once the stalled step has returned
                        pending = None
                        self._recover_engine()
                    elif self._backend.eng is not self.engine \
                            and self._follow_restart():
                        pending = None
                    self._run_controls()
                    self._sweep_starved()
                    self._finish_prefills()
                    self._sweep_swaps()
                    if self._preempt_wanted():
                        # a safe-point operation: host slot state is one
                        # step behind while a step is in flight, so its
                        # readback lands before the victim is gathered
                        if pending is not None:
                            self._consume(*pending)
                            pending = None
                        self._preempt_one()
                    self._admit()
                    self._export_queue_gauges()
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
                        # idle: nothing is in flight, so deferred quarantine
                        # releases are safe now
                        self._flush_releases(force=True)
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
            # after the drain: a parked preempted request is in the queue,
            # and the drain reads _swapped to give it its terminal event
            self._swapped.clear()
            self._swap_store.clear()
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
            if slot_id in self._deferred_rows():
                # adopt_row releases the row's old blocks inline, inside the
                # window the deferral protects
                raise RuntimeError(
                    f"slot {slot_id} is draining (quarantined blocks "
                    f"awaiting in-flight chunks); retry shortly")
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
            if slot_id in self._deferred_rows():
                # the deferred release erases the row itself
                raise RuntimeError(
                    f"slot {slot_id} is draining (quarantined blocks "
                    f"awaiting in-flight chunks); retry shortly")
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
            if faults.ACTIVE:
                faults.check("prefill_chunk_crash", row=r, serial=slot.serial,
                             phase="finish")
            logits, fill = self._backend.prefill_row(self, r, slot.ids, fill)
        except PoolExhausted as e:
            # no pool room for the suffix bucket: the server is overloaded,
            # not the prompt (no poison strike)
            if slot.req.trace:
                slot.req.trace.event("pool_exhausted", row=r, phase="prefill")
            self.metrics.inc("requests_aborted_total")
            self._finish(slot, "error", note=f"engine error: {e!r}")
            return
        except Exception as e:
            self._quarantine(slot, f"row failed finishing prefill: {e!r}")
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
            if slot.req.trace:
                slot.req.trace.event("pool_exhausted", row=slot.idx,
                                     phase=slot.phase)
            if slot.phase == "prefill":
                # nothing was sampled: a "length" finish would present an
                # empty completion as a success
                self.metrics.inc("requests_aborted_total")
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
        the pool and the device chains: for an error that belongs to no
        row."""
        self.metrics.inc("scheduler_faults_total")
        # close the step window first: a watchdog claim in flight has then
        # either landed (abandoned is set, visible below) or backed off
        self._step_end()
        resident = [s for s in self._slots if s is not None]
        for s in resident:
            if s.abandoned:   # the watchdog already told this client
                self._forget(s)
            else:
                self._finish(s, "error", note=f"engine error: {e!r}")
                if len(resident) == 1:
                    # a step-wide crash is the request's only when it ran
                    # alone; with siblings the culprit is ambiguous
                    self._record_poison(s.req)
        self._slots = [None] * self.n_slots
        self._pos[:] = 0
        self._release_q.clear()   # the pool is rebuilt below
        try:
            self._alloc_state()
        except Exception:
            # the device is gone: closing makes every later submit fail fast
            self._closed.set()

    # -- slot-level fault isolation ----------------------------------------

    def _quarantine(self, slot: _Slot, note: str) -> None:
        """Fail one slot's request (terminal event, slot freed) while every
        sibling row keeps decoding. The row's blocks are not released
        inline: a step launched before the failure may still write through
        the row's uploaded table, so the release waits until those steps
        are consumed (``_release_q``)."""
        r = slot.idx
        fails = self._record_poison(slot.req)
        self.metrics.inc("slots_quarantined_total")
        if slot.req.trace:
            slot.req.trace.event("quarantine", row=r, fails=fails, note=note)
        if fails >= self.poison_limit:
            note += (f" (request has now failed {fails}x: further "
                     "submissions will be refused)")
        self._emit(slot.req, log(f"slot {r} quarantined: {note}"))
        self._finish(slot, "error", note=f"slot quarantined: {note}")
        self._release_q.append([2, r])

    def _forget(self, slot: _Slot) -> None:
        """Reclaim a slot whose terminal event was already emitted (the
        watchdog failed it mid-stall): bookkeeping only, no events."""
        r = slot.idx
        if self._slots[r] is slot:
            self._slots[r] = None
            self._pos[r] = 0
            self._row_ids[r] = []
        self._release_q.append([2, r])

    def _timeout(self, slot: _Slot) -> None:
        """Deadline exceeded: finish the request with the typed ``timeout``
        reason. Its KV is valid (a healthy request that ran out of time), so
        the row keeps it as a retained prefix."""
        self.metrics.inc("requests_timed_out_total")
        waited = time.monotonic() - slot.req.submitted
        if slot.req.trace:
            slot.req.trace.event("deadline_exceeded",
                                 budget_ms=slot.req.gen.deadline_ms,
                                 elapsed_ms=round(waited * 1000, 1))
        self._emit(slot.req, log(
            f"deadline exceeded ({slot.req.gen.deadline_ms:.0f} ms budget, "
            f"{waited * 1000:.0f} ms elapsed); stopping"))
        slot.finish = "timeout"
        slot.stopped = True
        self._finish(slot, "timeout")

    def _deferred_rows(self) -> set[int]:
        """Rows whose block release the quarantine deferred behind steps in
        flight: not grantable, restorable or evictable until
        ``_flush_releases`` reclaims them."""
        return {e[1] for e in self._release_q}

    def _flush_releases(self, force: bool = False) -> None:
        """Release quarantined rows' blocks once the steps in flight at
        quarantine time are consumed (two ``_consume`` calls: launch and
        consume alternate). ``force`` releases now (the idle loop: nothing
        is in flight)."""
        if not self._release_q:
            return
        rest: list[list[int]] = []
        for entry in self._release_q:
            entry[0] -= 1
            r = entry[1]
            if not force and entry[0] > 0:
                rest.append(entry)
                continue
            if self._slots[r] is None and not self._row_ids[r]:
                # not re-admitted meanwhile (admission owns the row's blocks
                # from then on)
                self._backend.release_row(r)
        self._release_q = rest

    # -- the decode watchdog ------------------------------------------------

    def _step_begin(self, rows: list[tuple[int, int]]) -> None:
        with self._step_lock:
            self._step_t0 = time.monotonic()
            self._step_rows = tuple(rows)
            self._step_flagged = False

    def _step_end(self) -> None:
        with self._step_lock:
            flagged = self._step_flagged
            self._step_t0 = None
            self._step_rows = ()
            self._step_flagged = False
            if not flagged:
                # only an on-time completion resets the repeat-stall count
                self._stall_streak = 0
        # a completed readback proves the device serves again. Cleared
        # unconditionally: with overlap, the next launch's _step_begin may
        # have reset the flag before the stalled step's consume got here
        self._stalled.clear()

    def _watch(self) -> None:
        """The watchdog thread: a device step (launch to readback) past the
        stall budget fails its requests now, so every consumer unblocks
        with a terminal event instead of waiting with the worker, and new
        work is shed until the step returns; a repeat stall rebuilds the
        device state once it does. The poll interval follows the budget,
        so a live scheduler's ``stall_budget_s`` may be changed."""
        while not self._closed.wait(
                max(0.01, min(0.5, self.stall_budget_s / 5.0))):
            victims, streak = self._claim_stalled()
            if victims is None:
                continue
            self.metrics.inc("watchdog_stalls_total")
            self._stalled.set()
            msg = (f"device step stalled > {self.stall_budget_s:.1f}s "
                   f"(stall {streak}; "
                   f"{'restarting engine when it returns' if streak >= 2 else 'failing affected requests'})")
            for slot in victims:
                if slot.req.trace:
                    slot.req.trace.event("watchdog_stall", row=slot.idx,
                                         budget_s=self.stall_budget_s,
                                         streak=streak)
                    slot.req.trace.finish(
                        "error", n_prompt=len(slot.ids), n_gen=slot.n_gen,
                        error=f"watchdog: {msg}", model=self.cfg.arch)
                self._emit(slot.req, log(f"watchdog: {msg}"))
                self._emit(slot.req, done(
                    f"request failed: {msg}", n_prompt=len(slot.ids),
                    n_gen=slot.n_gen, finish_reason="error",
                    error=f"watchdog: {msg}", **_rid(slot.req)))
                # this terminal replaces _finish's: count the traffic here
                self._count_finished("error")
                self.metrics.record_request(
                    n_prompt=len(slot.ids), n_gen=slot.n_gen,
                    ttft_ms=slot.ttft_ms, tok_s=float("nan"))

    def _claim_stalled(self) -> tuple[list[_Slot] | None, int]:
        """Flag the current step window as stalled and claim its victims:
        ``(slots to fail, stall streak)``, or ``(None, 0)`` when the window
        is healthy, closed or already flagged. The claim (``abandoned``)
        happens under ``_step_lock`` with the window re-checked, so a step
        finishing right at the budget either closes its window first (the
        claim backs off and the worker delivers the chunk) or is claimed
        first (the worker's ``abandoned`` check reclaims it silently):
        never two terminal events for one request."""
        with self._step_lock:
            t0, rows, flagged = (self._step_t0, self._step_rows,
                                 self._step_flagged)
            if (t0 is None or flagged
                    or time.monotonic() - t0 < self.stall_budget_s):
                return None, 0
            self._step_flagged = True
            self._stall_streak += 1
            streak = self._stall_streak
            if streak >= 2:
                self._needs_restart = True
            victims: list[_Slot] = []
            for r, serial in rows:
                slot = self._slots[r]
                if slot is None or slot.serial != serial or slot.abandoned:
                    continue
                slot.abandoned = True   # the worker reclaims it (_forget)
                victims.append(slot)
        return victims, streak

    def _recover_engine(self) -> None:
        """Repeat-stall escalation, on the worker thread: restart a
        supervised engine (its weights reload), rebuild the backend against
        the new engine, then fail what is resident and rebuild the device
        state, since the stalled step's buffers are suspect. Without a
        supervisor only the device state is rebuilt. A restart that fails
        (the budget spent, the rebuild crashed) is terminal: every request
        fails and the scheduler closes, so later submits fail fast."""
        err: Exception = RuntimeError(
            "engine restarted after repeated device-step stalls")
        restart = getattr(self._src, "restart", None)
        if callable(restart):
            # the old pool goes before the rebuild: the new engine's weights
            # and pool then never sit beside it on the device
            self._bufs = None
            try:
                restart()
                self._backend = self.engine.slot_backend(
                    self.n_slots, self.max_seq, block_size=self._kv_block,
                    n_blocks=self._kv_pool_blocks)
                self.fused_decode = self._backend.fused
            except Exception as e:
                err = e
                self._closed.set()
        self._fail_all(err)
        with self._step_lock:
            self._stall_streak = 0
        self._stalled.clear()

    def _follow_restart(self) -> bool:
        """The supervisor rebuilt the engine outside the watchdog (a crash
        on a request that runs on the engine under the decode lock): the
        slots move to the new engine here, on the worker, between steps, so
        the old engine's weights go with its last reference. The pool's KV
        came from the same weights, so a paged backend keeps it and what is
        resident; a mesh's cache rows ended with its ranks, so its backend
        is rebuilt and what was resident fails. Returns True then."""
        eng = self.engine
        if isinstance(self._backend, PagedSlotBackend):
            self._backend.eng = eng
            return False
        self._bufs = None
        self._backend = eng.slot_backend(self.n_slots, self.max_seq,
                                         block_size=self._kv_block,
                                         n_blocks=self._kv_pool_blocks)
        self.fused_decode = self._backend.fused
        self._fail_all(RuntimeError(
            "engine restarted: the mesh's slot rows ended with it"))
        return True

    def _drain_queue(self, reason: str) -> None:
        while True:
            try:
                req = self._subq.get_nowait()
            except queue.Empty:
                return
            if req.swap is not None and self._swapped.get(req.swap) is not req:
                # the swap entry died and _drop_swapped already emitted this
                # request's terminal: its queue entry goes silently
                continue
            if req.swap is not None:
                self._discard_swap(req)
            if req.trace:
                req.trace.finish("error", n_prompt=0, n_gen=0, error=reason,
                                 model=self.cfg.arch)
            self._emit(req, done(f"request dropped: {reason}", n_prompt=0,
                                 n_gen=0, finish_reason="error", error=reason,
                                 **_rid(req)))

    @staticmethod
    def _emit(req: _Request, ev: Event) -> None:
        try:
            req.emit(ev)
        except Exception:  # a vanished consumer must never wedge the worker
            pass

    # -- admission and the first token --------------------------------------

    def _admit(self) -> None:
        """Assign waiting requests to free slots, in EDF order. A row whose
        release a quarantine deferred is not grantable: admission releases
        a row's old blocks inline, inside the window the deferral protects."""
        while True:
            deferred = self._deferred_rows()
            free = [i for i in range(self.n_slots)
                    if self._slots[i] is None and i not in deferred]
            if not free:
                return
            try:
                req = self._subq.get_nowait()
            except queue.Empty:
                return
            if req.swap is not None and self._swapped.get(req.swap) is not req:
                # the swap entry expired or was evicted while queued:
                # _drop_swapped already emitted the typed terminal
                continue
            if req.abort.is_set():
                if req.swap is not None:
                    self._discard_swap(req)
                if req.trace:
                    req.trace.finish("abort", n_prompt=0, n_gen=0,
                                     model=self.cfg.arch)
                self._emit(req, done("request aborted while queued",
                                     n_prompt=0, n_gen=0,
                                     finish_reason="abort", **_rid(req)))
                continue
            if (req.gen.deadline_ms is not None and time.monotonic()
                    > req.submitted + req.gen.deadline_ms / 1000.0):
                # the whole budget burned in the queue: a prefill now could
                # only produce late tokens
                self.metrics.inc("requests_timed_out_total")
                self._count_finished("timeout")
                if req.trace:
                    req.trace.add_span("queue", req.submitted, time.monotonic())
                    req.trace.event("deadline_exceeded", phase="queue",
                                    budget_ms=req.gen.deadline_ms)
                    req.trace.finish("timeout", n_prompt=0, n_gen=0,
                                     model=self.cfg.arch)
                if req.swap is not None:
                    self._discard_swap(req)
                self._emit(req, done(
                    f"deadline exceeded while queued "
                    f"({req.gen.deadline_ms:.0f} ms budget)", n_prompt=0,
                    n_gen=0, finish_reason="timeout", **_rid(req)))
                continue
            try:
                self._assign(free, req)
            except Exception as e:
                self._fail_request(req, e, free)

    def _fail_request(self, req: _Request, e: Exception,
                      free: list[int]) -> None:
        """One request failed during admission or prefill (a tokenizer
        error, a prefill fault, an exhausted pool): a terminal event for
        that request, a poison strike unless the pool was the cause (the
        server is overloaded, not the prompt), siblings untouched."""
        self.metrics.inc("requests_aborted_total")
        if not isinstance(e, PoolExhausted):
            self._record_poison(req)
        if req.trace:
            if isinstance(e, PoolExhausted):
                req.trace.event("pool_exhausted", phase="admission")
            req.trace.finish("error", n_prompt=0, n_gen=0, error=repr(e),
                             model=self.cfg.arch)
        self._emit(req, done(f"engine error: {e!r}", n_prompt=0, n_gen=0,
                             finish_reason="error", error=repr(e), **_rid(req)))
        for i in free:
            if self._slots[i] is not None and self._slots[i].req is req:
                self._slots[i] = None

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
        chunked prefill; a preempted request swaps back in instead."""
        if req.swap is not None:
            self._restore_swapped(free, req)
            return
        eng = self.engine
        gen = req.gen
        self._serial += 1
        # the slot grant ends the queue phase
        t_grant = time.monotonic()
        if req.trace:
            req.trace.add_span("queue", req.submitted, t_grant,
                               depth=self._subq.qsize())
        wait_ms = (t_grant - req.submitted) * 1000.0
        self.metrics.observe("queue_wait_ms", wait_ms)
        self.metrics.observe("queue_wait_ms", wait_ms,
                             labels={"class": gen.priority})
        for ev in eng._events_on_load:
            self._emit(req, ev)
        if faults.ACTIVE:
            faults.check("tokenizer_error", serial=self._serial)
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
            self.metrics.record_request(n_prompt=len(ids), n_gen=0,
                                        ttft_ms=float("nan"),
                                        tok_s=float("nan"))
            if req.trace:
                req.trace.finish("length", n_prompt=len(ids), n_gen=0,
                                 model=self.cfg.arch)
            self._emit(req, done("generated 0 tokens (no budget)",
                                 n_prompt=len(ids), n_gen=0,
                                 finish_reason="length", **_rid(req)))
            return
        slot.t_start = time.monotonic()
        self._row_ids[r] = []  # the row is being overwritten either way
        if faults.ACTIVE:
            faults.check("prefill_oom", row=r, serial=self._serial)
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
            self.metrics.inc("prefix_cache_hits_total")
            self.metrics.inc("prefix_cache_tokens_total", reuse_k)
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
        slot.phase = "decode"
        slot.pending = []
        if slot.deadline is not None and time.monotonic() > slot.deadline:
            # the KV is valid and kept, but no token may be sampled past
            # the budget
            self._slots[r] = slot
            self._timeout(slot)
            return
        vec = self._arm_bias_row(r, gen)
        window = np.asarray(([-1] * RECENT_W + slot.ids)[-RECENT_W:], np.int64)
        if gen.json_mode or gen.grammar:
            self._first_constrained(slot, logits[0], window, n_prompt, reuse_k)
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
        if req.trace:
            req.trace.add_span("prefill", slot.t_start, slot.t_decode,
                               n_prompt=n_prompt, reused=reuse_k, row=r)
        self._emit(req, log(f"prefill: {n_prompt} tokens in "
                            f"{slot.ttft_ms:.1f} ms (TTFT)"))
        slot.decoder = StreamDecoder(self.engine.tokenizer)
        slot.stopper = StopMatcher(tuple(gen.stop)) if gen.stop else None
        self._slots[r] = slot
        self._accept(slot, t0, first_data)
        if slot.stopped:
            self._finish(slot, slot.finish)

    def _first_constrained(self, slot: _Slot, row: torch.Tensor,
                           window: np.ndarray, n_prompt: int, reuse_k: int) -> None:
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
        if req.trace:
            req.trace.add_span("prefill", slot.t_start, slot.t_decode,
                               n_prompt=n_prompt, reused=reuse_k, row=r)
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
        """Emit the terminal event, record the request, free the slot."""
        r = slot.idx
        if self._slots[r] is slot:
            self._slots[r] = None
            self._pos[r] = 0
            if finish_reason in ("stop", "length", "timeout"):
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
        if finish_reason == "abort":
            self.metrics.inc("requests_aborted_total")
            self.metrics.inc("prompt_tokens_total", len(slot.ids))
            self.metrics.inc("generated_tokens_total", n_gen)
        else:
            self.metrics.record_request(n_prompt=len(slot.ids), n_gen=n_gen,
                                        ttft_ms=slot.ttft_ms, tok_s=tps)
        self._count_finished(finish_reason)
        # request-time EWMAs, overall and of the request's class: the
        # shedding wait estimates
        dt_req = time.monotonic() - slot.req.submitted
        self._avg_request_s = 0.8 * self._avg_request_s + 0.2 * dt_req
        cls = slot.req.gen.priority
        if cls in self._avg_class_s:
            self._avg_class_s[cls] = 0.8 * self._avg_class_s[cls] + 0.2 * dt_req
        msg = note or (f"generated {n_gen} tokens | TTFT "
                       f"{slot.ttft_ms:.1f} ms | decode {tps:.2f} tok/s")
        extra = {"error": note} if finish_reason == "error" and note else {}
        if slot.sampler is not None:   # the engine's constrained done event
            extra.update(json_complete=slot.sampler.complete,
                         constraint_complete=slot.sampler.complete,
                         readbacks=slot.readbacks, shortlist_misses=slot.misses)
        tr = slot.req.trace
        if tr:
            ttft = slot.ttft_ms
            tr.finish(finish_reason, n_prompt=len(slot.ids), n_gen=n_gen,
                      ttft_ms=None if ttft != ttft else round(ttft, 3),
                      tok_s=None if tps != tps else round(tps, 2),
                      model=self.cfg.arch,
                      error=note if finish_reason == "error" and note else None)
        self._emit(slot.req, done(msg, n_prompt=len(slot.ids), n_gen=n_gen,
                                  finish_reason=finish_reason,
                                  ttft_ms=slot.ttft_ms, tok_s=tps, **extra,
                                  **_rid(slot.req)))

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
        # the watchdog window opens at launch and closes when the chunk's
        # readback completes (_consume); a device_stall fault sleeps inside
        self._step_begin(running)
        t_launch = time.monotonic()
        if faults.ACTIVE:
            faults.stall("device_stall")
        tok, recent = self._tok_dev, self._recent_dev
        toks, lps = [], []
        cso = None
        with compile_entry("slots_decode") as sc:
            for _ in range(n):
                lg = self._backend.vstep(tok, cache)
                self.forwards += 1
                tok, recent, step_lp, cso = _sample_chain(
                    lg, recent, params, penalized, rngs, bias, lp, cs)
                toks.append(tok)
                if lp:
                    lps.append(step_lp)
        if sc.retrace:
            self._note_retrace(sc.name, sc.compiles, running)
        self._tok_dev, self._recent_dev = tok, recent
        for r, _ in running:
            self._pos[r] += n
        outs = [torch.stack(toks)] + [torch.stack(x) for x in zip(*lps)]
        if cso is not None:
            outs += [cso[0][None], cso[1][None]]
        return (self._readback(*outs), n, running, (), lp,
                None if cso is None else cso[2], t_launch)

    def _note_retrace(self, entry: str, compiles: int,
                      rows: list[tuple[int, int]]) -> None:
        """A CUDA library already loaded was built or loaded again under a
        launch (``utils/perf.py`` counts and logs it): stamp a typed event on
        every affected request's trace."""
        for r, serial in rows:
            slot = self._slots[r]
            if slot is not None and slot.serial == serial and slot.req.trace:
                slot.req.trace.event("xla_recompile", entry=entry,
                                     compiles=compiles)

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
        self._step_begin(running + [(s.idx, s.serial) for s in prefilling])
        t_launch = time.monotonic()
        if faults.ACTIVE:
            faults.stall("device_stall")
        with compile_entry("slots_mixed") as sc:
            lg = self._backend.mstep(block, n_tok, cache)
        if sc.retrace:
            self._note_retrace(sc.name, sc.compiles,
                               running + [(s.idx, s.serial) for s in prefilling])
        self.forwards += 1
        self._tok_dev, self._recent_dev, lps, cso = _sample_chain(
            lg, self._recent_dev, params, penalized, rngs, bias, lp, cs)
        if running:
            # in-flight streams paid a wide step instead of a decode chunk
            self.metrics.inc("prefill_steps_stolen_total")
        for r, _ in running:
            self._pos[r] += 1
        prefill_meta = []
        for s in prefilling:
            f = fed[s.idx]
            self._pos[s.idx] += f
            if f:
                del s.pending[:f]
                self.metrics.observe("prefill_chunk_tokens", f)
                self.metrics.inc("prefill_tokens_total", f)
            prefill_meta.append((s.idx, s.serial, f))
        outs = [self._tok_dev] + list(lps or ()) + list(cso[:2] if cso else ())
        return (self._readback(*(o[None] for o in outs)), 1, running,
                tuple(prefill_meta), lp, None if cso is None else cso[2], t_launch)

    def _consume(self, read: Callable, n: int, rows: list[tuple[int, int]],
                 prefill: tuple = (), lp: bool = False,
                 cs_raw: torch.Tensor | None = None,
                 t_launch: float | None = None) -> None:
        """Read back a finished chunk and route its tokens (and, to the rows
        that asked, their logprobs) to their slots; a constrained row (a
        one-step chunk, ``cs_raw`` its raw logits [B, V] on the device)
        takes the host's pick from its shortlist instead. An exception in a
        row's own work quarantines that row; its siblings keep decoding."""
        got = read()
        self._step_end()   # the chunk's readback completed: the window closes
        t_rb = time.monotonic()
        if t_launch is not None:
            # the step runs from its launch, or from the previous step's
            # readback when it was launched before that: overlapped steps
            # tile the worker's wall time instead of counting it twice
            t_launch, self._t_rb = max(t_launch, self._t_rb), t_rb
        perf = getattr(self.engine, "perf", None)
        if perf and t_launch is not None:
            # the step ring: the step's wall, occupancy, tokens produced and
            # the prefill-vs-decode split of this step
            kv_pos = int(sum(int(self._pos[r]) for r, _ in rows)
                         + sum(int(self._pos[r]) for r, _, _ in prefill))
            perf.record_step(
                self._backend_label, t_launch, t_rb,
                rows=len(rows) + len(prefill), tokens=n * len(rows),
                scan_steps=n, prefill_tokens=sum(f for _, _, f in prefill),
                kv_positions=kv_pos, kind="mixed" if prefill else "decode")
        toks = got[0] if lp or cs_raw is not None else got   # [n][B]
        if cs_raw is not None:
            cs_v, cs_i = got[4 if lp else 1], got[5 if lp else 2]   # [1][B][K]
        for r, serial in rows:
            slot = self._slots[r]
            if slot is None or slot.serial != serial:
                continue  # freed in an earlier chunk: a junk row
            if slot.abandoned:
                # the watchdog failed this request during a stall and its
                # terminal event is out: reclaim the bookkeeping only
                self._forget(slot)
                continue
            tr = slot.req.trace
            if tr and t_launch is not None:
                # the host's view of this row's share of the batched step
                slot.chunk_i += 1
                tr.add_span(f"decode[{slot.chunk_i}]", t_launch, t_rb,
                            tokens=n, row=r)
            if slot.req.abort.is_set():
                self._finish(slot, "abort")
                continue
            if slot.deadline is not None and time.monotonic() > slot.deadline:
                # this chunk's tokens are already past the budget: drop them
                self._timeout(slot)
                continue
            try:
                if faults.ACTIVE:
                    faults.check("decode_chunk_crash", row=r, serial=serial)
                if slot.sampler is not None:
                    self._advance_constrained(slot, cs_v[0][r], cs_i[0][r],
                                              cs_raw[r])
                    if slot.stopped:
                        self._finish(slot, slot.finish)
                    continue
                want = slot.req.gen.logprobs if lp else None
                t_dk = time.monotonic()
                for i in range(n):
                    t = int(toks[i][r])
                    data = None if want is None else lp_payload(
                        t, got[1][i][r], got[2][i][r], got[3][i][r], want)
                    self._accept(slot, t, data)
                    if slot.stopped:
                        break
                if tr:
                    tr.add_span("detokenize", t_dk, time.monotonic())
                if slot.stopped:
                    self._finish(slot, slot.finish)
            except Exception as e:
                self._quarantine(slot, f"row failed mid-decode-chunk: {e!r}")
        for r, serial, fed_n in prefill:
            # prefill-phase rows route no tokens, but abort, the deadline
            # and fault isolation apply at every fed chunk
            slot = self._slots[r]
            if slot is None or slot.serial != serial or slot.stopped:
                continue
            if slot.abandoned:
                self._forget(slot)
                continue
            tr = slot.req.trace
            if tr and t_launch is not None and fed_n:
                # a zero-budget step (an EDF-later row waiting its turn) adds
                # no span
                slot.chunk_i += 1
                tr.add_span(f"prefill_chunk[{slot.chunk_i}]", t_launch, t_rb,
                            tokens=fed_n, row=r)
            if slot.req.abort.is_set():
                self._finish(slot, "abort")
                continue
            if slot.deadline is not None and time.monotonic() > slot.deadline:
                self._timeout(slot)
                continue
            try:
                if faults.ACTIVE:
                    faults.check("prefill_chunk_crash", row=r, serial=serial)
            except Exception as e:
                self._quarantine(slot, f"row failed mid-prefill-chunk: {e!r}")
        self._flush_releases()
