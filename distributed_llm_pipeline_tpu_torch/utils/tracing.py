"""Per-request lifecycle tracing: a copy of
``distributed_llm_pipeline_tpu/utils/tracing.py`` (the port imports nothing
of the JAX package), with the device-time join reading a ``torch.profiler``
Chrome trace instead of XLA's xplane protos.

Every request gets an id at admission and a span tree::

    admit -> queue -> prefill -> decode[chunk i] -> detokenize
          -> stream -> finish(reason)

plus typed span events for every resilience transition the runtime can
take: deadline hit, slot quarantine, load shed, watchdog stall,
pool-exhausted degrade.

Design constraints, in order:

- **Zero allocation when disabled.** ``Tracer.start_request`` returns the
  falsy ``NULL_TRACE`` singleton when tracing is off (``DLP_TRACE=0``);
  hot paths guard with ``if trace:`` so a disabled tracer costs one
  attribute read and a branch per site — the same discipline as
  ``runtime/faults.ACTIVE``.
- **Bounded memory.** Finished traces land in a ring of the last
  ``DLP_TRACE_RING`` requests; failure finishes (anything outside
  ``stop``/``length`` — error, timeout, abort) are *pinned* past normal
  eviction, bounded by their own cap. Sheds are pinned too but in their
  OWN ring-sized pool: an overload hammering out 429s must not flush the
  failure traces the pinning exists to preserve.
- **One id everywhere.** The same ``request_id`` appears in the SSE
  ``done`` event, the structured JSON log line emitted at finish, and
  the trace served at ``GET /debug/trace?id=``.
- **Chrome/Perfetto native.** ``export()`` renders the trace-event JSON
  schema (``ph: X`` duration spans, ``ph: i`` instants), loadable in
  ``ui.perfetto.dev`` or ``chrome://tracing`` directly.
- **Device-time correlation.** When the engine ran under
  ``utils.profile_trace.profiler_trace`` (``--profile-dir``) or an
  on-demand ``POST /debug/profile`` window, ``join_profile`` reads the
  ``torch.profiler`` Chrome trace and joins its per-device kernel
  timelines onto the host spans as ``device:*`` spans: measured device
  busy time inside the request window, not just host wall-clock. On the
  CPU, with no CUDA kernels, the profiler's host thread lanes stand in
  (``mode: "lanes"``).

Span recording has three surfaces: ``with trace.span("prefill"):``
(context manager — always closed), ``sp = trace.begin_span(...)`` +
``sp.end()`` in a ``finally`` (manual, for spans that cannot nest
lexically), and ``trace.add_span(name, t0, t1)`` (record-complete, for
hot paths like the scheduler's overlapped chunk launch/readback where
begin and end live in different functions).

Fleet tracing: a router mints a *fleet trace id* (its own request id)
and propagates it on every internal dispatch via the ``X-DLP-Trace``
header (:func:`format_trace_context` / :func:`parse_trace_context`), with
a hop number and a resume attempt index. Every trace records the parsed
context (:meth:`RequestTrace.set_context`) plus this process's
``epoch_ns`` anchor (:attr:`Tracer.epoch_ns`), so the router-side
aggregator can fetch each involved replica's matching traces
(:meth:`Tracer.export_fleet`), clock-align them on the anchors and merge
them into one Perfetto-loadable trace with per-hop process lanes
(:func:`merge_fleet_traces`).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time

__all__ = ["Tracer", "RequestTrace", "NULL_TRACE", "TRACER",
           "PIN_REASONS", "trace_ring_capacity", "rid_args",
           "TRACE_HEADER", "format_trace_context", "parse_trace_context",
           "merge_fleet_traces"]

# the propagated trace-context header: the router stamps it on
# every internal dispatch — /chat, /completion, /internal/prefill,
# /internal/kv and every resume re-dispatch — so each hop's trace records
# which fleet request it served, at which hop, on which resume attempt
TRACE_HEADER = "X-DLP-Trace"


def format_trace_context(fleet_id: str, hop: int = 0,
                         attempt: int = 0) -> str:
    """Wire form of the propagated context: ``<fleet_id>;hop=N;attempt=M``
    ``fleet_id`` is the router
    trace's request id — the one id the client already has from
    ``X-DLP-Router-Request-Id`` and the one ``/debug/trace/fleet?id=``
    stitches on. ``attempt`` is the resume re-dispatch index (satellite:
    attempt 0 and attempt 1 stitch as siblings, not one mangled span)."""
    return f"{fleet_id};hop={int(hop)};attempt={int(attempt)}"


def parse_trace_context(header: str | None) -> dict | None:
    """Parse an ``X-DLP-Trace`` header into ``{fleet_id, hop, attempt}``.
    Tolerant by design — a malformed header from an older (or foreign)
    router degrades to None / defaulted fields, never an exception on the
    serving path."""
    if not header or not isinstance(header, str):
        return None
    parts = header.split(";")
    fleet_id = parts[0].strip()
    if not fleet_id or len(fleet_id) > 128:
        return None
    ctx = {"fleet_id": fleet_id, "hop": 0, "attempt": 0}
    for part in parts[1:]:
        key, _, val = part.partition("=")
        key = key.strip()
        if key in ("hop", "attempt"):
            try:
                ctx[key] = int(val)
            except ValueError:
                pass
    return ctx


def rid_args(trace) -> dict:
    """``request_id`` kwargs fragment for a terminal ``done``/``error``
    event — the one id shared by the SSE stream, the JSON finish log and
    ``/debug/trace``. Empty when tracing is off (``NULL_TRACE`` is
    falsy), so call sites splat it unconditionally."""
    return {"request_id": trace.request_id} if trace else {}

# finish reasons that pin a trace past normal ring eviction: everything
# that is NOT a clean stop/length finish is an incident worth keeping
PIN_REASONS = frozenset({"error", "timeout", "abort", "shed"})


def trace_ring_capacity() -> int:
    return max(1, int(os.environ.get("DLP_TRACE_RING", "64")))


class _NullTrace:
    """Falsy no-op stand-in returned while tracing is disabled: every
    surface of :class:`RequestTrace` exists and does nothing, so call
    sites never branch except where allocation would happen."""

    __slots__ = ()
    request_id = None

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **args) -> "_NullSpan":
        return _NULL_SPAN

    def begin_span(self, name: str, **args) -> "_NullSpan":
        return _NULL_SPAN

    def add_span(self, name, t0, t1, **args) -> None:
        pass

    def set_context(self, fleet_id, hop: int = 0,
                    attempt: int = 0) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def finish(self, reason: str, **stats) -> None:
        pass

    def join_profile(self, trace_path: str) -> int:
        return 0


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self) -> None:
        pass


# stateless falsy singletons: the DLP_TRACE=0 fast path (`if trace:` — one attribute read + branch per event) shares
# them across every thread with no lock by design
NULL_TRACE = _NullTrace()
_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Live span handle: records onto its trace when closed (context
    manager exit or explicit ``end()``). Never recorded if leaked — which
    is the bug to avoid at the call site."""

    __slots__ = ("_trace", "name", "args", "t0", "_done")

    def __init__(self, trace: "RequestTrace", name: str, args: dict):
        self._trace = trace
        self.name = name
        self.args = args
        self.t0 = time.monotonic()
        self._done = False

    def __enter__(self) -> "_SpanCtx":
        self.t0 = time.monotonic()  # re-anchor: enter may follow creation
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end()
        return False

    def end(self) -> None:
        if not self._done:
            self._done = True
            self._trace.add_span(self.name, self.t0, time.monotonic(),
                                 **self.args)


class RequestTrace:
    """One request's span tree + event log. Appends are lock-free (GIL
    list appends) because producers are the scheduler worker, the
    watchdog and the serving thread — each appends whole records."""

    __slots__ = ("request_id", "kind", "meta", "t0", "t0_epoch_ns", "t1",
                 "finish_reason", "stats", "spans", "events", "_tracer",
                 "done", "_finish_lock", "ctx")

    def __init__(self, tracer: "Tracer", request_id: str, kind: str,
                 meta: dict):
        self._tracer = tracer
        self.request_id = request_id
        self.kind = kind
        self.meta = meta
        # propagated fleet trace context: {fleet_id, hop,
        # attempt} parsed from X-DLP-Trace, None for a local request
        self.ctx: dict | None = None
        self.t0 = time.monotonic()
        self.t0_epoch_ns = time.time_ns()
        self.t1: float | None = None
        self.finish_reason: str | None = None
        self.stats: dict = {}
        # (name, t0, t1, args) host spans — flat; tree shape is recovered
        # from interval containment (Perfetto renders nesting the same way)
        self.spans: list[tuple[str, float, float, dict]] = []
        # (name, t, fields) typed instant events
        self.events: list[tuple[str, float, dict]] = []
        self.done = False
        self._finish_lock = threading.Lock()

    def __bool__(self) -> bool:
        return True

    # -- recording surfaces

    def span(self, name: str, **args) -> _SpanCtx:
        """Context-managed span: ``with trace.span("prefill"): ...``."""
        return _SpanCtx(self, name, args)

    def begin_span(self, name: str, **args) -> _SpanCtx:
        """Manual span — the caller MUST ``end()`` it in a ``finally``."""
        return _SpanCtx(self, name, args)

    def add_span(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a completed span from explicit monotonic endpoints (the
        hot-path surface: begin and end may live in different functions,
        e.g. the scheduler's chunk launch vs its overlapped readback)."""
        self.spans.append((name, t0, t1, args))

    def set_context(self, fleet_id, hop: int = 0,
                    attempt: int = 0) -> None:
        """Record the propagated fleet trace context this request served
        under: the router's fleet trace id, the hop number of
        this process in the request's path, and the resume attempt index.
        The fleet aggregator finds this trace by it
        (:meth:`Tracer.find_fleet`)."""
        if fleet_id:
            self.ctx = {"fleet_id": str(fleet_id), "hop": int(hop),
                        "attempt": int(attempt)}

    def event(self, name: str, **fields) -> None:
        """Typed instant event (deadline_exceeded, quarantine, shed,
        watchdog_stall, pool_exhausted, ...)."""
        self.events.append((name, time.monotonic(), fields))

    def finish(self, reason: str, **stats) -> None:
        """Seal the trace: close the root span, emit the structured JSON
        log line, move the trace from live to the ring. Idempotent — the
        first finish wins (a watchdog finish beats the worker's late
        one); the lock makes the done check-and-set atomic across the
        watchdog and worker threads so the trace cannot seal twice."""
        with self._finish_lock:
            if self.done:
                return
            self.done = True
            self.t1 = time.monotonic()
            self.finish_reason = reason
            self.stats = {k: v for k, v in stats.items() if v is not None}
        self._tracer._seal(self)

    # -- views --------------------------------------------------------------

    def to_epoch_ns(self, t_mono: float) -> int:
        return self.t0_epoch_ns + int((t_mono - self.t0) * 1e9)

    def span_names(self) -> list[str]:
        return [s[0] for s in self.spans]

    def span_durations_ms(self) -> dict[str, float]:
        """Aggregate duration per span family (``decode[3]`` folds into
        ``decode``) — the compact per-phase timing the JSON log carries."""
        out: dict[str, float] = {}
        for name, t0, t1, _ in self.spans:
            fam = name.split("[", 1)[0]
            out[fam] = out.get(fam, 0.0) + (t1 - t0) * 1000.0
        return {k: round(v, 3) for k, v in out.items()}

    def tree(self) -> dict:
        """Span tree by interval containment: each span becomes a child of
        the smallest span that contains it; top-level spans hang off the
        implicit root. For tests and human inspection — Perfetto derives
        the same nesting visually."""
        root = {"name": "request", "t0": self.t0,
                "t1": self.t1 if self.t1 is not None else time.monotonic(),
                "children": []}
        nodes = [{"name": n, "t0": a, "t1": b, "args": args, "children": []}
                 for n, a, b, args in sorted(self.spans,
                                             key=lambda s: (s[1], -s[2]))]
        for node in nodes:
            parent = root
            # candidate parents appear before the node in sorted order
            for cand in nodes:
                if cand is node:
                    break
                if (cand["t0"] <= node["t0"]
                        and node["t1"] <= cand["t1"]
                        and (cand["t1"] - cand["t0"]
                             >= node["t1"] - node["t0"])):
                    parent = cand
            parent["children"].append(node)
        return root

    def summary(self) -> dict:
        return {
            "request_id": self.request_id,
            "kind": self.kind,
            **({"trace_context": self.ctx} if self.ctx else {}),
            "finish_reason": self.finish_reason,
            "start_unix_ns": self.t0_epoch_ns,
            "duration_ms": (round((self.t1 - self.t0) * 1000.0, 3)
                            if self.t1 is not None else None),
            "pinned": self.finish_reason in PIN_REASONS,
            "spans": len(self.spans),
            "events": [e[0] for e in self.events],
            **{k: v for k, v in self.stats.items()
               if k in ("n_prompt", "n_gen", "ttft_ms", "model")},
        }

    # -- device-time correlation (torch.profiler join) ---------------------

    def join_profile(self, trace_path: str) -> int:
        """Join device timelines from a ``torch.profiler`` Chrome trace (a
        ``trace.json`` file, or a ``--profile-dir`` whose newest run is
        read) onto this trace as ``device:*`` spans. Returns the number
        joined.

        Timebase handling, the reference's rules: when a timeline's
        absolute range (the profiler's ``baseTimeNanoseconds`` plus the
        event offsets) overlaps the request's wall-clock window the overlap
        is clipped in (``correlation: "clock"``); otherwise the whole
        timeline is attributed to the request that ran under the profiler
        session, flagged ``correlation: "coarse"``."""
        from .profile_trace import timelines

        tl = timelines(trace_path)
        if not tl:
            return 0
        mode, lanes = tl["mode"], tl["timelines"]
        win0_ps = self.t0_epoch_ns * 1000
        win1_ps = self.to_epoch_ns(self.t1 if self.t1 is not None
                                   else time.monotonic()) * 1000
        joined = 0
        for name, d in sorted(lanes.items()):
            s, e, busy = d["start_ps"], d["end_ps"], d["busy_ps"]
            if s < win1_ps and e > win0_ps and e - s < 2 * (win1_ps - win0_ps):
                # plausible shared timebase: clip into the request window
                cs, ce = max(s, win0_ps), min(e, win1_ps)
                t0 = self.t0 + (cs - win0_ps) / 1e12
                t1 = self.t0 + (ce - win0_ps) / 1e12
                corr = "clock"
            else:
                # timebase mismatch: attribute the whole timeline to this
                # request's window, coarsely
                span_s = max(1, e - s)
                t0, t1 = self.t0, self.t0 + span_s / 1e12
                corr = "coarse"
            window_ps = max(1, e - s)
            self.add_span(f"device:{name}", t0, t1,
                          busy_ms=round(busy / 1e9, 3),
                          bubble_pct=round(
                              100.0 * (1.0 - min(busy, window_ps)
                                       / window_ps), 2),
                          mode=mode, correlation=corr)
            joined += 1
        return joined

    # -- Chrome trace-event export ------------------------------------------

    def export(self) -> dict:
        """Chrome/Perfetto trace-event JSON (load in ui.perfetto.dev)."""
        def us(t: float) -> float:
            return round((t - self.t0) * 1e6, 3)

        t_end = self.t1 if self.t1 is not None else time.monotonic()
        ev: list[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": f"request {self.request_id}"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "host"}},
            {"ph": "X", "pid": 1, "tid": 0, "name": "request",
             "ts": 0.0, "dur": us(t_end) or 0.001,
             "args": {"request_id": self.request_id,
                      "finish_reason": self.finish_reason, **self.stats}},
        ]
        dev_tids: dict[str, int] = {}
        for name, t0, t1, args in self.spans:
            tid = 0
            if name.startswith("device:"):
                dev = name[len("device:"):]
                if dev not in dev_tids:
                    dev_tids[dev] = 1000 + len(dev_tids)
                    ev.append({"ph": "M", "pid": 1, "tid": dev_tids[dev],
                               "name": "thread_name", "args": {"name": dev}})
                tid = dev_tids[dev]
            ev.append({"ph": "X", "pid": 1, "tid": tid, "name": name,
                       "ts": us(t0), "dur": max(0.001, us(t1) - us(t0)),
                       "args": args})
        for name, t, fields in self.events:
            ev.append({"ph": "i", "s": "t", "pid": 1, "tid": 0,
                       "name": name, "ts": us(t), "args": fields})
        from .events import serving_identity

        return {"displayTimeUnit": "ms", "traceEvents": ev,
                "otherData": {"request_id": self.request_id,
                              "kind": self.kind,
                              "start_unix_ns": self.t0_epoch_ns,
                              # this process's clock anchor + replica
                              # identity: the fleet merger aligns and
                              # labels hops on these
                              "process_epoch_ns": self._tracer.epoch_ns,
                              **({"trace_context": self.ctx}
                                 if self.ctx else {}),
                              **serving_identity(),
                              "finish_reason": self.finish_reason}}


class Tracer:
    """Process-wide trace registry: live traces by id, a bounded ring of
    finished traces (failures pinned), and the structured-JSON finish
    log. A module-level default (``TRACER``) serves the runtime; tests
    construct their own."""

    def __init__(self, capacity: int | None = None,
                 pin_capacity: int | None = None,
                 enabled: bool | None = None, json_log: bool | None = None,
                 log_stream=None):
        self.capacity = capacity or trace_ring_capacity()
        # pinned (failure) traces get 4x the normal ring before eviction
        self.pin_capacity = pin_capacity or 4 * self.capacity
        self.enabled = (os.environ.get("DLP_TRACE", "1") != "0"
                        if enabled is None else enabled)
        self.json_log = (os.environ.get("DLP_JSON_LOG", "1") != "0"
                         if json_log is None else json_log)
        self.log_stream = log_stream  # None -> sys.stderr at emit time
        # per-process clock anchor: the wall-clock instant this
        # tracer was born, exported with every trace so the fleet merger
        # can align hops recorded by different processes' clocks
        self.epoch_ns = time.time_ns()
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._live: dict[str, RequestTrace] = {}
        self._ring: list[RequestTrace] = []   # finished, oldest first

    # -- lifecycle ----------------------------------------------------------

    def start_request(self, kind: str = "request",
                      **meta) -> RequestTrace | _NullTrace:
        if not self.enabled:
            return NULL_TRACE
        rid = f"req-{next(self._seq):08x}"
        tr = RequestTrace(self, rid, kind, meta)
        with self._lock:
            self._live[rid] = tr
            # a leaked live trace (consumer vanished before any finish
            # path ran) must not grow unboundedly: evict oldest live
            # entries past 4x ring capacity
            while len(self._live) > 4 * self.capacity:
                old = next(iter(self._live))
                self._live.pop(old)
        return tr

    def _seal(self, tr: RequestTrace) -> None:
        with self._lock:
            self._live.pop(tr.request_id, None)
            self._ring.append(tr)
            # three eviction pools: clean finishes (ring), sheds (their own
            # cap — an overload hammers out hundreds of 429s per second and
            # must not flush last night's quarantine), and real failures
            unpinned = [t for t in self._ring
                        if t.finish_reason not in PIN_REASONS]
            shed = [t for t in self._ring if t.finish_reason == "shed"]
            pinned = [t for t in self._ring
                      if t.finish_reason in PIN_REASONS
                      and t.finish_reason != "shed"]
            evict: set[str] = set()
            if len(unpinned) > self.capacity:
                evict |= {t.request_id
                          for t in unpinned[:len(unpinned) - self.capacity]}
            if len(shed) > self.capacity:
                evict |= {t.request_id
                          for t in shed[:len(shed) - self.capacity]}
            if len(pinned) > self.pin_capacity:
                evict |= {t.request_id
                          for t in pinned[:len(pinned) - self.pin_capacity]}
            if evict:
                self._ring = [t for t in self._ring
                              if t.request_id not in evict]
        if self.json_log:
            self._log_finish(tr)

    def record_shed(self, reason: str, status: int, **meta) -> str | None:
        """A request refused at admission (queue full, stalled device,
        poisoned, deadline-infeasible) still gets a (pinned) trace: the
        shed IS the lifecycle. Returns the request id, None if
        disabled."""
        tr = self.start_request(kind="shed", **meta)
        if not tr:
            return None
        tr.event("shed", reason=reason, status=status)
        tr.finish("shed", shed_reason=reason, status=status)
        return tr.request_id

    # -- queries ------------------------------------------------------------

    def get(self, request_id: str) -> RequestTrace | None:
        with self._lock:
            if request_id in self._live:
                return self._live[request_id]
            for tr in reversed(self._ring):
                if tr.request_id == request_id:
                    return tr
        return None

    def attach_span(self, request_id: str | None, name: str, t0: float,
                    t1: float, **args) -> bool:
        """Record a span onto a trace by id — live or already sealed. The
        serving layer uses this to add queue/stream spans it measured
        around an engine whose done event carried the id."""
        if not request_id:
            return False
        tr = self.get(request_id)
        if tr is None:
            return False
        tr.add_span(name, t0, t1, **args)
        return True

    def requests(self) -> list[dict]:
        """Newest-first summaries of every finished trace in the ring plus
        in-flight ones (no finish_reason yet)."""
        with self._lock:
            ring = list(self._ring)
            live = list(self._live.values())
        return ([t.summary() for t in reversed(ring)]
                + [t.summary() for t in live])

    def export(self, request_id: str) -> dict | None:
        tr = self.get(request_id)
        return tr.export() if tr is not None else None

    def find_fleet(self, fleet_id: str) -> list[RequestTrace]:
        """Every trace this process recorded under ``fleet_id`` — matched
        ONLY on the propagated context (:meth:`RequestTrace.set_context`).
        The router's own hop-0 trace qualifies because it stamps its
        minted id onto itself at request start; matching the bare local
        request id as well would be wrong: rid namespaces are per-process
        (``req-%08x``), so an unrelated request on another tracer can
        collide with the fleet id and get swept into the merge. Oldest
        first, so merged lanes read in hop order."""
        if not fleet_id:
            return []
        with self._lock:
            cands = list(self._ring) + list(self._live.values())
        out = [tr for tr in cands
               if tr.ctx is not None
               and tr.ctx.get("fleet_id") == fleet_id]
        out.sort(key=lambda tr: tr.t0_epoch_ns)
        return out

    def export_fleet(self, fleet_id: str) -> dict:
        """The per-process half of the fleet aggregator (``GET
        /debug/trace?fleet=`` on every replica):
        all matching traces' exports plus this process's clock anchor."""
        return {"fleet_id": fleet_id,
                "epoch_ns": self.epoch_ns,
                "traces": [tr.export() for tr in self.find_fleet(fleet_id)]}

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._ring.clear()

    # -- structured JSON log ------------------------------------------------

    def _log_finish(self, tr: RequestTrace) -> None:
        from .events import serving_identity

        spans_ms = tr.span_durations_ms()
        line = {
            "event": "request_finish",
            # replica id/epoch when this process serves in a router fleet
            # (serving/router.py): fleet logs stay attributable without
            # the router's access log
            **serving_identity(),
            "request_id": tr.request_id,
            "kind": tr.kind,
            "finish_reason": tr.finish_reason,
            "start_unix_ns": tr.t0_epoch_ns,
            "duration_ms": round((tr.t1 - tr.t0) * 1000.0, 3),
            "spans_ms": spans_ms,
            "events": [e[0] for e in tr.events],
            **tr.stats,
        }
        # per-phase step-time breakdown + explicit decode rate: logs alone must answer "was this request slow on
        # device or in queue" — chunk counts + mean step wall per phase
        # next to the aggregate spans_ms
        if "tok_s" in tr.stats:
            line["decode_tok_s"] = tr.stats["tok_s"]
        for fam in ("decode", "prefill_chunk"):
            n = sum(1 for s in tr.spans if s[0].startswith(f"{fam}["))
            if n:
                line[f"{fam}_chunks"] = n
                line[f"{fam}_step_ms_avg"] = round(
                    spans_ms.get(fam, 0.0) / n, 3)
        stream = self.log_stream or sys.stderr
        try:
            stream.write(json.dumps(line, sort_keys=True,
                                    default=str) + "\n")
            stream.flush()
        except (OSError, ValueError):  # closed stderr (interpreter exit)
            pass


# -- fleet trace stitching ---------------------------------------------------
#
# The router-side aggregator fetches every involved replica's matching
# traces (Tracer.export_fleet over HTTP) and hands them here: one merged
# Chrome/Perfetto trace with a process lane per hop, clock-aligned on the
# per-trace epoch anchors, flow events across the handoff/resume edges,
# and the SLO budget attribution — where the request's wall-clock went.


def _trace_class(other: dict) -> str:
    """Which hop role a fetched trace export played, from its metadata:
    router (hop 0), prefill (publication), kv_import (the decode-side
    handoff import) or generate (a token-producing attempt)."""
    if other.get("kind") == "router":
        return "router"
    if other.get("kind") == "kv_import":
        return "kv_import"
    if other.get("finish_reason") == "published":
        return "prefill"
    return "generate"


def _span_ms(entries: list[dict], families: tuple[str, ...],
             classes: tuple[str, ...] | None = None) -> float:
    """Total duration (ms) of every span whose family (name up to ``[``)
    matches, across the selected entry classes."""
    total = 0.0
    for e in entries:
        if classes is not None and e["cls"] not in classes:
            continue
        for ev in e["events"]:
            if ev.get("ph") != "X":
                continue
            fam = ev.get("name", "").split("[", 1)[0]
            if fam in families:
                total += ev.get("dur", 0.0) / 1000.0
    return total


def _root_window(entry: dict) -> tuple[float, float] | None:
    """(start, end) µs of an entry's root ``request`` span on the merged
    timeline, or the full event envelope when no root was exported."""
    lo = hi = None
    for ev in entry["events"]:
        if ev.get("ph") == "X" and ev.get("name") == "request":
            return ev["ts"], ev["ts"] + ev.get("dur", 0.0)
        if ev.get("ph") in ("X", "i"):
            t0 = ev.get("ts", 0.0)
            t1 = t0 + ev.get("dur", 0.0)
            lo = t0 if lo is None else min(lo, t0)
            hi = t1 if hi is None else max(hi, t1)
    return (lo, hi) if lo is not None else None


def _fleet_budget(entries: list[dict]) -> dict:
    """SLO budget attribution: decompose the
    client-observed latency — the router trace's root span — into where
    it went. ``other_ms`` is the SIGNED residual (wire/SSE/python
    overhead the named phases don't cover), so the components sum to
    ``total_ms`` exactly by construction."""
    router = [e for e in entries if e["cls"] == "router"]
    if router:
        win = _root_window(router[0])
        total = (win[1] - win[0]) / 1000.0 if win else 0.0
    else:
        wins = [w for w in (_root_window(e) for e in entries) if w]
        total = ((max(w[1] for w in wins) - min(w[0] for w in wins))
                 / 1000.0 if wins else 0.0)
    replica = ("prefill", "kv_import", "generate")
    budget = {
        "queue_wait_ms": _span_ms(entries, ("queue",), replica),
        "prefill_ms": _span_ms(entries, ("prefill", "prefill_chunk"),
                               replica),
        "handoff_wire_ms": 0.0,
        "adoption_ms": _span_ms(entries, ("handoff_import",)),
        "decode_ms": _span_ms(entries, ("decode",), ("generate",)),
        "swap_ms": _span_ms(entries, ("swap_out", "swap_in"), replica),
        "resume_gap_ms": _span_ms(entries, ("resume_gap",), ("router",)),
    }
    # handoff wire: the router-side serialize→import round trips minus
    # the replica-side compute they contained (publication queue+prefill
    # and the import itself — serialize time stays IN the wire bucket)
    wire = _span_ms(entries, ("prefill_wire", "kv_wire"), ("router",))
    contained = (_span_ms(entries, ("queue", "prefill", "prefill_chunk"),
                          ("prefill",))
                 + budget["adoption_ms"])
    budget["handoff_wire_ms"] = max(0.0, wire - contained)
    budget = {k: round(v, 3) for k, v in budget.items()}
    budget["other_ms"] = round(total - sum(budget.values()), 3)
    budget["total_ms"] = round(total, 3)
    return budget


def merge_fleet_traces(sources: list[dict],
                       fleet_id: str | None = None) -> dict:
    """Stitch per-process trace exports into ONE Chrome/Perfetto trace.

    ``sources`` is a list of ``{"label": str, "traces": [export, ...]}``
    — the router's own export plus each replica's ``export_fleet``
    payload. Each export's ``otherData.start_unix_ns`` epoch anchor maps
    its relative span timestamps onto the shared fleet timeline (the
    earliest anchor is merged t=0); an export with NO anchor degrades to
    *unaligned-with-warning* — placed at t=0 and named in
    ``otherData.warnings`` — never silently wrong. Traces seen through
    more than one source (an in-process fleet sharing one tracer)
    deduplicate on ``(request_id, start_unix_ns)``.

    Each trace gets its own process lane (per-hop pid), labeled with its
    hop class, replica identity and resume attempt; ``ph: s/f`` flow
    events link the handoff chain (prefill → import → first generation
    attempt) and each resume edge (attempt n → attempt n+1). The
    ``budget_ms`` block carries the SLO attribution (:func:`_fleet_budget`)."""
    entries: list[dict] = []
    warnings: list[str] = []
    seen: set = set()
    for src in sources:
        label = str(src.get("label") or "?")
        for exp in src.get("traces") or []:
            other = dict(exp.get("otherData") or {})
            key = (other.get("request_id"), other.get("start_unix_ns"))
            if key in seen:
                continue
            seen.add(key)
            ctx = other.get("trace_context") or {}
            entries.append({
                "label": label, "other": other,
                "anchor": other.get("start_unix_ns"),
                "cls": _trace_class(other),
                "hop": ctx.get("hop"), "attempt": ctx.get("attempt", 0),
                "raw": exp.get("traceEvents") or [], "events": [],
            })
    anchors = [e["anchor"] for e in entries if e["anchor"] is not None]
    base = min(anchors) if anchors else None
    order = {"router": 0, "prefill": 1, "kv_import": 2, "generate": 3}
    entries.sort(key=lambda e: (order.get(e["cls"], 9), e["attempt"],
                                e["anchor"] or 0))
    merged: list[dict] = []
    for pid, e in enumerate(entries, start=1):
        if e["anchor"] is None or base is None:
            offset = 0.0
            warnings.append(
                f"trace {e['other'].get('request_id')!r} from "
                f"{e['label']!r} has no start_unix_ns epoch anchor; "
                f"placed UNALIGNED at merged t=0")
        else:
            offset = (e["anchor"] - base) / 1000.0   # ns -> µs
        rid = e["other"].get("request_id")
        bits = [e["cls"]]
        if e["hop"] is not None:
            bits.append(f"hop{e['hop']}")
        if e["other"].get("replica"):
            bits.append(str(e["other"]["replica"]))
        if e["cls"] == "generate" and e["other"].get("trace_context"):
            bits.append(f"attempt{e['attempt']}")
        lane = " ".join(bits) + f" {rid}"
        for ev in e["raw"]:
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    ev["args"] = {"name": lane}
            else:
                ev["ts"] = round(ev.get("ts", 0.0) + offset, 3)
            e["events"].append(ev)
        merged.extend(e["events"])
    # flow events across the cross-process edges
    flow_id = itertools.count(1)

    def link(src: dict, dst: dict, cat: str) -> None:
        sw, dw = _root_window(src), _root_window(dst)
        if sw is None or dw is None:
            return
        fid = next(flow_id)
        spid = entries.index(src) + 1
        dpid = entries.index(dst) + 1
        merged.append({"ph": "s", "cat": cat, "name": cat, "id": fid,
                       "pid": spid, "tid": 0, "ts": round(sw[1], 3)})
        merged.append({"ph": "f", "bp": "e", "cat": cat, "name": cat,
                       "id": fid, "pid": dpid, "tid": 0,
                       "ts": round(max(dw[0], sw[1]), 3)})

    prefill = [e for e in entries if e["cls"] == "prefill"]
    imports = [e for e in entries if e["cls"] == "kv_import"]
    gens = sorted((e for e in entries if e["cls"] == "generate"),
                  key=lambda e: (e["attempt"], e["anchor"] or 0))
    routers = [e for e in entries if e["cls"] == "router"]
    if prefill and imports:
        link(prefill[0], imports[0], "handoff")
    if imports and gens:
        link(imports[0], gens[0], "handoff")
    elif routers and prefill:
        link(routers[0], prefill[0], "handoff")
    for a, b in zip(gens, gens[1:]):
        if b["attempt"] != a["attempt"]:
            link(a, b, "resume")
    return {"displayTimeUnit": "ms", "traceEvents": merged,
            "otherData": {"fleet_id": fleet_id,
                          "processes": len(entries),
                          "aligned": not warnings and bool(entries),
                          "warnings": warnings},
            "budget_ms": _fleet_budget(entries)}


# the process-wide default tracer the runtime and serving layers share
TRACER = Tracer()
