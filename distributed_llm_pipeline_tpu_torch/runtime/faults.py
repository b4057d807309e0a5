"""Deterministic fault injection for the request lifecycle.

The counterpart of ``distributed_llm_pipeline_tpu/runtime/faults.py`` (a
copy: the port imports nothing of the JAX package). Slot quarantine, the
poison detector, the decode watchdog and preemption are only trustworthy
if every failure path can be exercised on demand, on the CPU, in a test.
This module is that switchboard: a catalog of named fault points threaded
through the engine, the scheduler and the paged allocator, armed
deterministically (fire on the Nth evaluation, M times, optionally only
when the call-site context matches), with no work on the hot path while
disarmed.

Call-site contract (the whole hot-path cost is one module-attribute read
and a branch)::

    from . import faults
    ...
    if faults.ACTIVE:
        faults.check("decode_chunk_crash", row=r)      # raises InjectedFault
    if faults.ACTIVE and faults.fires("pool_exhausted"):
        raise PoolExhausted("injected")                # site-typed exception
    if faults.ACTIVE:
        faults.stall("device_stall")                   # sleeps spec.seconds

Arming:

- test API: ``faults.arm("prefill_oom", skip=1, times=1)`` /
  ``faults.disarm()``, or the ``with faults.armed(...):`` context manager
  (always disarms, even when the test body raises);
- environment: ``DLP_FAULTS="decode_chunk_crash:skip=2,times=1;
  device_stall:seconds=5"``, parsed once at import, so a served process
  can be chaos-tested without code changes.

Trigger semantics: an armed point counts only evaluations whose context
matches every ``match`` key (e.g. ``row=1``); the first ``skip`` matching
evaluations pass, the next ``times`` fire, everything after passes again.
The counters live on the spec (``hits`` / ``fired``) for test assertions.
The router-tier points are in the catalog with the reference's names; no
code of the port reaches them yet.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

# Fast-path flag: call sites guard with ``if faults.ACTIVE:`` so a disarmed
# process pays one attribute read and a branch per fault point. Lock-free on
# purpose: writers go through _refresh() under _lock, and a reader racing an
# arm evaluates one point against the previous state, which the skip/times
# semantics absorb.
ACTIVE = False

POINTS = {
    "prefill_oom": "prefill allocation/forward fails (simulated device OOM)",
    "decode_chunk_crash": "one row's host-side work fails while a decode "
                          "chunk is consumed (slot-isolation fodder)",
    "prefill_chunk_crash": "one row fails mid-CHUNKED-prefill — at a fed "
                           "chunk boundary or in the finishing sub-chunk "
                           "(quarantine fodder; siblings keep decoding)",
    "device_stall": "a device step hangs for `seconds` (watchdog fodder)",
    "pool_exhausted": "KV block pool allocation fails (degradation ladder)",
    "tokenizer_error": "prompt tokenization raises",
    "engine_build_crash": "engine factory raises during (re)build",
    # -- router tier: a second tier above the engine points, evaluated in
    # the router process; context key `replica` scopes a spec to one replica
    "replica_death": "the routed replica is hard-killed mid-stream "
                     "(typed SSE error to that request; siblings on other "
                     "replicas are untouched)",
    "replica_slow": "proxying to the routed replica stalls for `seconds` "
                    "(slow-replica fodder for the EWMA tie-break)",
    "replica_partition": "the routed replica is unreachable at "
                         "connect/poll time (network partition; the "
                         "router fails over)",
    "replica_flap": "the routed replica dies at ADMISSION (connect "
                    "refused before any byte streams) `times` times, "
                    "then heals — circuit-breaker + bounded-respawn "
                    "fodder (arm times=N for die-N-then-heal)",
    "resume_corrupt": "the router's captured token-text prefix is "
                      "truncated by one token at stream-resume capture "
                      "(the continuation splice must regenerate and "
                      "skip the overlap, keeping client output exact)",
    # -- disaggregated prefill/decode serving
    "handoff_corrupt": "one byte of the serialized KV handoff payload "
                       "flips between the prefill and decode pools — the "
                       "decode side's digest check must refuse it (422) "
                       "and the request must still complete via local "
                       "prefill (fallback, never wrong output)",
    "prefill_replica_death": "the prefill-role replica is hard-killed "
                             "mid-handoff (the router re-dispatches the "
                             "prefill, bounded by DLP_ROUTER_RETRIES, "
                             "then falls back to colocated prefill)",
    # -- preemptive scheduling and fleet autoscaling
    "preempt_storm": "a simulated interactive burst: the scheduler's "
                     "preemption check fires as if interactive pressure "
                     "exceeded the budget, forcing a batch-class victim's "
                     "KV + sampling state out through the swap store "
                     "mid-decode (the resumed stream must stay bit-exact "
                     "vs an uninterrupted greedy run, with "
                     "prefill_tokens_total flat across swap-out/swap-in)",
    "autoscale_flap": "the autoscaler's load signal oscillates high/low on "
                      "every poll — spawn/drain decisions may not thrash "
                      "past the full-jitter cooldown bound "
                      "(utils/backoff.py; evaluated in the router process)",
}


class InjectedFault(RuntimeError):
    """Raised by an armed fault point. A RuntimeError, so every recovery
    path (quarantine, ``_fail_all``) handles it exactly like the genuine
    failure it simulates."""

    def __init__(self, point: str):
        super().__init__(f"injected fault: {point} "
                         f"({POINTS.get(point, 'unknown point')})")
        self.point = point


@dataclass
class FaultSpec:
    point: str
    skip: int = 0                 # matching evaluations that pass first
    times: int = 1                # then this many fire
    seconds: float = 0.0          # stall duration (sleep-type points)
    match: dict = field(default_factory=dict)  # ctx keys that must be equal
    hits: int = 0                 # matching evaluations seen
    fired: int = 0                # evaluations that fired

    @property
    def exhausted(self) -> bool:
        return self.fired >= self.times


_lock = threading.Lock()
_specs: dict[str, FaultSpec] = {}


def _refresh() -> None:
    global ACTIVE
    ACTIVE = bool(_specs)


def arm(point: str, *, skip: int = 0, times: int = 1, seconds: float = 0.0,
        **match) -> FaultSpec:
    """Arm one fault point; returns its live spec (hits/fired observable)."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r} "
                         f"(one of {', '.join(sorted(POINTS))})")
    spec = FaultSpec(point, skip=int(skip), times=int(times),
                     seconds=float(seconds), match=dict(match))
    with _lock:
        _specs[point] = spec
        _refresh()
    return spec


def disarm(point: str | None = None) -> None:
    """Disarm one point, or every point (``None``)."""
    with _lock:
        if point is None:
            _specs.clear()
        else:
            _specs.pop(point, None)
        _refresh()


def fires(point: str, **ctx) -> bool:
    """Count one evaluation of ``point`` and decide whether it fires.
    Never raises: sites that need a site-typed exception (PoolExhausted)
    branch on this; everything else uses :func:`check`."""
    with _lock:
        spec = _specs.get(point)
        if spec is None or spec.exhausted:
            return False
        for k, want in spec.match.items():
            if ctx.get(k) != want:
                return False
        spec.hits += 1
        if spec.hits <= spec.skip:
            return False
        spec.fired += 1
        return True


def check(point: str, **ctx) -> None:
    """Raise :class:`InjectedFault` when the armed point fires."""
    if fires(point, **ctx):
        raise InjectedFault(point)


def delay(point: str, **ctx) -> float:
    """The armed spec's ``seconds`` if the point fires, without sleeping
    (for call sites that wait on their own event loop)."""
    with _lock:
        spec = _specs.get(point)
        seconds = spec.seconds if spec is not None else 0.0
    if seconds > 0.0 and fires(point, **ctx):
        return seconds
    return 0.0


def stall(point: str, **ctx) -> float:
    """Sleep the armed spec's ``seconds`` (a simulated hung device step);
    returns the stall duration (0.0 = did not fire)."""
    seconds = delay(point, **ctx)
    if seconds > 0.0:
        time.sleep(seconds)
    return seconds


@contextlib.contextmanager
def armed(point: str, **kwargs):
    """Scoped arming: yields the spec, always disarms the point."""
    spec = arm(point, **kwargs)
    try:
        yield spec
    finally:
        disarm(point)


def arm_from_env(value: str | None = None) -> list[FaultSpec]:
    """Parse ``DLP_FAULTS``: ``point[:k=v[,k=v...]][;point...]``. Known
    keys ``skip`` / ``times`` (int), ``seconds`` (float); anything else is a
    match key (int when it parses, else string)."""
    if value is None:
        value = os.environ.get("DLP_FAULTS", "")
    specs = []
    for part in filter(None, (p.strip() for p in value.split(";"))):
        point, _, args = part.partition(":")
        kw: dict = {}
        for item in filter(None, (a.strip() for a in args.split(","))):
            k, _, v = item.partition("=")
            if k in ("skip", "times"):
                kw[k] = int(v)
            elif k == "seconds":
                kw[k] = float(v)
            else:
                try:
                    kw[k] = int(v)
                except ValueError:
                    kw[k] = v
        specs.append(arm(point.strip(), **kw))
    return specs


def stats() -> dict:
    """Armed-point snapshot: skip, times, hits and fired of each."""
    with _lock:
        return {p: {"skip": s.skip, "times": s.times, "hits": s.hits,
                    "fired": s.fired} for p, s in _specs.items()}


if os.environ.get("DLP_FAULTS"):
    arm_from_env()
