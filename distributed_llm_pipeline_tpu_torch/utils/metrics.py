"""The serving metrics registry: counters, gauges and histograms, rendered
as Prometheus text or JSON at ``GET /metrics``.

A copy of ``distributed_llm_pipeline_tpu/utils/metrics.py`` (the port
imports nothing of the JAX package): the same series names, labels, help
texts, bucket bounds and boot catalog, so a dashboard reads either package
the same way. ``xla_compiles_total`` / ``xla_retraces_total`` keep their
names but count CUDA library builds and loads here (``utils/perf.py``), and
their help texts say so. Every series takes an optional ``labels`` dict; the latency
families in ``BUCKET_BOUNDS`` also keep a cumulative-bucket Prometheus
histogram (``<name>_hist``) beside the reservoir summary.

``BOOT_COUNTERS`` / ``BOOT_HISTOGRAMS`` are the series every engine
registers at 0 when it is built (``preregister_boot_series``), so
Prometheus ``rate()`` has a series before its first incident. Left out
until their slices: the router's boot series and the pipeline-bubble
arithmetic of the mesh. The profiler trace is ``utils/profile_trace.py``.
"""

from __future__ import annotations

import bisect
import json
import random
import threading

LabelItems = tuple  # tuple[tuple[str, str], ...] — sorted, hashable

# -- documented boot series (docs/OBSERVABILITY.md catalog) -----------------
# counters every engine pre-registers at 0 so a fresh process exposes the
# full schema (a dashboard must distinguish "never fired" from "not wired")
BOOT_COUNTERS = (
    "requests_total", "prompt_tokens_total", "generated_tokens_total",
    "prefill_tokens_total", "requests_aborted_total",
    "prefix_cache_hits_total", "prefix_cache_tokens_total",
    "context_shifts_total", "engine_restarts_total",
    "scheduler_faults_total",
    # resilience families (docs/RESILIENCE.md)
    "requests_timed_out_total", "slots_quarantined_total",
    "watchdog_stalls_total", "requests_shed_total",
    "requests_poisoned_total",
    # SLO-aware scheduling (docs/SCHEDULING.md): mixed steps decode rows
    # paid while a prefill chunk rode along
    "prefill_steps_stolen_total",
    # kernel builds (utils/perf.py): the reference's series names, which
    # count XLA compiles there; here CUDA library builds and loads
    # (labelled series carry {entry=<source>}) and repeats of a loaded
    # source
    "xla_compiles_total", "xla_retraces_total",
    # fused decode-step kernel (ops/fused_decode.py): requested
    # via DLP_FUSED_DECODE=1 but resolved to the unfused fallback
    # (labeled series carry {reason=})
    "fused_decode_fallbacks_total",
    # capability lattice (runtime/capabilities.py): feature
    # requests the lattice degraded to a servable cell (labeled series
    # carry {axis=,reason=} with the reason FAMILY from DEGRADE_REASONS)
    "capability_degradations_total",
    # disaggregated prefill/decode serving (runtime/disagg.py):
    # publication/adoption outcomes (labeled series carry {result=} —
    # published/adopted/imported/fallback/expired/corrupt/rejected)
    # and handoff
    # payload traffic (labeled series carry {mode=} — the pool
    # representation: dense/q8_0/latent/latent_q8_0)
    "kv_handoffs_total", "kv_handoff_bytes_total",
    # preemptive multi-tenant scheduling (runtime/scheduler.py):
    # batch-class victims swapped out to host RAM (labeled series carry
    # {class=} — the victim's priority class) and swap lifecycle outcomes
    # (labeled series carry {result=} — out/in/expired/evicted/dropped)
    "preemptions_total", "kv_swaps_total",
) + tuple(f"requests_finished_{r}_total"
          for r in ("stop", "length", "abort", "error", "timeout"))

# histogram families pre-registered empty (summary `_count 0` + bucket
# histogram with zeroed buckets) from boot
BOOT_HISTOGRAMS = ("ttft_ms", "decode_tok_s", "queue_wait_ms",
                   "prefill_chunk_tokens", "step_ms", "kv_handoff_ms")

# histogram families ALSO pre-registered per priority class
# (`queue_wait_ms{class="interactive"}` …), so per-class dashboards have
# their series before the first request of that class arrives. The class
# list mirrors runtime.engine.PRIORITY_CLASSES (imported there would be a
# cycle; tests/test_metrics.py asserts the two stay in sync).
BOOT_CLASS_HISTOGRAMS = ("queue_wait_ms",)
BOOT_CLASSES = ("interactive", "normal", "batch")

# families that keep a true cumulative-bucket Prometheus histogram
# (exposed as `<name>_hist`) next to the reservoir summary
BUCKET_BOUNDS: dict[str, tuple] = {
    "ttft_ms": (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                1000.0, 2500.0, 5000.0, 10000.0, 30000.0),
    "queue_wait_ms": (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0),
    "decode_tok_s": (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1000.0, 2500.0),
    # pow2 chunk fills: the mixed step's per-row prompt-token feeds
    "prefill_chunk_tokens": (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                             256.0, 512.0, 1024.0),
    # device step launch -> readback wall time (utils/perf.py step rings;
    # labeled {backend=} by each recorder)
    "step_ms": (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                500.0, 1000.0, 2500.0, 10000.0),
    # prefill→decode KV handoff wall (deserialize + block adoption on the
    # decode pool; router-side it spans prefill dispatch → import ack)
    "kv_handoff_ms": (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 10000.0),
}

# `# HELP` text per family; unknown families fall back to the name
HELP: dict[str, str] = {
    "requests_total": "requests that completed generation (any outcome)",
    "requests_finished_total":
        "requests finished, labeled by model and outcome",
    "prompt_tokens_total": "prompt tokens evaluated",
    "generated_tokens_total": "tokens generated",
    "prefill_tokens_total": "tokens run through prefill (bucket-padded)",
    "requests_aborted_total": "requests aborted (disconnect or error)",
    "prefix_cache_hits_total": "prompts that reused retained prefix KV",
    "prefix_cache_tokens_total": "prompt tokens served from prefix KV",
    "context_shifts_total": "context-shift evictions (llama.cpp shift)",
    "engine_restarts_total": "supervised engine rebuilds",
    "scheduler_faults_total": "whole-scheduler fault recoveries",
    "requests_timed_out_total": "requests past their deadline_ms budget",
    "slots_quarantined_total": "slots failed and reclaimed in isolation",
    "watchdog_stalls_total": "device steps past the stall budget",
    "requests_shed_total": "requests rejected by load shedding",
    "requests_poisoned_total": "requests refused as poisoned",
    "prefill_steps_stolen_total":
        "mixed steps where decode rows shared the device with a prefill "
        "chunk (docs/SCHEDULING.md)",
    "prefill_chunk_tokens":
        "prompt tokens fed per prefill row per mixed step (reservoir "
        "summary)",
    "prefill_chunk_tokens_hist":
        "prompt tokens fed per prefill row per mixed step (cumulative "
        "buckets)",
    "ttft_ms": "time to first token, ms (reservoir summary)",
    "ttft_ms_hist": "time to first token, ms (cumulative buckets)",
    "queue_wait_ms": "admission-to-slot-grant wait, ms (reservoir summary)",
    "queue_wait_ms_hist":
        "admission-to-slot-grant wait, ms (cumulative buckets)",
    "decode_tok_s": "steady-state decode rate, tok/s (reservoir summary)",
    "decode_tok_s_hist":
        "steady-state decode rate, tok/s (cumulative buckets)",
    "xla_compiles_total":
        "CUDA library builds and loads by ops/cuda_build.py, labeled by "
        "source (no XLA on the port)",
    "xla_retraces_total":
        "builds or loads of a CUDA library this process had already loaded "
        "(should stay 0)",
    "step_ms": "device step launch->readback wall, ms (reservoir summary)",
    "step_ms_hist":
        "device step launch->readback wall, ms (cumulative buckets)",
    "step_ms_p50": "rolling-window device step wall p50, ms (per backend)",
    "step_ms_p99": "rolling-window device step wall p99, ms (per backend)",
    "mfu_pct": "rolling-window model FLOPs utilization, percent",
    "hbm_bw_util_pct":
        "rolling-window achieved HBM bandwidth over peak, percent",
    "roofline_pct":
        "rolling-window decode tok/s over the weights-bound ceiling",
    "decode_tok_s_window":
        "rolling-window decode rate over device-busy time, tok/s",
    "hbm_peak_gbps": "HBM peak the roofline model is using, GB/s",
    "model_hbm_gb": "resident model bytes the roofline model is using, GB",
    "queue_wait_est_s": "EWMA-based queue-wait estimate for a new request",
    "queue_depth": "requests waiting for a slot",
    "slots_active": "decode slots currently occupied",
    "slots_total": "decode slots configured",
    "busy": "single-stream decode lock held",
    "kv_pool_blocks_total": "paged-KV physical blocks in the pool",
    "kv_pool_blocks_used": "paged-KV blocks currently referenced",
    "kv_pool_blocks_shared": "paged-KV blocks mapped by more than one slot",
    "kv_pool_block_size": "tokens per paged-KV block",
    "kv_pool_used_bytes": "HBM bytes of referenced paged-KV blocks",
    "kv_pool_shared_ratio": "shared share of referenced paged-KV blocks",
    # disaggregated prefill/decode serving (runtime/disagg.py)
    "kv_handoffs_total":
        "prefill↔decode handoff outcomes (labeled series carry result=: "
        "published/adopted/imported/fallback/expired/corrupt/rejected)",
    "kv_handoff_bytes_total":
        "handoff payload bytes serialized/imported (labeled series carry "
        "mode=: dense/q8_0/latent/latent_q8_0)",
    "kv_handoff_ms":
        "prefill→decode handoff wall, ms (reservoir summary)",
    "kv_handoff_ms_hist":
        "prefill→decode handoff wall, ms (cumulative buckets)",
    "kv_handoffs_pinned":
        "publications pinned awaiting adoption on this pool",
    "kv_pool_pinned_rows":
        "paged-KV rows pinned by a publication (excluded from eviction)",
    "pool_role":
        "this pool's disaggregation role: 0 both / 1 prefill / 2 decode",
    # preemptive scheduling
    "preemptions_total":
        "batch-class victims preempted to the swap store (labeled series "
        "carry class=: the victim's priority class)",
    "kv_swaps_total":
        "swap-store lifecycle outcomes (labeled series carry result=: "
        "out/in/expired/evicted/dropped)",
    "swap_store_bytes":
        "host-RAM bytes held by preempted requests in the swap store",
    "swap_store_entries":
        "preempted requests parked in the swap store",
}


def _labelkey(labels: dict | None) -> LabelItems:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def escape_label_value(v: str) -> str:
    """Prometheus text-exposition label escaping: backslash, double quote
    and newline must be escaped or the scraper rejects the whole body."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(items: LabelItems, extra: tuple = ()) -> str:
    pairs = tuple(items) + tuple(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class Histogram:
    """Reservoir-sampled histogram: O(1) memory, percentile queries.

    Keeps an exact sorted window until ``cap`` observations, then falls back
    to uniform reservoir sampling — good enough for p50/p90/p99 serving
    stats without unbounded growth.
    """

    def __init__(self, cap: int = 2048, seed: int = 0):
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._sample: list[float] = []
        self._rng = random.Random(seed)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._sample) < self.cap:
            bisect.insort(self._sample, v)
        else:
            i = self._rng.randrange(self.count)
            if i < self.cap:
                del self._sample[self._rng.randrange(self.cap)]
                bisect.insort(self._sample, v)

    def percentile(self, p: float) -> float:
        if not self._sample:
            return float("nan")
        idx = min(len(self._sample) - 1, int(p / 100.0 * len(self._sample)))
        return self._sample[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean, "min": self.min,
                "max": self.max, "p50": self.percentile(50),
                "p90": self.percentile(90), "p99": self.percentile(99)}


class BucketHistogram:
    """Fixed-bound cumulative-bucket histogram (the true Prometheus
    ``histogram`` type): counts are exact, aggregate across instances,
    and survive restarts as monotone counters — everything the reservoir
    summary's process-local percentiles cannot give a fleet dashboard."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: tuple):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * len(self.bounds)  # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        i = bisect.bisect_left(self.bounds, v)
        if i < len(self.counts):
            self.counts[i] += 1
        # v > last bound lands only in the implicit +Inf bucket (count)

    def cumulative(self) -> list[tuple[float, int]]:
        out, run = [], 0
        for b, c in zip(self.bounds, self.counts):
            run += c
            out.append((b, run))
        return out

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "buckets": {repr(b): c for b, c in self.cumulative()}}


class Metrics:
    """Thread-safe named counters, gauges, and histograms; every series
    takes an optional ``labels`` dict. Unlabeled series keep their flat
    names in snapshots; labeled ones render as ``name{k="v",...}``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, dict[LabelItems, float]] = {}
        self._gauges: dict[str, dict[LabelItems, float]] = {}
        self._hists: dict[str, dict[LabelItems, Histogram]] = {}
        self._buckets: dict[str, dict[LabelItems, BucketHistogram]] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: dict | None = None) -> None:
        key = _labelkey(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            fam[key] = fam.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: dict | None = None) -> None:
        key = _labelkey(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value: float,
                labels: dict | None = None) -> None:
        if value != value:  # NaN guard (e.g. tok/s of a 1-token request)
            return
        key = _labelkey(labels)
        with self._lock:
            fam = self._hists.setdefault(name, {})
            h = fam.get(key)
            if h is None:
                h = fam[key] = Histogram()
            h.observe(value)
            bounds = BUCKET_BOUNDS.get(name)
            if bounds is not None:
                bfam = self._buckets.setdefault(name, {})
                b = bfam.get(key)
                if b is None:
                    b = bfam[key] = BucketHistogram(bounds)
                b.observe(value)

    def ensure_hist(self, name: str, labels: dict | None = None) -> None:
        """Pre-register an empty histogram family so ``/metrics`` exposes
        ``_count 0`` (and zeroed buckets) before the first observation."""
        key = _labelkey(labels)
        with self._lock:
            self._hists.setdefault(name, {}).setdefault(key, Histogram())
            bounds = BUCKET_BOUNDS.get(name)
            if bounds is not None:
                self._buckets.setdefault(name, {}).setdefault(
                    key, BucketHistogram(bounds))

    def record_request(self, *, n_prompt: int, n_gen: int, ttft_ms: float,
                       tok_s: float) -> None:
        """The per-request stats every engine records (SURVEY.md §6
        north-star: tokens/sec, p50 TTFT)."""
        self.inc("requests_total")
        self.inc("prompt_tokens_total", n_prompt)
        self.inc("generated_tokens_total", n_gen)
        self.observe("ttft_ms", ttft_ms)
        self.observe("decode_tok_s", tok_s)

    # -- snapshots ----------------------------------------------------------

    @staticmethod
    def _flat(fam: dict[str, dict[LabelItems, object]], render) -> dict:
        out = {}
        for name, series in fam.items():
            for key, v in series.items():
                out[name + _fmt_labels(key)] = render(v)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "counters": self._flat(self._counters, lambda v: v),
                "gauges": self._flat(self._gauges, lambda v: v),
                "histograms": self._flat(self._hists,
                                         lambda h: h.summary()),
            }
            if self._buckets:
                snap["buckets"] = self._flat(self._buckets,
                                             lambda b: b.summary())
            return snap

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    # -- Prometheus text exposition (v0.0.4) --------------------------------

    def render_prometheus(self, prefix: str = "dlp") -> str:
        """Prometheus text exposition of everything recorded: ``# HELP``
        ``# TYPE`` per family, escaped label values, summaries that emit
        ``_sum``/``_count`` even when empty (a fresh process must not be
        marked down for exposing a registered-but-unfired series), and
        cumulative-bucket ``<name>_hist`` histograms for the families in
        ``BUCKET_BOUNDS``."""

        def fmt(v: float) -> str:
            # full precision: %g's 6 significant digits would corrupt large
            # counters (token totals pass 1e6 within hours)
            return str(int(v)) if float(v).is_integer() else repr(float(v))

        def head(lines: list, full: str, kind: str, help_key: str) -> None:
            lines.append(f"# HELP {full} "
                         f"{HELP.get(help_key, help_key.replace('_', ' '))}")
            lines.append(f"# TYPE {full} {kind}")

        with self._lock:
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            hists = {n: {k: h.summary() for k, h in s.items()}
                     for n, s in self._hists.items()}
            buckets = {n: {k: (b.cumulative(), b.total, b.count)
                           for k, b in s.items()}
                       for n, s in self._buckets.items()}

        lines: list[str] = []
        for name, series in sorted(counters.items()):
            full = f"{prefix}_{name}"
            head(lines, full, "counter", name)
            for key, v in sorted(series.items()):
                lines.append(f"{full}{_fmt_labels(key)} {fmt(v)}")
        for name, series in sorted(gauges.items()):
            full = f"{prefix}_{name}"
            head(lines, full, "gauge", name)
            for key, v in sorted(series.items()):
                lines.append(f"{full}{_fmt_labels(key)} {fmt(v)}")
        for name, series in sorted(hists.items()):
            full = f"{prefix}_{name}"
            head(lines, full, "summary", name)
            for key, s in sorted(series.items()):
                if s["count"]:
                    for q, pk in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                        lines.append(
                            f"{full}{_fmt_labels(key, (('quantile', str(q)),))}"
                            f" {fmt(s[pk])}")
                # _sum/_count unconditionally: scrapers treat a family that
                # appears with TYPE but no samples as an exposition error
                total = s["mean"] * s["count"] if s["count"] else 0.0
                lines.append(f"{full}_sum{_fmt_labels(key)} {fmt(total)}")
                lines.append(f"{full}_count{_fmt_labels(key)} {s['count']}")
        for name, series in sorted(buckets.items()):
            full = f"{prefix}_{name}_hist"
            head(lines, full, "histogram", f"{name}_hist")
            for key, (cum, total, count) in sorted(series.items()):
                for bound, c in cum:
                    lines.append(
                        f"{full}_bucket"
                        f"{_fmt_labels(key, (('le', fmt(bound)),))} {c}")
                lines.append(
                    f"{full}_bucket{_fmt_labels(key, (('le', '+Inf'),))} "
                    f"{count}")
                lines.append(f"{full}_sum{_fmt_labels(key)} {fmt(total)}")
                lines.append(f"{full}_count{_fmt_labels(key)} {count}")
        return "\n".join(lines) + "\n"


def preregister_boot_series(metrics: Metrics) -> None:
    """Register the documented boot schema at zero (docs/OBSERVABILITY.md
    catalog): every engine calls this from __init__ so ``/metrics`` serves
    the full series set from the first scrape — dashboards never 404 on a
    counter that hasn't fired yet."""
    for name in BOOT_COUNTERS:
        metrics.inc(name, 0)
    for name in BOOT_HISTOGRAMS:
        metrics.ensure_hist(name)
    for name in BOOT_CLASS_HISTOGRAMS:
        for cls in BOOT_CLASSES:
            metrics.ensure_hist(name, labels={"class": cls})
