"""Continuous performance observability: the roofline model on the card's
own peaks, step-time rings, on-demand profiling through ``torch.profiler``
and the kernel-build counters.

A port of ``distributed_llm_pipeline_tpu/utils/perf.py`` (the port imports
nothing of the JAX package). It is the ONE definition of the roofline,
used by the live server (``GET /debug/perf``, the ``/metrics`` gauges), so
"roofline_pct" cannot mean two things:

- **Roofline model**: :func:`hbm_peak_gbps` / :func:`peak_tflops` (env
  override > measured probe > the device's row of :data:`DEVICE_PEAKS` >
  an ``assumed:<platform>`` figure), :func:`roofline_pct` /
  :func:`mfu_pct` / :func:`model_flops_per_token`, and
  :func:`roofline_fields`. The peaks of a device come from its name
  (``torch.cuda.get_device_name``); a name outside the table is labelled
  ``assumed``, never given another card's figures.
- **Step-time rings**: :class:`PerfMonitor` keeps a bounded per-backend
  ring of every decode/mixed device step (its wall time to readback, rows
  active, tokens produced, prefill-vs-decode split) recorded by the
  engine's chunk loop and the SlotScheduler's ``_consume``. Both overlap a
  step's readback with the next launch, so they start a step at its
  launch or at the previous readback, whichever is later: the steps tile
  the wall time of a host-bound stream instead of counting it twice (the
  reference records launch to readback). Rolling-window
  aggregates — ``step_ms`` p50/p99 per backend, windowed decode tok/s
  (overall and per occupancy bucket), achieved HBM bandwidth,
  ``mfu_pct``, ``roofline_pct`` — serve ``GET /debug/perf`` and export as
  labelled gauges on ``/metrics``.
- **On-demand device profiling**: :meth:`PerfMonitor.arm_profile` runs
  ``torch.profiler`` (CPU + CUDA activities) around the next N recorded
  steps (``POST /debug/profile``); the run's Chrome trace is summarized
  (top CUDA kernels by device time, per-device busy time) and joined onto
  the request traces that ran inside the window, as ``--profile-dir``
  does per request.
- **Kernel-build counters**: the series keep the reference's names,
  ``xla_compiles_total`` / ``xla_retraces_total``, but there is no XLA
  here. On the port a *compile* is a build or a load of a CUDA library by
  ``ops/cuda_build.py``, labelled ``{entry=<source>}``; a *retrace* is a
  build or load of a source this process has already loaded, which should
  stay 0. :func:`compile_entry` scopes a launch so a retrace under it can
  be stamped on the affected requests' traces.

Discipline (the ``utils/tracing.py`` / ``runtime/faults.py`` shape):
``DLP_PERF=0`` swaps the monitor for the falsy no-op :data:`NULL_PERF`,
so a disabled perf layer costs one attribute read and a branch per step.
Nothing here imports torch at module scope.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, NamedTuple

__all__ = [
    "DEVICE_PEAKS", "NULL_PERF", "PerfMonitor", "ProfileRun", "CompileScope",
    "compile_counts", "compile_entry", "device_peaks", "hbm_peak_gbps",
    "hbm_probe_gbps", "make_perf_monitor", "metrics_reader", "mfu_pct",
    "model_flops_per_token", "params_nbytes", "peak_tflops", "record_compile", "reset_compile_tracking",
    "retrace_counts", "roofline_fields", "roofline_pct", "roofline_tok_s",
    "set_measured_hbm_gbps",
]

# The peaks of the cards the port knows, by the name CUDA reports:
# (HBM GB/s, dense bf16 tensor-core TFLOP/s). A name matches a row when it
# contains the row's key.
DEVICE_PEAKS = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 3.35 TB/s HBM3;
    # BF16 1,979 TFLOPS "with sparsity", so 989 dense
    "H100 80GB HBM3": (3350.0, 989.0),
    # the same datasheet, PCIe column: 2 TB/s HBM2e; BF16 1,513 TFLOPS with
    # sparsity, 756 dense
    "H100 PCIe": (2000.0, 756.0),
}
# a platform with no known row keeps a non-null gauge on a figure flagged
# "assumed:<platform>" (a plumbing number, not a claim): the reference's
# host-DRAM bandwidth and host peak
HBM_GBPS_ASSUMED = 50.0
PEAK_TFLOPS_ASSUMED = 0.5

_measured_hbm_gbps: float | None = None


def set_measured_hbm_gbps(gbps: float | None) -> None:
    """Feed a measured HBM streaming peak (:func:`hbm_probe_gbps`) into the
    shared roofline model, replacing the device table's ceiling for every
    later :func:`hbm_peak_gbps` resolution."""
    global _measured_hbm_gbps
    _measured_hbm_gbps = float(gbps) if gbps else None


def device_peaks(device_name: str | None) -> tuple[str, tuple[float, float]] | None:
    """(table key, (GB/s, TFLOP/s)) of the row ``device_name`` matches."""
    for key, peaks in DEVICE_PEAKS.items():
        if device_name and key in device_name:
            return key, peaks
    return None


def _device_name(platform: str, device_name: str | None) -> str | None:
    if device_name is not None or platform != "cuda":
        return device_name
    try:
        import torch

        return torch.cuda.get_device_name() if torch.cuda.is_available() else None
    except Exception:  # noqa: BLE001 — no CUDA runtime: the assumed figure applies
        return None


def hbm_peak_gbps(platform: str,
                  device_name: str | None = None) -> tuple[float, str]:
    """(peak GB/s, source) — the ONE resolution order for the roofline
    ceiling: explicit env (``DLP_HBM_GBPS`` > ``BENCH_HBM_GBPS``) >
    measured streaming probe > the device's table row (``device:<name>``)
    > ``assumed:<platform>``. On ``platform == "cuda"`` the name is read
    from the current device unless given."""
    for env in ("DLP_HBM_GBPS", "BENCH_HBM_GBPS"):
        v = os.environ.get(env)
        if v:
            return float(v), f"env:{env}"
    if _measured_hbm_gbps:
        return _measured_hbm_gbps, "measured"
    name = _device_name(platform, device_name)
    row = device_peaks(name)
    if row is not None:
        return row[1][0], f"device:{name}"
    return HBM_GBPS_ASSUMED, f"assumed:{platform}"


def peak_tflops(platform: str,
                device_name: str | None = None) -> tuple[float, str]:
    """(peak TFLOP/s, source) for the MFU denominator; the same resolution
    shape as :func:`hbm_peak_gbps` (``DLP_PEAK_TFLOPS`` first)."""
    v = os.environ.get("DLP_PEAK_TFLOPS")
    if v:
        return float(v), "env:DLP_PEAK_TFLOPS"
    name = _device_name(platform, device_name)
    row = device_peaks(name)
    if row is not None:
        return row[1][1], f"device:{name}"
    return PEAK_TFLOPS_ASSUMED, f"assumed:{platform}"


def params_nbytes(tree) -> int:
    """Resident bytes of a model's weights: an ``nn.Module``'s parameters
    and buffers (packed projections at their stored width, a tied tensor
    once), or the leaves of a dict / list of tensors and arrays."""
    seen: set = set()
    total = 0

    def add(t) -> None:
        nonlocal total
        if hasattr(t, "untyped_storage"):   # a torch tensor
            key = (t.device, t.untyped_storage().data_ptr(), t.storage_offset(),
                   t.numel())
            if key in seen:
                return
            seen.add(key)
            total += t.numel() * t.element_size()
        elif hasattr(t, "nbytes") and not callable(t.nbytes):
            total += int(t.nbytes)

    def walk(x) -> None:
        if hasattr(x, "parameters") and hasattr(x, "buffers"):
            for t in list(x.parameters()) + list(x.buffers()):
                add(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            add(x)

    walk(tree)
    return total


def model_flops_per_token(cfg) -> int:
    """Matmul FLOPs one decode token costs (2 × matmul params): the MFU
    numerator. Attention projections + MLP per layer + the lm_head;
    embedding lookups and the O(seq) attention score work are excluded
    (the weight matmuls dominate decode, and the roofline this pairs with
    is the weights-stream bound). MoE models count every expert's MLP
    once — an upper bound on resident weights, matching params_nbytes."""
    hd = cfg.head_dim
    attn = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + cfg.n_heads * hd * cfg.dim)
    n_mlp = getattr(cfg, "n_experts", 0) or 1
    mlp = 3 * cfg.dim * cfg.hidden_dim * n_mlp
    return 2 * (cfg.n_layers * (attn + mlp) + cfg.dim * cfg.vocab_size)


def roofline_tok_s(model_bytes: int, gbps: float) -> float:
    """The weights-bound decode ceiling: tokens/s if every generated token
    streamed the weights exactly once at the full HBM bandwidth."""
    return gbps * 1e9 / max(1, model_bytes)


def roofline_pct(tok_s: float, model_bytes: int, gbps: float) -> float:
    """Achieved share of the weights-bound ceiling, in percent. Batched
    rows share one weight stream per step, so a batched tok/s can honestly
    exceed 100 (the batch beat the batch-1 roofline); per-step bandwidth
    truth is hbm_bw_util_pct."""
    return 100.0 * tok_s / roofline_tok_s(model_bytes, gbps)


def mfu_pct(tok_s: float, flops_per_token: int, tflops: float) -> float:
    """Model FLOPs utilization: achieved matmul FLOP/s over the card's
    peak."""
    return 100.0 * tok_s * flops_per_token / (tflops * 1e12)


def roofline_fields(label: str, tok_s, nbytes: int, on_device: bool) -> dict:
    """{model_gb_*, model_mb_*, roofline_tok_s_*, roofline_pct_*,
    roofline_src_*} for one engine, from the shared model. Off the card it
    compares against the assumed host ceiling the live gauges use, and
    ``roofline_src_*`` carries the ceiling's provenance (``assumed:cpu``
    against ``device:<name>`` / ``measured``), so a CPU number never reads
    as the card's."""
    gb = nbytes / 1e9
    # MB beside GB: the GB figure rounds to 0.0 on sub-100-MB models
    out = {f"model_gb_{label}": round(gb, 3),
           f"model_mb_{label}": round(nbytes / 1e6, 2)}
    if tok_s:
        bw, src = hbm_peak_gbps("cuda" if on_device else "cpu")
        out[f"roofline_tok_s_{label}"] = round(roofline_tok_s(nbytes, bw), 1)
        out[f"roofline_pct_{label}"] = round(
            roofline_pct(tok_s, nbytes, bw), 1)
        out[f"roofline_src_{label}"] = src
    return out


def hbm_probe_gbps(size_bytes: int = 1 << 30, long: int = 20,
                   short: int = 4) -> float:
    """Measured HBM streaming rate on the card: a device-to-device copy of
    a ``size_bytes`` buffer, timed with CUDA events, ``long`` copies minus
    ``short`` copies so the launch and synchronisation overhead cancels.
    Each copy reads and writes the buffer once (2 × ``size_bytes``). Feed
    the result to :func:`set_measured_hbm_gbps`."""
    import torch

    src = torch.ones(size_bytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)   # warm: allocation and the first touch

    def run_ms(n: int) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            dst.copy_(src)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    ms = max(run_ms(long) - run_ms(short), 1e-9) / (long - short)
    return 2 * size_bytes / ms / 1e6


# --------------------------------------------------------------------------
# kernel-build counters (the xla_compiles_total / xla_retraces_total series)


_compile_lock = threading.Lock()
_compiles: dict[str, int] = {}
_retraces: dict[str, int] = {}
_loaded_sources: set[str] = set()
_tl = threading.local()


def record_compile(source: str, load: bool = False) -> bool:
    """Count one build (``load`` False) or library load (True) of a CUDA
    source, by ``ops/cuda_build.py``. A build or load of a source this
    process has already loaded is a retrace: counted apart, logged as an
    ``xla_recompile`` line and noted on the scope the launch runs under.
    Returns whether it was one."""
    with _compile_lock:
        retrace = source in _loaded_sources
        _compiles[source] = _compiles.get(source, 0) + 1
        if retrace:
            _retraces[source] = _retraces.get(source, 0) + 1
        if load:
            _loaded_sources.add(source)
    scope = getattr(_tl, "scope", None)
    if scope is not None:
        scope.compiles += 1
        scope.retrace = scope.retrace or retrace
    if retrace:
        _log_retrace(source, 1)
    return retrace


def compile_counts() -> dict[str, int]:
    with _compile_lock:
        return dict(_compiles)


def retrace_counts() -> dict[str, int]:
    with _compile_lock:
        return dict(_retraces)


def reset_compile_tracking() -> None:
    """Test hook: forget the process counts and the loaded sources."""
    with _compile_lock:
        _compiles.clear()
        _retraces.clear()
        _loaded_sources.clear()


class CompileScope:
    """Attributes the library builds and loads inside the ``with`` block to
    its launch site: after exit, ``compiles`` is how many there were and
    ``retrace`` whether one of them was a source the process had already
    loaded. The caller stamps an ``xla_recompile`` event on the affected
    requests' traces."""

    __slots__ = ("name", "compiles", "retrace", "_prev")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.retrace = False
        self._prev = None

    def __enter__(self) -> "CompileScope":
        self._prev = getattr(_tl, "scope", None)
        _tl.scope = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tl.scope = self._prev
        return False


def compile_entry(name: str) -> CompileScope:
    """Scope the next launch under an entry label."""
    return CompileScope(name)


def _log_retrace(entry: str, n: int) -> None:
    """One structured log line per retrace incident."""
    try:
        sys.stderr.write(json.dumps({
            "event": "xla_recompile", "entry": entry, "compiles": n,
            "note": "a CUDA library this process had already loaded was "
                    "built or loaded again",
        }, sort_keys=True) + "\n")
        sys.stderr.flush()
    except (OSError, ValueError):
        pass


# --------------------------------------------------------------------------
# step-time rings + rolling-window aggregation


class StepRec(NamedTuple):
    t_end: float          # monotonic readback-complete time
    wall_ms: float        # launch -> readback-complete
    kind: str             # "decode" | "mixed"
    rows: int             # rows active in the step (occupancy)
    tokens: int           # decode tokens produced across rows
    prefill_tokens: int   # prompt tokens fed (mixed steps)
    scan_steps: int       # device forwards in the step (weight streams)
    kv_bytes: int         # KV bytes the step's attention read (estimate)


def _pct(vals: list, p: float):
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, round(p / 100.0 * (len(vals) - 1)))]


def _sig(x: float, digits: int = 4) -> float:
    """Round to significant digits: tiny-model utilization figures must
    not collapse to 0.0."""
    return float(f"{float(x):.{digits}g}")


class _NullPerf:
    """Falsy no-op monitor while ``DLP_PERF=0``: every surface exists and
    does nothing, so hot paths pay one attribute read + branch."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def record_step(self, *a, **kw) -> None:
        pass

    def snapshot(self) -> dict:
        return {"enabled": False}

    def export_gauges(self, metrics) -> None:
        pass

    def arm_profile(self, *a, **kw):
        raise RuntimeError("perf monitoring is disabled (DLP_PERF=0)")


# a stateless falsy singleton: every method is a no-op, so the DLP_PERF=0
# fast path (`if perf:`) shares it across threads with no lock at all
NULL_PERF = _NullPerf()


def perf_ring_capacity() -> int:
    return max(16, int(os.environ.get("DLP_PERF_RING", "512")))


def make_perf_monitor(**kw) -> "PerfMonitor | _NullPerf":
    """Engine factory hook: the monitor, or :data:`NULL_PERF` when
    disabled."""
    if os.environ.get("DLP_PERF", "1") == "0":
        return NULL_PERF
    return PerfMonitor(**kw)


def metrics_reader(owner) -> Callable[[], Any]:
    """``owner.metrics``, read at each call through a weak reference: the
    monitor an engine holds keeps no cycle back to it, so a deleted engine
    frees its device memory at once, not at the next garbage collection."""
    ref = weakref.ref(owner)
    return lambda: getattr(ref(), "metrics", None)


class PerfMonitor:
    """Per-engine performance accounting: bounded per-backend step rings,
    rolling-window roofline/MFU aggregation, the build-counter export and
    the on-demand profile controller. Thread-safe: producers are the
    scheduler worker and request threads; consumers are /metrics scrapes
    and ``GET /debug/perf``."""

    def __init__(self, *, model_bytes: int, flops_per_token: int,
                 kv_bytes_per_token: int = 0, platform: str = "cpu",
                 model: str = "default",
                 metrics_fn: Callable[[], Any] | None = None,
                 ring_cap: int | None = None, window_s: float | None = None,
                 device_name: str | None = None):
        self.model_bytes = int(model_bytes)
        self.flops_per_token = int(flops_per_token)
        self.kv_bytes_per_token = int(kv_bytes_per_token)
        self.platform = platform
        self.device_name = device_name
        self.model = model
        # metrics resolved per call (not captured): the supervisor swaps
        # the engine's Metrics for the registry-shared one after build
        self._metrics_fn = metrics_fn or (lambda: None)
        self.ring_cap = ring_cap or perf_ring_capacity()
        self.window_s = float(window_s
                              or os.environ.get("DLP_PERF_WINDOW_S", "60"))
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}
        self._totals: dict[str, int] = {}
        self._profile: ProfileRun | None = None

    def __bool__(self) -> bool:
        return True

    def peaks(self) -> tuple[float, str, float, str]:
        bw, bw_src = hbm_peak_gbps(self.platform, self.device_name)
        fl, fl_src = peak_tflops(self.platform, self.device_name)
        return bw, bw_src, fl, fl_src

    # -- recording (hot path: one deque append + one histogram observe) ----

    def record_step(self, backend: str, t_launch: float, t_end: float, *,
                    rows: int = 1, tokens: int = 0, prefill_tokens: int = 0,
                    scan_steps: int = 1, kv_positions: int = 0,
                    kind: str = "decode") -> None:
        """Record one device step (launch → readback-complete wall time).
        ``kv_positions`` is the summed valid KV length across the step's
        rows — the attention-read bandwidth estimate rides on it."""
        wall_ms = (t_end - t_launch) * 1000.0
        rec = StepRec(t_end, wall_ms, kind, rows, tokens, prefill_tokens,
                      scan_steps,
                      kv_positions * self.kv_bytes_per_token * scan_steps)
        with self._lock:
            ring = self._rings.get(backend)
            if ring is None:
                ring = self._rings[backend] = collections.deque(
                    maxlen=self.ring_cap)
            ring.append(rec)
            self._totals[backend] = self._totals.get(backend, 0) + 1
        m = self._metrics_fn()
        if m is not None:
            m.observe("step_ms", wall_ms, labels={"backend": backend})
        pr = self._profile
        if pr is not None:
            pr.note_step()

    # -- aggregation --------------------------------------------------------

    def _window(self, backend: str) -> list[StepRec]:
        horizon = time.monotonic() - self.window_s
        with self._lock:
            ring = self._rings.get(backend)
            if not ring:
                return []
            return [r for r in ring if r.t_end >= horizon]

    def backend_stats(self, backend: str) -> dict | None:
        """Rolling-window aggregates for one backend's ring, or None when
        the window is empty. Rates are over device-BUSY time (the summed
        step walls), not elapsed wall-clock — an idle server's last
        window still reports the rate the device achieved while it
        worked."""
        recs = self._window(backend)
        if not recs:
            return None
        walls = [r.wall_ms for r in recs]
        busy_s = sum(walls) / 1000.0
        tokens = sum(r.tokens for r in recs)
        prefill = sum(r.prefill_tokens for r in recs)
        streams = sum(r.scan_steps for r in recs)
        kv_bytes = sum(r.kv_bytes for r in recs)
        bw, bw_src, fl, fl_src = self.peaks()
        tok_s = tokens / busy_s if busy_s > 0 else 0.0
        achieved_gbps = ((streams * self.model_bytes + kv_bytes)
                         / busy_s / 1e9 if busy_s > 0 else 0.0)
        # per-occupancy decode rate: how much the batch dimension buys
        by_occ: dict[int, list[StepRec]] = {}
        for r in recs:
            if r.kind == "decode" and r.tokens:
                by_occ.setdefault(r.rows, []).append(r)
        occ = {
            str(k): round(sum(x.tokens for x in v)
                          / max(1e-9, sum(x.wall_ms for x in v) / 1000.0), 2)
            for k, v in sorted(by_occ.items())}
        return {
            "steps": len(recs),
            "steps_total": self._totals.get(backend, 0),
            "window_s": self.window_s,
            "busy_s": round(busy_s, 3),
            "step_ms": {"p50": round(_pct(walls, 50), 3),
                        "p90": round(_pct(walls, 90), 3),
                        "p99": round(_pct(walls, 99), 3),
                        "mean": round(sum(walls) / len(walls), 3),
                        "max": round(max(walls), 3)},
            "mixed_steps": sum(1 for r in recs if r.kind == "mixed"),
            "decode_tok_s": round(tok_s, 2),
            "decode_tok_s_by_occupancy": occ,
            "prefill_tok_s": round(prefill / busy_s, 2) if busy_s else 0.0,
            "achieved_hbm_gbps": _sig(achieved_gbps),
            "hbm_bw_util_pct": _sig(100.0 * achieved_gbps / bw),
            "mfu_pct": _sig(mfu_pct(tok_s, self.flops_per_token, fl)),
            "roofline_pct": _sig(
                roofline_pct(tok_s, self.model_bytes, bw)),
            "hbm_peak_gbps": bw, "hbm_peak_source": bw_src,
            "peak_tflops": fl, "peak_tflops_source": fl_src,
        }

    def snapshot(self) -> dict:
        """The ``GET /debug/perf`` body: the roofline model's inputs and
        every backend's rolling-window aggregates, plus the build
        counters."""
        bw, bw_src, fl, fl_src = self.peaks()
        with self._lock:
            backends = list(self._rings)
        return {
            "enabled": True,
            "platform": self.platform,
            "model": self.model,
            "roofline": {
                "model_hbm_gb": _sig(self.model_bytes / 1e9),
                "flops_per_token": self.flops_per_token,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "hbm_peak_gbps": bw, "hbm_peak_source": bw_src,
                "peak_tflops": fl, "peak_tflops_source": fl_src,
                "roofline_tok_s": round(
                    roofline_tok_s(self.model_bytes, bw), 1),
                "assumed_peaks": bw_src.startswith("assumed")
                or fl_src.startswith("assumed"),
            },
            "backends": {b: self.backend_stats(b) for b in backends},
            "compile": {"xla_compiles_total": compile_counts(),
                        "xla_retraces_total": retrace_counts()},
        }

    def export_gauges(self, metrics) -> None:
        """Export the rolling-window aggregates as labelled gauges and the
        process-wide build counters as counter deltas — called at every
        /metrics scrape (idempotent for gauges; delta-tracked for the
        counters so repeated scrapes never double-count)."""
        with self._lock:
            backends = list(self._rings)
        for b in backends:
            st = self.backend_stats(b)
            if st is None:
                continue
            lb = {"backend": b}
            metrics.set_gauge("mfu_pct", st["mfu_pct"], labels=lb)
            metrics.set_gauge("hbm_bw_util_pct", st["hbm_bw_util_pct"],
                              labels=lb)
            metrics.set_gauge("roofline_pct", st["roofline_pct"], labels=lb)
            metrics.set_gauge("decode_tok_s_window", st["decode_tok_s"],
                              labels=lb)
            metrics.set_gauge("step_ms_p50", st["step_ms"]["p50"], labels=lb)
            metrics.set_gauge("step_ms_p99", st["step_ms"]["p99"], labels=lb)
            for occ, v in st["decode_tok_s_by_occupancy"].items():
                metrics.set_gauge("decode_tok_s_window", v,
                                  labels={"backend": b, "occupancy": occ})
        bw = self.peaks()[0]
        metrics.set_gauge("hbm_peak_gbps", bw)
        metrics.set_gauge("model_hbm_gb", round(self.model_bytes / 1e9, 3))
        export_compile_counters(metrics)

    # -- on-demand device profiling (POST /debug/profile) -------------------

    def arm_profile(self, steps: int = 4,
                    base_dir: str | None = None) -> "ProfileRun":
        """Start a ``torch.profiler`` session NOW and seal it after the next
        ``steps`` recorded device steps — no restart, no ``--profile-dir``
        flag. One session at a time; raises RuntimeError when one is
        already armed (or a per-request ``--profile-dir`` session runs)."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        base = base_dir or os.environ.get("DLP_PROFILE_DIR") or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "dlp-debug-profile")
        run_dir = os.path.join(base, f"run-{time.time_ns()}")
        with self._lock:
            if self._profile is not None:
                raise RuntimeError("a debug profile session is already "
                                   "armed; wait for it to finish")
            run = ProfileRun(self, steps, run_dir)
            self._profile = run
        try:
            run.start()
        except Exception:
            with self._lock:
                self._profile = None
            raise
        # retention: on-demand runs share the per-request sessions' cap
        from .profile_trace import prune_profile_runs

        prune_profile_runs(base, keep_dirs=True)
        return run

    def _profile_done(self, run: "ProfileRun") -> None:
        with self._lock:
            if self._profile is run:
                self._profile = None


# build counters are PROCESS totals exported as deltas; the high-water
# marks live ON the target Metrics (not on the monitor) because the
# supervisor's Metrics outlives engine restarts — a fresh monitor with
# per-monitor marks would re-export the whole history after every rebuild
_export_lock = threading.Lock()


def export_compile_counters(metrics) -> None:
    with _export_lock:
        exported = getattr(metrics, "_perf_exported_compiles", None)
        if exported is None:
            exported = {"xla_compiles_total": {}, "xla_retraces_total": {}}
            metrics._perf_exported_compiles = exported
        for name, totals in (("xla_compiles_total", compile_counts()),
                             ("xla_retraces_total", retrace_counts())):
            marks = exported[name]
            for entry, total in totals.items():
                delta = total - marks.get(entry, 0)
                if delta > 0:
                    metrics.inc(name, delta, labels={"entry": entry})
                    marks[entry] = total


class ProfileRun:
    """One armed on-demand profiling window: start → N recorded steps (or
    a caller-forced stop) → Chrome trace summary + request-trace join.

    Ordering discipline: the run is REGISTERED on the monitor before
    ``start()`` (exclusivity), but steps only count once the profiler has
    started — a concurrent request finishing the budget inside that window
    would otherwise seal the run before it began. A finish that races
    ``start()`` marks the run stopped; ``start()`` then stops the
    just-started session itself. The profiler is started and stopped on
    the arming thread; a decode thread only seals the window."""

    def __init__(self, monitor: PerfMonitor, steps: int, run_dir: str):
        self._monitor = monitor
        self.steps_requested = steps
        self.dir = run_dir
        self.steps_captured = 0
        self.t0 = time.monotonic()
        self.t1: float | None = None
        self._remaining = steps
        self._state_lock = threading.Lock()
        self._started = False
        self._stopped = False            # window sealed (no more steps)
        self._profiler_stopped = False   # the torch session actually stopped
        self._prof = None
        self.done = threading.Event()

    def start(self) -> None:
        from .profile_trace import claim_session, make_profiler, release_session

        os.makedirs(self.dir, exist_ok=True)
        claim_session("POST /debug/profile")
        try:
            self._prof = make_profiler()
            self._prof.start()
        except Exception:
            release_session()
            raise
        with self._state_lock:
            self._started = True
            stop_now = self._stopped
            if not stop_now:
                self.t0 = time.monotonic()
        if stop_now:
            # finish() raced us before the trace was live: stop the
            # session it could not stop itself (arming thread — safe)
            self._stop_profiler()

    def note_step(self) -> None:
        """Called by the monitor's record_step — any producer thread.
        Steps that completed before the trace was live don't count (the
        contract is 'the next N steps', captured whole). Reaching the
        budget only SEALS the run and wakes the waiter — the profiler's
        stop and trace export run on the waiter's thread in
        :meth:`finish`, never on a decode/worker thread."""
        with self._state_lock:
            if self._stopped or not self._started:
                return
            self.steps_captured += 1
            self._remaining -= 1
            if self._remaining > 0:
                return
        self._seal()

    def _seal(self) -> None:
        """Mark the window closed and wake the waiter (idempotent; cheap
        enough for any thread). The profiler itself keeps running until
        ``finish`` stops it."""
        with self._state_lock:
            if self._stopped:
                return
            self._stopped = True
            self.t1 = time.monotonic()
        self._monitor._profile_done(self)
        self.done.set()

    def _stop_profiler(self) -> None:
        from .profile_trace import release_session

        with self._state_lock:
            if self._profiler_stopped or not self._started:
                return
            self._profiler_stopped = True
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        except Exception:  # noqa: BLE001 — the session may already be torn down
            pass
        finally:
            release_session()

    def finish(self) -> None:
        """Seal (if the budget never hit) and stop the profiler —
        idempotent; callers are the HTTP waiter thread and timeout paths.
        Must run before :meth:`summarize` reads the trace from disk."""
        self._seal()
        self._stop_profiler()

    def wait(self, timeout: float) -> bool:
        return self.done.wait(timeout)

    def summarize(self, top_k: int = 10) -> dict:
        """Device-timeline summary of the captured run: per-device busy_ms
        and bubble_pct (``utils/profile_trace.timelines``; on the CPU the
        host threads' operator lanes, flagged ``mode: "lanes"``), plus the
        top CUDA kernels by total device time."""
        from .profile_trace import timelines, top_kernels

        out: dict = {
            "profile_dir": self.dir,
            "steps_requested": self.steps_requested,
            "steps_captured": self.steps_captured,
            "window_ms": round(((self.t1 or time.monotonic()) - self.t0)
                               * 1000.0, 1),
        }
        tl = timelines(self.dir)
        if tl is None:
            out["mode"] = None
            out["note"] = ("no device timelines in the captured run "
                           "(no steps ran inside the window?)")
            out["top_kernels"] = []
            return out
        out["mode"] = tl["mode"]
        if tl["mode"] == "lanes":
            out["caveat"] = ("no CUDA kernels in the run: host operator "
                             "lanes stand in for device timelines")
        devices = {}
        for name, d in sorted(tl["timelines"].items()):
            window_ps = max(1, d["end_ps"] - d["start_ps"])
            devices[name] = {
                "busy_ms": round(d["busy_ps"] / 1e9, 3),
                "window_ms": round(window_ps / 1e9, 3),
                "bubble_pct": round(
                    100.0 * (1.0 - min(d["busy_ps"], window_ps)
                             / window_ps), 2),
            }
        out["devices"] = devices
        out["top_kernels"] = top_kernels(self.dir, k=top_k)
        return out

    def join_traces(self, tracer, limit: int = 8) -> list[str]:
        """Join the captured device timelines onto the request traces that
        overlapped the profiling window — the same ``device:*`` spans
        ``--profile-dir`` per-request profiling attaches, minus the
        restart. Returns the joined request ids."""
        t1 = self.t1 if self.t1 is not None else time.monotonic()
        joined: list[str] = []
        with tracer._lock:
            candidates = list(tracer._ring)[::-1] + list(
                tracer._live.values())
        for tr in candidates:
            if len(joined) >= limit:
                break
            tr_end = tr.t1 if tr.t1 is not None else time.monotonic()
            if tr_end < self.t0 or tr.t0 > t1:
                continue
            try:
                if tr.join_profile(self.dir):
                    joined.append(tr.request_id)
            except Exception:  # noqa: BLE001 — a malformed trace file must
                pass           # not fail the profile response
        return joined
