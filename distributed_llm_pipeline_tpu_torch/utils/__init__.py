"""Shared utilities: the engine's event stream, the metrics registry, the
request tracer and the perf monitor."""

from .events import Event, done, log, serving_identity, token
from .metrics import (BucketHistogram, Histogram, Metrics, escape_label_value,
                      preregister_boot_series)
from .perf import NULL_PERF, PerfMonitor, compile_entry, make_perf_monitor
from .profile_trace import profiler_trace
from .tracing import (NULL_TRACE, TRACE_HEADER, TRACER, RequestTrace, Tracer,
                      format_trace_context, merge_fleet_traces,
                      parse_trace_context, rid_args)

__all__ = ["BucketHistogram", "Event", "Histogram", "Metrics", "NULL_PERF",
           "NULL_TRACE", "PerfMonitor", "RequestTrace", "TRACER", "TRACE_HEADER",
           "Tracer", "compile_entry", "done", "escape_label_value",
           "format_trace_context", "log", "make_perf_monitor",
           "merge_fleet_traces", "parse_trace_context", "preregister_boot_series",
           "profiler_trace", "rid_args", "serving_identity", "token"]
