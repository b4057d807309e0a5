"""Shared utilities: the engine's event stream and the metrics registry."""

from .events import Event, done, log, serving_identity, token
from .metrics import (BucketHistogram, Histogram, Metrics, escape_label_value,
                      preregister_boot_series)

__all__ = ["BucketHistogram", "Event", "Histogram", "Metrics", "done",
           "escape_label_value", "log", "preregister_boot_series",
           "serving_identity", "token"]
