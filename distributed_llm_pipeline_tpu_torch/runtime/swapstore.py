"""Bounded host-RAM swap store for preempted requests.

The counterpart of ``distributed_llm_pipeline_tpu/runtime/swapstore.py`` (a
copy). The scheduler's preemption serializes a batch-class victim's KV and
sampling state through the handoff wire format (``runtime/disagg.py``
``save_handoff_bytes``) and parks the payload here, in plain host RAM,
bounded by LRU and TTL, until the request is re-admitted with zero
re-prefill. The store is deliberately dumb: bytes in, bytes out, capacity
accounting. Victim selection, restore and the typed expiry error live in
the scheduler, and every call happens on the scheduler's worker thread.
With ``metrics`` the store publishes its ``swap_store_bytes`` and
``swap_store_entries`` gauges after every change, as the reference's does.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable


class SwapStore:
    """LRU + TTL bounded byte store, owned by one thread.

    ``put`` refuses (returns False) a payload larger than the whole budget:
    the caller must then abort the preemption rather than evict every
    sibling for one oversized row. Over-budget inserts evict oldest-first,
    calling ``on_evict(sid)`` for each victim, so the scheduler can emit the
    evicted request's typed terminal error. ``sweep`` returns expired ids
    the same way; the caller owns the error emission.
    """

    def __init__(self, max_bytes: int, ttl_s: float,
                 metrics=None,
                 on_evict: Callable[[str], None] | None = None):
        if max_bytes <= 0:
            raise ValueError(f"swap store budget must be positive, "
                             f"got {max_bytes} bytes")
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.metrics = metrics
        self.on_evict = on_evict
        # sid -> {data, t}; insertion order is the LRU order (entries are
        # write-once: a swapped request re-admits at most once)
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._bytes = 0
        self._export()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def _export(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("swap_store_bytes", self._bytes)
            self.metrics.set_gauge("swap_store_entries", len(self._entries))

    def put(self, sid: str, data: bytes) -> bool:
        """Insert a payload, evicting oldest-first until it fits. Returns
        False, with nothing stored or evicted, when ``data`` alone exceeds
        the whole budget."""
        if len(data) > self.max_bytes:
            return False
        while self._bytes + len(data) > self.max_bytes and self._entries:
            victim, entry = self._entries.popitem(last=False)
            self._bytes -= len(entry["data"])
            if self.on_evict is not None:
                self.on_evict(victim)
        self._entries[sid] = {"data": data, "t": time.monotonic()}
        self._bytes += len(data)
        self._export()
        return True

    def take(self, sid: str) -> bytes | None:
        """Remove and return a payload (a swap-in consumes its entry), or
        None when it expired or was evicted first."""
        entry = self._entries.pop(sid, None)
        if entry is None:
            return None
        self._bytes -= len(entry["data"])
        self._export()
        return entry["data"]

    def sweep(self, now: float | None = None) -> list[str]:
        """Drop entries past the TTL and return their ids, so the caller
        can emit each request's typed expiry error. TTL <= 0 disables."""
        if self.ttl_s <= 0 or not self._entries:
            return []
        now = time.monotonic() if now is None else now
        expired = [sid for sid, e in self._entries.items()
                   if now - e["t"] > self.ttl_s]
        for sid in expired:
            self._bytes -= len(self._entries.pop(sid)["data"])
        if expired:
            self._export()
        return expired

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0
        self._export()
