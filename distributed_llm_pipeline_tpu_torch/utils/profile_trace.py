"""``torch.profiler`` sessions and the reading of their Chrome traces: the
port's counterpart of the reference's xplane reader (``utils/xplane.py``)
and of its per-request ``profiler_trace`` (``utils/metrics.py``).

- :func:`profiler_trace` wraps a block (a request, with ``--profile-dir``)
  in a ``torch.profiler`` session (CPU + CUDA activities) and writes its
  Chrome trace to ``<dir>/plugins/profile/<run>/trace.json``, the
  reference's per-request layout.
- :func:`timelines` reads a trace into one timeline per device (CUDA
  kernel, copy and memset events; ``mode: "device"``), or, when the trace
  holds no device event (the CPU), one per host thread that ran operators
  (``mode: "lanes"``). Times are picoseconds since the epoch when the
  trace carries ``baseTimeNanoseconds``, so request spans can be clipped
  against them.
- :func:`top_kernels` ranks the CUDA kernels by total device time.
- :func:`prune_profile_runs` is the reference's retention cap
  (``DLP_PROFILE_KEEP``, default 8 runs).

One profiler session runs at a time in a process: :func:`claim_session`
is the flag both the per-request and the on-demand sessions take.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import threading
import time

__all__ = ["claim_session", "release_session", "profiler_trace", "trace_file",
           "timelines", "top_kernels", "profile_keep", "prune_profile_runs"]

# the trace-event categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_session_lock = threading.Lock()
_session_owner: list = []   # the live session's tag, at most one


def claim_session(tag: str) -> None:
    """Take the process's one profiler session; raises RuntimeError when one
    is already running (torch's profiler is process-wide)."""
    with _session_lock:
        if _session_owner:
            raise RuntimeError(f"a profiler session is already active "
                               f"({_session_owner[0]}); wait for it to finish")
        _session_owner.append(tag)


def release_session() -> None:
    with _session_lock:
        _session_owner.clear()


def make_profiler():
    """A ``torch.profiler.profile`` over the CPU and, when present, CUDA."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def profiler_trace(profile_dir: str | None):
    """Profile the block into a new run under
    ``<profile_dir>/plugins/profile/``; a no-op when ``profile_dir`` is
    None. Raises RuntimeError when another session is live."""
    if not profile_dir:
        yield None
        return
    claim_session("--profile-dir")
    run = os.path.join(str(profile_dir), "plugins", "profile",
                       f"run-{time.time_ns()}")
    prof = None
    try:
        os.makedirs(run, exist_ok=True)
        prof = make_profiler()
        prof.start()
        yield run
    finally:
        try:
            if prof is not None:
                prof.stop()
                prof.export_chrome_trace(os.path.join(run, "trace.json"))
        finally:
            release_session()


def trace_file(path: str) -> str | None:
    """The Chrome trace a path names: the file itself, the ``trace.json`` of
    a run directory, or that of a profile directory's newest run."""
    path = str(path)
    if os.path.isfile(path):
        return path
    direct = os.path.join(path, "trace.json")
    if os.path.isfile(direct):
        return direct
    runs = sorted(glob.glob(os.path.join(path, "plugins", "profile", "*",
                                         "trace.json"))
                  + glob.glob(os.path.join(path, "run-*", "trace.json")),
                  key=os.path.getmtime)
    return runs[-1] if runs else None


def _load(path: str) -> tuple[list[dict], float] | None:
    f = trace_file(path)
    if f is None:
        return None
    try:
        with open(f) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    base_us = float(data.get("baseTimeNanoseconds", 0)) / 1000.0
    return data.get("traceEvents") or [], base_us


def _union_ps(spans: list[tuple[float, float]]) -> int:
    """Covered picoseconds of a set of [start, end) µs intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return int(busy * 1e6)


def timelines(path: str) -> dict | None:
    """``{"mode", "timelines": {name: {start_ps, end_ps, busy_ps}}}`` of a
    trace: one timeline per CUDA device (``cuda:<index>``, every stream's
    kernels, copies and memsets; busy is their union), or with no device
    event one per host thread that ran operators (``host:<tid>``,
    ``mode: "lanes"``). None when the trace is missing or empty."""
    loaded = _load(path)
    if loaded is None:
        return None
    events, base_us = loaded
    dev: dict[str, list[tuple[float, float]]] = {}
    host: dict[str, list[tuple[float, float]]] = {}
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        t0 = float(ev["ts"]) + base_us
        t1 = t0 + float(ev.get("dur", 0.0))
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            args = ev.get("args") or {}
            name = f"cuda:{args.get('device', ev.get('pid', 0))}"
            dev.setdefault(name, []).append((t0, t1))
        elif cat == "cpu_op":
            host.setdefault(f"host:{ev.get('tid', 0)}", []).append((t0, t1))
    lanes, mode = (dev, "device") if dev else (host, "lanes")
    if not lanes:
        return None
    return {"mode": mode, "timelines": {
        name: {"start_ps": int(min(a for a, _ in sp) * 1e6),
               "end_ps": int(max(b for _, b in sp) * 1e6),
               "busy_ps": _union_ps(sp)}
        for name, sp in lanes.items()}}


def top_kernels(path: str, k: int = 10) -> list[dict]:
    """The ``k`` CUDA kernels with the most total device time in a trace:
    ``[{"kernel", "total_ms", "count"}]``, most first; empty on the CPU."""
    loaded = _load(path)
    if loaded is None:
        return []
    totals: dict[str, list] = {}
    for ev in loaded[0]:
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        t = totals.setdefault(ev.get("name", "<unnamed>"), [0.0, 0])
        t[0] += float(ev.get("dur", 0.0))
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:k]
    return [{"kernel": name, "total_ms": round(us / 1e3, 3), "count": n}
            for name, (us, n) in ranked]


def profile_keep() -> int:
    return max(1, int(os.environ.get("DLP_PROFILE_KEEP", "8")))


def prune_profile_runs(profile_dir: str, keep: int | None = None,
                       keep_dirs: bool = False) -> int:
    """Retention cap for profiler sessions: per-request ``--profile-dir``
    profiling writes a NEW run under ``<dir>/plugins/profile/`` per
    request, so runs accumulate on disk. Keep the newest ``keep`` (env
    ``DLP_PROFILE_KEEP``, default 8) runs and delete older ones — called at
    join time by the engine and at arm time by the on-demand profiler.
    ``keep_dirs`` prunes top-level run dirs (the on-demand layout:
    ``<dir>/run-*``) instead of the per-request session layout. Returns
    the number of runs removed."""
    keep = profile_keep() if keep is None else max(1, int(keep))
    if keep_dirs:
        pattern = os.path.join(str(profile_dir), "run-*")
    else:
        pattern = os.path.join(str(profile_dir), "plugins", "profile", "*")
    try:
        runs = sorted(glob.glob(pattern), key=os.path.getmtime)
    except OSError:
        return 0
    removed = 0
    for run in runs[:-keep] if len(runs) > keep else []:
        try:
            shutil.rmtree(run, ignore_errors=True)
            removed += 1
        except OSError:
            continue
    return removed
