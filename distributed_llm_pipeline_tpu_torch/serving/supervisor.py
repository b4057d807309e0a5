"""Engine supervision and the multi-model registry.

A copy of ``distributed_llm_pipeline_tpu/serving/supervisor.py`` on the
port's engines:

- ``SupervisedEngine`` wraps an engine with crash recovery: an exception
  mid-generation rebuilds the engine from its factory (a clean reload of
  the weights onto the device; inference has no state to lose) and retries
  the request once, unless tokens were already streamed. Restarts are
  serialized by an epoch, so two requests failing together rebuild once,
  and bounded by ``max_restarts``, so an engine that keeps crashing fails
  fast (``EngineFailure``) instead of reloading forever. ``health()`` feeds
  ``/healthz`` and ``/models``.
- ``ModelRegistry`` holds named supervised engines with load, unload and
  LRU eviction beyond ``max_models``: the default model is pinned, a busy
  model (a request in flight) is neither unloaded nor evicted, and every
  model records into one shared ``Metrics``.

An engine that can be closed (a mesh: its follower ranks and the process's
default process group) is closed before its rebuild, on unload and on
eviction: one process serves one mesh at a time, so the new mesh can only
start once the old one has ended. On CUDA a rebuilt or unloaded engine's
device memory returns to the allocator once nothing holds it, and the
caching allocator's free blocks go back to the device
(``torch.cuda.empty_cache``) after the swap. Both compose with the
server's single decode lock: supervision is per engine, admission is
global.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterator

import torch

from ..runtime import GenerationConfig, faults
from ..utils import Event, Metrics, log, preregister_boot_series

EngineFactory = Callable[[], Any]


def close_engine(engine) -> None:
    """End what an engine holds beyond its tensors (a mesh's follower ranks
    and process group); an engine without ``close`` has nothing to end."""
    close = getattr(engine, "close", None)
    if callable(close):
        close()


def release_device_memory() -> None:
    """Collect what dropped engines leave behind and hand the CUDA caching
    allocator's free blocks back to the device."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class EngineFailure(RuntimeError):
    """Terminal engine failure: restart budget exhausted or rebuild failed."""


class SupervisedEngine:
    """The engine surface with crash recovery.

    ``factory`` builds (and rebuilds) the engine. A generation failure
    triggers at most one in-request restart and retry; ``max_restarts``
    bounds the restarts over the wrapper's lifetime. ``fresh``: the factory
    builds a new engine on every call, so a restart closes the old one
    first; False when it hands back one live engine, which stays open.
    """

    def __init__(self, factory: EngineFactory, max_restarts: int = 3,
                 metrics=None, *, fresh: bool = True):
        self._factory = factory
        self._fresh = fresh
        self.max_restarts = max_restarts
        self.restarts = 0
        self.last_error: str | None = None
        self.last_restart_at: float | None = None
        self.status = "initializing"
        # two requests crashing together must not both rebuild the engine
        # (two weight loads, two units of the budget): the loser re-checks
        # behind the lock instead
        self._restart_lock = threading.Lock()
        self._epoch = 0              # bumps on every successful rebuild
        # requests streaming from the engine: the registry refuses or
        # defers unloading it while any is in flight
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.engine = factory()
        # metrics live outside the engine, so a restart keeps the serving
        # history; a registry shares one instance across its models
        if metrics is None:
            metrics = getattr(self.engine, "metrics", None) or Metrics()
        self._metrics = metrics
        # the boot schema holds for whatever Metrics /metrics reads
        preregister_boot_series(self._metrics)
        self._profile_dir: str | None = None
        self._adopt_state()
        self.status = "healthy"

    def _adopt_state(self) -> None:
        """Push the wrapper's metrics and profiling target onto the current
        engine: on build and on every rebuild."""
        try:
            self.engine.metrics = self._metrics
        except AttributeError:  # an engine without that surface
            pass
        try:
            self.engine.profile_dir = self._profile_dir
        except AttributeError:
            pass

    @property
    def profile_dir(self) -> str | None:
        """``--profile-dir``: each request profiled into it (kept across
        restarts)."""
        return self._profile_dir

    @profile_dir.setter
    def profile_dir(self, value: str | None) -> None:
        self._profile_dir = value
        try:
            self.engine.profile_dir = value
        except AttributeError:
            pass

    # the engine surface -----------------------------------------------------

    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def tokenizer(self):
        return self.engine.tokenizer

    @property
    def max_seq(self):
        return self.engine.max_seq

    @property
    def metrics(self):
        return self._metrics

    # supervision -----------------------------------------------------------

    def health(self) -> dict:
        # an advisory snapshot, deliberately not behind _restart_lock: the
        # lock is held for a whole weight reload, and /healthz must keep
        # answering ("restarting") meanwhile
        return {"status": self.status,
                "restarts": self.restarts,
                "last_error": self.last_error,
                "last_restart_at": self.last_restart_at,
                "in_flight": self._inflight}

    @property
    def inflight(self) -> int:
        """Requests streaming from this engine (the unload guard)."""
        return self._inflight

    def _checkout(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def _checkin(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def _mark_degraded(self, e: Exception) -> None:
        """Record a generation failure under the restart lock, so the mark
        lands either before a concurrent winner's rebuild (which overwrites
        it) or after (and the loser's ``restart`` restores "healthy")."""
        with self._restart_lock:
            self.last_error = repr(e)
            self.status = "degraded"

    def restart(self, observed_epoch: int | None = None) -> None:
        """Rebuild the engine from its factory (the weights reload).

        Serialized: of two requests failing together, the first rebuilds;
        the loser, whose ``observed_epoch`` (taken when its generation
        started) is stale by the time it holds the lock, reuses that
        rebuild instead of building and counting a second one."""
        with self._restart_lock:
            if (observed_epoch is not None and self._epoch > observed_epoch
                    and self.status != "failed"):
                # another thread rebuilt since this failure was observed
                self.status = "healthy"
                return
            if self.restarts >= self.max_restarts:
                self.status = "failed"
                raise EngineFailure(
                    f"engine exceeded {self.max_restarts} restarts; "
                    f"last error: {self.last_error}")
            self.status = "restarting"
            if self._fresh:
                # the old engine ends before the new one starts: a mesh's
                # ranks and process group cannot be rebuilt beside it
                close_engine(self.engine)
            try:
                if faults.ACTIVE:
                    faults.check("engine_build_crash")
                engine = self._factory()
            except Exception as e:
                self.status = "failed"
                self.last_error = repr(e)
                raise EngineFailure(f"engine rebuild failed: {e!r}") from e
            self.engine = engine
            self._adopt_state()  # the serving history survives it
            self.restarts += 1
            self._epoch += 1
            self.last_restart_at = time.time()
            self.status = "healthy"
        # the old engine's device memory goes back once nothing holds it
        release_device_memory()
        self.metrics.inc("engine_restarts_total")

    def generate(self, prompt: str, gen: GenerationConfig | None = None,
                 **kw) -> Iterator[Event]:
        """``engine.generate`` with crash recovery; ``kw`` (a fleet
        ``trace_ctx``) passes through."""
        emitted_tokens = 0
        started = False
        epoch = self._epoch   # the engine generation this request ran on
        self._checkout()
        try:
            try:
                for ev in self.engine.generate(prompt, gen, **kw):
                    started = True
                    if ev.kind == "token":
                        emitted_tokens += 1
                    yield ev
                return
            except GeneratorExit:  # client disconnect, not an engine failure
                raise
            except (NotImplementedError, ValueError) as e:
                if not started:
                    # a refusal before any event is a deterministic client
                    # error (an unsupported combination): a restart would
                    # reload the weights over it
                    raise
                self._mark_degraded(e)
                yield log(f"engine failure: {e!r}; restarting engine "
                          f"(restart {self.restarts + 1}/{self.max_restarts})")
            except Exception as e:
                self._mark_degraded(e)
                yield log(f"engine failure: {e!r}; restarting engine "
                          f"(restart {self.restarts + 1}/{self.max_restarts})")
            # EngineFailure propagates to the caller's error path; a
            # concurrent crash that already rebuilt is reused (epoch check)
            self.restart(observed_epoch=epoch)
            if emitted_tokens:
                # output already streamed: a retry would replay it into the
                # client's text; heal, but fail the request
                yield log("engine restarted; request not retried "
                          f"({emitted_tokens} tokens were already streamed)")
                raise RuntimeError(
                    f"engine crashed mid-stream after {emitted_tokens} tokens "
                    f"(engine restarted; retry the request)")
            yield log("engine restarted; retrying request")
            yield from self.engine.generate(prompt, gen, **kw)
        finally:
            self._checkin()

    def generate_text(self, prompt: str, gen: GenerationConfig | None = None) -> str:
        return "".join(e.content for e in self.generate(prompt, gen) if e.kind == "token")

    def generate_batch(self, prompts: list[str],
                       gen: GenerationConfig | None = None) -> list[dict]:
        """The batch entry with ``generate``'s crash recovery: nothing
        streams mid-batch, so a failed batch can always restart and retry
        once. Deterministic request errors re-raise untouched."""
        epoch = self._epoch
        self._checkout()
        try:
            try:
                return self.engine.generate_batch(prompts, gen)
            except (NotImplementedError, ValueError):
                raise
            except Exception as e:
                self._mark_degraded(e)
            self.restart(observed_epoch=epoch)  # EngineFailure propagates
            return self.engine.generate_batch(prompts, gen)
        finally:
            self._checkin()

    def __getattr__(self, name: str):
        # every other engine entry (embed, perplexity, sessions, the
        # prefix cache, the scheduler's backend) reads the current engine
        if name.startswith("__") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)


class ModelRegistry:
    """Named supervised engines with load, unload and LRU eviction.

    ``loader(model_id, path, mesh, ctx)`` builds an engine; the registry
    wraps it in a SupervisedEngine. The default model is pinned: eviction
    considers only the models loaded later.
    """

    def __init__(self, default_id: str, default_engine: Any,
                 loader: Callable[[str, str, str | None, int], Any] | None = None,
                 max_models: int = 2, max_restarts: int = 3):
        self.default_id = default_id
        self.loader = loader
        self.max_models = max(1, max_models)
        self.max_restarts = max_restarts
        self._lock = threading.Lock()
        self._loading: set[str] = set()
        self._models: OrderedDict[str, SupervisedEngine] = OrderedDict()
        if isinstance(default_engine, SupervisedEngine):
            self._models[default_id] = default_engine
        else:
            # a live engine: its "restart" reuses the same object; entry
            # points that can rebuild pass a SupervisedEngine with a factory
            self._models[default_id] = SupervisedEngine(
                lambda: default_engine, max_restarts=max_restarts, fresh=False)
        # one Metrics across every model: /metrics covers all traffic, and
        # the per-model state is in health()
        self.metrics = self._models[default_id].metrics

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._models)

    def get(self, model_id: str | None = None) -> SupervisedEngine:
        """Resolve a model id (None or '' is the default); refreshes the
        LRU order."""
        mid = model_id or self.default_id
        with self._lock:
            if mid not in self._models:
                raise KeyError(f"model {mid!r} is not loaded "
                               f"(loaded: {list(self._models)})")
            self._models.move_to_end(mid)
            return self._models[mid]

    def load(self, model_id: str, path: str, mesh: str | None = None,
             ctx: int = 2048) -> SupervisedEngine:
        if self.loader is None:
            raise RuntimeError("registry has no loader; runtime model loading "
                               "is disabled for this server")
        with self._lock:
            if model_id in self._models or model_id in self._loading:
                raise ValueError(f"model {model_id!r} already loaded")
            if self.max_models < 2:
                # the default is pinned: with capacity 1 a load would be
                # evicted the moment it lands
                raise ValueError(
                    f"no capacity: max_models={self.max_models} and the "
                    f"default model is pinned")
            self._loading.add(model_id)
        try:
            # built outside the lock: a load takes seconds to minutes, and
            # requests to the other models keep flowing
            sup = SupervisedEngine(
                lambda: self.loader(model_id, path, mesh, ctx),
                max_restarts=self.max_restarts, metrics=self.metrics)
        finally:
            with self._lock:
                self._loading.discard(model_id)
        with self._lock:
            self._models[model_id] = sup
            evicted = self._evict_locked(keep=model_id)
        if evicted:
            for old in evicted:
                close_engine(old.engine)
            evicted = old = None   # the last references go before the sweep
            release_device_memory()
        return sup

    def unload(self, model_id: str) -> None:
        if model_id == self.default_id:
            raise ValueError("cannot unload the default model")
        with self._lock:
            if model_id not in self._models:
                raise KeyError(f"model {model_id!r} is not loaded")
            sup = self._models[model_id]
            if sup.inflight:
                # dropping it mid-stream would free device buffers under a
                # live forward: refuse (HTTP 409), the client retries
                raise RuntimeError(
                    f"model {model_id!r} is busy ({sup.inflight} requests "
                    f"in flight); retry when they drain")
            del self._models[model_id]
        close_engine(sup.engine)
        del sup
        release_device_memory()

    def _evict_locked(self, keep: str | None = None) -> list[SupervisedEngine]:
        """Drop least-recently-used models beyond max_models (the default
        and ``keep``, the load that triggered eviction, are pinned). A busy
        engine is never evicted: the registry runs over capacity until the
        next load retries. Returns the models that went, for the caller to
        close outside the lock."""
        gone = []
        while len(self._models) > self.max_models:
            for mid, sup in self._models.items():
                if mid != self.default_id and mid != keep \
                        and not sup.inflight:
                    gone.append(self._models.pop(mid))
                    break
            else:
                return gone
        return gone

    def health(self) -> dict:
        with self._lock:
            return {mid: sup.health() for mid, sup in self._models.items()}
