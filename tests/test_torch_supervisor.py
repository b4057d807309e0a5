"""The port's engine supervision and model registry against the JAX
package's, on the CPU.

Every scenario of the reference's supervisor tests runs through both
packages with the same test doubles (an engine that crashes before its
first token or after one, a factory that hands out a sequence of engines):
restart and retry, a mid-stream crash that heals without a retry, metrics
surviving a restart, the restart budget running
out, a client disconnect, two concurrent crashes restarting once, the
engine-build fault point, LRU load and unload, a busy model refused or its
eviction deferred, capacity one, one shared registry of metrics and a
registry without a loader. Each scenario's record (texts, ``health()``
dicts with the restart time masked, error texts, counters) must be equal.
The server's ``/models``, ``/models/load`` (its validation 400s, the 409s,
a failed load's 500) and ``/models/unload`` give the reference's statuses
and bodies for the same requests, and a model loaded at run time serves
``/chat`` with the reference's greedy text. On the slots, a watchdog repeat
stall restarts a supervised engine and the scheduler serves on from the new
engine, as the reference's does; with the restart budget spent the
scheduler fails its requests and closes.
"""

import asyncio
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import distributed_llm_pipeline_tpu.runtime.faults as jax_faults
import distributed_llm_pipeline_tpu.serving as jax_serving
import distributed_llm_pipeline_tpu.utils as jax_utils
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch import serving, utils
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        SlotScheduler, faults)
from distributed_llm_pipeline_tpu_torch.runtime.scheduler import SchedulerStalled

from .fixtures import make_spm_vocab, spm_metadata

REF = types.SimpleNamespace(
    SupervisedEngine=jax_serving.SupervisedEngine,
    ModelRegistry=jax_serving.ModelRegistry, EngineFailure=jax_serving.EngineFailure,
    Metrics=jax_utils.Metrics, token=jax_utils.token, faults=jax_faults,
    Gen=JaxGen)
PORT = types.SimpleNamespace(
    SupervisedEngine=serving.SupervisedEngine,
    ModelRegistry=serving.ModelRegistry, EngineFailure=serving.EngineFailure,
    Metrics=utils.Metrics, token=utils.token, faults=faults, Gen=GenerationConfig)


def _fake(P, crashes: int = 0, mid_stream: bool = False):
    """The reference's fault-injection double, on package ``P``: it crashes
    on the first ``crashes`` generate calls of its life, before the first
    token or, with ``mid_stream``, after one."""

    class FakeEngine:
        def __init__(self):
            self.calls = 0
            self.metrics = P.Metrics()

        def generate(self, prompt, gen=None):
            self.calls += 1
            crash = self.calls <= crashes
            if crash and not mid_stream:
                raise RuntimeError("injected crash")
            yield P.token("a")
            if crash:
                raise RuntimeError("injected crash")
            yield P.token("b")

    return FakeEngine()


def _health(h: dict) -> dict:
    return {k: (v is not None if k == "last_restart_at" else v) for k, v in h.items()}


def _text(events) -> str:
    return "".join(e.content for e in events if e.kind == "token")


def _logs(events) -> list[str]:
    return [e.content for e in events if e.kind == "log"]


def _counters(m) -> dict:
    return m.snapshot()["counters"]


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:   # the scenario records the type and the text
        return f"{type(e).__name__}: {e}"
    return "no error"


def restart_and_retry(P):
    engines = [_fake(P, crashes=1), _fake(P)]
    sup = P.SupervisedEngine(lambda: engines.pop(0))
    events = list(sup.generate("x", P.Gen()))
    return {"text": _text(events), "logs": _logs(events), "health": _health(sup.health()),
            "restarts": _counters(sup.metrics)["engine_restarts_total"]}


def mid_stream_crash(P):
    engines = [_fake(P, crashes=1, mid_stream=True), _fake(P)]
    sup = P.SupervisedEngine(lambda: engines.pop(0))
    events = []

    def run():
        for ev in sup.generate("x", P.Gen()):
            events.append(ev)

    err = _error(run)
    return {"error": err, "text": _text(events), "logs": _logs(events),
            "health": _health(sup.health()), "next": sup.generate_text("x", P.Gen())}


def metrics_survive_restart(P):
    engines = [_fake(P, crashes=1), _fake(P)]
    sup = P.SupervisedEngine(lambda: engines.pop(0))
    sup.metrics.inc("requests_total", 41)
    list(sup.generate("x", P.Gen()))
    c = _counters(sup.metrics)
    return {"requests": c["requests_total"], "restarts": c["engine_restarts_total"],
            "same_metrics": sup.engine.metrics is sup.metrics}


def budget_exhausts(P):
    sup = P.SupervisedEngine(lambda: _fake(P, crashes=10**9), max_restarts=2)
    errors = [_error(lambda: list(sup.generate("x", P.Gen()))) for _ in range(3)]
    return {"errors": errors, "health": _health(sup.health())}


def client_disconnect(P):
    sup = P.SupervisedEngine(lambda: _fake(P))
    g = sup.generate("x", P.Gen())
    next(g)
    inflight = sup.inflight
    g.close()
    return {"inflight": (inflight, sup.inflight), "health": _health(sup.health())}


def concurrent_crashes(P):
    barrier = threading.Barrier(2, timeout=10)
    built: list = []

    class SyncCrashEngine:
        def __init__(self, crash: bool):
            self.crash = crash
            self.metrics = P.Metrics()

        def generate(self, prompt, gen=None):
            yield P.token("a")
            if self.crash:
                barrier.wait()
                raise RuntimeError("injected concurrent crash")
            yield P.token("b")

    def factory():
        built.append(SyncCrashEngine(crash=not built))
        return built[-1]

    sup = P.SupervisedEngine(factory, max_restarts=5)
    errors: list = []

    def run():
        errors.append(_error(lambda: list(sup.generate("x", P.Gen()))))

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return {"errors": sorted(errors), "built": len(built), "health": _health(sup.health()),
            "next": sup.generate_text("x", P.Gen())}


def build_crash_fault(P):
    engines = [_fake(P, crashes=1), _fake(P)]
    sup = P.SupervisedEngine(lambda: engines.pop(0))
    with P.faults.armed("engine_build_crash", times=1):
        err = _error(lambda: list(sup.generate("x", P.Gen())))
    return {"error": err, "health": _health(sup.health())}


def _registry(P, max_models=2, loader=True):
    return P.ModelRegistry(
        "base", _fake(P), max_models=max_models,
        loader=(lambda mid, path, mesh, ctx: _fake(P)) if loader else None)


def unload_refuses_busy(P):
    reg = _registry(P)
    reg.load("m1", "/fake/a.gguf")
    sup = reg.get("m1")
    g = sup.generate("x", P.Gen())
    next(g)
    busy = {"inflight": sup.inflight, "health": _health(reg.health()["m1"]),
            "error": _error(lambda: reg.unload("m1")), "ids": reg.ids()}
    g.close()
    reg.unload("m1")
    return {**busy, "after": (sup.inflight, reg.ids())}


def eviction_defers_busy(P):
    reg = _registry(P)
    reg.load("m1", "/fake/a.gguf")
    g = reg.get("m1").generate("x", P.Gen())
    next(g)
    reg.load("m2", "/fake/b.gguf")
    over = sorted(reg.ids())
    g.close()
    reg.load("m3", "/fake/c.gguf")
    return {"over": over, "after": sorted(reg.ids())}


def load_unload_lru(P):
    reg = _registry(P)
    out = {"ids": reg.ids()}
    reg.load("m1", "/fake/a.gguf")
    out["again"] = _error(lambda: reg.load("m1", "/fake/a.gguf"))
    reg.load("m2", "/fake/b.gguf")
    out["evicted"] = sorted(reg.ids())
    out["get_m1"] = _error(lambda: reg.get("m1"))
    out["m2"] = reg.get("m2").status
    out["default"] = reg.get() is reg.get("base")
    reg.unload("m2")
    out["unload_default"] = _error(lambda: reg.unload("base"))
    out["unload_gone"] = _error(lambda: reg.unload("m2"))
    out["health"] = {k: _health(v) for k, v in reg.health().items()}
    return out


def capacity_one(P):
    reg = _registry(P, max_models=1)
    return {"error": _error(lambda: reg.load("m1", "/fake/a.gguf")), "ids": reg.ids()}


def shared_metrics(P):
    reg = _registry(P, max_models=3)
    reg.load("m1", "/fake/a.gguf")
    list(reg.get("m1").generate("x", P.Gen()))
    return {"m1": reg.get("m1").metrics is reg.metrics,
            "base": reg.get("base").metrics is reg.metrics,
            "engine": reg.get("m1").engine.metrics is reg.metrics,
            "boot": sorted(_counters(reg.metrics))}


def without_loader(P):
    reg = _registry(P, loader=False)
    return {"error": _error(lambda: reg.load("x", "/fake.gguf"))}


SCENARIOS = [restart_and_retry, mid_stream_crash, metrics_survive_restart,
             budget_exhausts, client_disconnect, concurrent_crashes, build_crash_fault,
             unload_refuses_busy, eviction_defers_busy, load_unload_lru, capacity_one,
             shared_metrics, without_loader]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_supervisor_scenarios_match_the_reference(scenario):
    try:
        want, got = scenario(REF), scenario(PORT)
    finally:
        jax_faults.disarm()
        faults.disarm()
    assert got == want


def test_scenarios_behave_as_the_reference_documents():
    """The records above hold what the reference's tests assert."""
    r = restart_and_retry(PORT)
    assert r["text"] == "ab" and r["restarts"] == 1 and r["health"]["restarts"] == 1
    m = mid_stream_crash(PORT)
    assert "crashed mid-stream" in m["error"] and m["text"] == "a" and m["next"] == "ab"
    b = budget_exhausts(PORT)
    assert "injected crash" in b["errors"][0] and "exceeded 2 restarts" in b["errors"][2]
    assert b["health"]["status"] == "failed"
    c = concurrent_crashes(PORT)
    assert c["built"] == 2 and c["health"]["restarts"] == 1 and c["next"] == "ab"
    assert eviction_defers_busy(PORT) == {"over": ["base", "m1", "m2"],
                                          "after": ["base", "m3"]}


# -- the server's routes -----------------------------------------------------


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "sup.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


def _loader(make):
    def load(mid, path, mesh, ctx):
        if mesh is not None:
            raise NotImplementedError("this loader refuses meshes")
        return make(path, ctx)
    return load


def _serve(app, requests: list) -> list:
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for method, route, body in requests:
                if method == "GET":
                    r = await client.get(route)
                elif isinstance(body, str):
                    r = await client.post(route, data=body)
                else:
                    r = await client.post(route, json=body)
                raw = (await r.read()).decode()
                if route == "/chat" and r.status == 200:
                    evs = [json.loads(ln[6:]) for ln in raw.split("\n")
                           if ln.startswith("data: ")]
                    body_out = "".join(e["content"] for e in evs
                                       if e["msg_type"] == "token")
                else:
                    body_out = json.loads(raw)
                out.append((r.status, body_out))
            return out
        finally:
            await client.close()

    return asyncio.run(go())


def _masked(answer):
    status, body = answer
    if isinstance(body, dict) and "models" in body and isinstance(body["models"], dict):
        body = {**body, "models": {k: _health(v) for k, v in body["models"].items()}}
    if isinstance(body, dict) and "data" in body:   # /v1/models: ids only
        body = sorted(m["id"] for m in body["data"])
    return status, body


def test_model_routes_give_the_reference_answers(gguf_path, tmp_path):
    base = {"id": "alt", "path": str(gguf_path)}
    reqs = [("GET", "/models", None),
            ("POST", "/models/load", "not json"),
            ("POST", "/models/load", {"id": "x"}),
            ("POST", "/models/load", {**base, "ctx": "abc"}),
            ("POST", "/models/load", {**base, "ctx": -5}),
            ("POST", "/models/load", {**base, "mesh": "2xbad"}),
            ("POST", "/models/load", {**base, "mesh": "2x1"}),
            ("POST", "/models/load", {**base, "id": "base"}),
            ("POST", "/models/load", {**base, "ctx": 64}),
            ("POST", "/models/load", {**base, "ctx": 64}),
            ("POST", "/models/load", {"id": "gone", "path": str(tmp_path / "none.gguf")}),
            ("GET", "/v1/models", None),
            ("GET", "/models", None),
            ("POST", "/chat", {"prompt": "hello", "model": "alt", "max_new_tokens": 4,
                               "temperature": 0.0}),
            ("POST", "/chat", {"prompt": "hello", "max_new_tokens": 4,
                               "temperature": 0.0}),
            ("POST", "/chat", {"prompt": "hi", "model": "nope"}),
            ("POST", "/v1/completions", {"prompt": "hi", "model": "nope"}),
            ("POST", "/models/unload", "not json"),
            ("POST", "/models/unload", {"id": "base"}),
            ("POST", "/models/unload", {"id": "alt"}),
            ("POST", "/models/unload", {"id": "alt"}),
            ("GET", "/healthz", None),
            ("GET", "/models", None)]
    jeng = JaxEngine(gguf_path, dtype=jnp.float32)
    jreg = REF.ModelRegistry("base", jeng, loader=_loader(
        lambda p, ctx: JaxEngine(p, dtype=jnp.float32, max_seq=ctx)))
    want = _serve(jax_serving.ChatServer(jeng, JaxGen(), model_id="base",
                                         registry=jreg).app, reqs)
    peng = Engine(gguf_path, dtype=torch.float32, device="cpu")
    preg = PORT.ModelRegistry("base", peng, loader=_loader(
        lambda p, ctx: Engine(p, dtype=torch.float32, device="cpu", max_seq=ctx)))
    got = _serve(serving.ChatServer(peng, GenerationConfig(), model_id="base",
                                    registry=preg).app, reqs)
    for (route_req, w, g) in zip(reqs, want, got):
        route = route_req[1]
        if route == "/healthz":   # the port's /healthz carries more keys
            assert g[0] == w[0] and g[1]["status"] == w[1]["status"] == "ok"
            assert _masked(g)[1]["models"] == _masked(w)[1]["models"]
            continue
        assert _masked(g) == _masked(w), route_req
    statuses = [s for s, _ in got]
    assert statuses == [200, 400, 400, 400, 400, 400, 400, 409, 200, 409, 500, 200,
                        200, 200, 200, 404, 404, 400, 400, 200, 404, 200, 200]
    assert got[13][1] and got[13][1] == got[14][1]   # the same GGUF, the same text


# -- the watchdog's repeat stall restarts a supervised engine -----------------


KW = dict(n_slots=2, decode_chunk=4, kv_block=16)
GREEDY = GenerationConfig(max_new_tokens=8, temperature=0.0, stop_on_eos=False)


def _stall_until(s, reached) -> dict:
    """Device stalls past a 0.25 s budget on consecutive steps, a request
    at a time, until ``reached()``: a repeat stall sets the restart, which
    lands on the worker once the step returns. Returns the first stalled
    request's done data."""
    s.stall_budget_s = 0.25
    first = None
    with faults.armed("device_stall", seconds=0.6, times=4):
        t_end = time.monotonic() + 60
        while not reached():
            assert time.monotonic() < t_end, "no repeat stall"
            while s._stalled.is_set():
                time.sleep(0.01)
            try:
                done = list(s.generate([9, 10, 11], GREEDY))[-1]
            except RuntimeError:   # a terminal restart closed the scheduler
                break
            first = first or done.data
    while s._stalled.is_set():
        time.sleep(0.01)
    s.stall_budget_s = 60.0
    return first


def test_repeat_stall_restarts_the_supervised_engine(gguf_path):
    built = []

    def factory():
        built.append(Engine(gguf_path, dtype=torch.float32, device="cpu"))
        return built[-1]

    sup = serving.SupervisedEngine(factory)
    s = SlotScheduler(sup, **KW)
    try:
        want = s.generate_text([5, 6, 7, 8], GREEDY)
        first = _stall_until(s, lambda: len(built) == 2 and s._backend.eng is built[1])
        assert first["finish_reason"] == "error" and "watchdog" in first["error"]
        assert len(built) == 2 and s.engine is built[1] and sup.status == "healthy"
        assert s._backend.eng is built[1]   # the backend was rebuilt on it
        assert s.generate_text([5, 6, 7, 8], GREEDY) == want
        c = sup.metrics.snapshot()["counters"]
        assert c["engine_restarts_total"] == 1 and c["scheduler_faults_total"] == 1
        assert c["watchdog_stalls_total"] >= 2
    finally:
        s.close()


def test_repeat_stall_with_the_budget_spent_is_terminal(gguf_path):
    sup = serving.SupervisedEngine(
        lambda: Engine(gguf_path, dtype=torch.float32, device="cpu"), max_restarts=0)
    s = SlotScheduler(sup, **KW)
    try:
        _stall_until(s, s._closed.is_set)
        assert sup.status == "failed" and sup.restarts == 0
        with pytest.raises((RuntimeError, SchedulerStalled), match="closed"):
            s.submit([5, 6], GREEDY, emit=lambda ev: None)
    finally:
        s.close()


# -- what a rebuild, an unload and an eviction end ----------------------------


class _Closable:
    """A port double that counts its ``close`` calls (a mesh's follower
    ranks end there)."""

    def __init__(self, crashes: int = 0):
        self.calls = self.closed = 0
        self.crashes = crashes
        self.metrics = utils.Metrics()

    def generate(self, prompt, gen=None):
        self.calls += 1
        if self.calls <= self.crashes:
            raise RuntimeError("injected crash")
        yield utils.token("a")

    def close(self):
        self.closed += 1


def test_dropped_engines_are_closed_once():
    """The port closes an engine before its rebuild (one mesh per process:
    the new one cannot start beside it), on unload and on eviction; a
    wrapper around one live engine reuses it on restart and leaves it open."""
    engines = [_Closable(crashes=1), _Closable()]
    old = engines[0]
    sup = serving.SupervisedEngine(lambda: engines.pop(0))
    assert sup.generate_text("x", GenerationConfig()) == "a"
    assert (old.closed, sup.engine.closed, sup.restarts) == (1, 0, 1)

    live = _Closable(crashes=1)
    reg = serving.ModelRegistry("base", live, loader=lambda mid, p, mesh, ctx: _Closable())
    assert reg.get().generate_text("x", GenerationConfig()) == "a"
    assert (live.closed, reg.get().engine is live, reg.get().restarts) == (0, True, 1)
    m1 = reg.load("m1", "/fake/a.gguf").engine
    reg.unload("m1")
    m2 = reg.load("m2", "/fake/b.gguf").engine
    reg.load("m3", "/fake/c.gguf")   # evicts m2
    assert (m1.closed, m2.closed, live.closed) == (1, 1, 0)
    assert sorted(reg.ids()) == ["base", "m3"]


def test_engine_path_restart_moves_the_slots_to_the_new_engine(gguf_path):
    """On a 2-slot server a context-shift request runs on the supervised
    engine under the decode lock. A crash there restarts the engine; the
    slots then decode with the new engine's model, the old engine's last
    reference goes with it, and a slot request gives the retried request's
    greedy text."""
    import gc
    import weakref

    built = []

    def factory():
        eng = Engine(gguf_path, dtype=torch.float32, device="cpu")
        built.append(weakref.ref(eng))
        return eng

    sup = serving.SupervisedEngine(factory)
    server = serving.ChatServer(sup, GenerationConfig(), model_id="base", parallel=2)
    sched = server.scheduler
    body = {"prompt": "hello world", "n_predict": 6, "temperature": 0.0}
    try:
        with faults.armed("prefill_oom", times=1):
            got = _serve(server.app, [("POST", "/completion", {**body, "context_shift": True}),
                                      ("POST", "/completion", body)])
    finally:
        faults.disarm()
    gc.collect()
    assert [s for s, _ in got] == [200, 200]
    assert got[0][1]["content"] and got[0][1]["content"] == got[1][1]["content"]
    assert sup.restarts == 1 and len(built) == 2
    assert built[0]() is None   # nothing holds the crashed engine's weights
    assert sched._backend.eng is sup.engine is built[1]()
