"""SLO scheduling on the port against the JAX package, on the CPU at f32:
priority classes and EDF admission, deadlines on the slots and on the one
stream, load shedding, tenant quotas, and the routes that serve them.

Requests are queued while the scheduler's worker is held inside a control
operation, so the EDF order alone decides admission, and both schedulers
grant rows (and the mixed step's prefill budget) in the same order. A
deadline is made to expire mid-decode by moving the clock the deadline
check reads (the scheduler's or the engine's ``time`` module) forward at a
chosen step, never by racing the wall clock: the request ends with
``timeout`` and its text is a prefix of the reference's unbounded text.
Shed decisions (a backed-up queue against a deadline, an over-quota tenant,
a stalled device, a full queue) match the reference scheduler's and reach
the client as 429 / 503 with an integer ``Retry-After``; ``priority`` and
``deadline_ms`` are served or refused with the reference's texts on
``/chat``, ``/completion``, ``/v1/completions`` and
``/v1/chat/completions``.
"""

import asyncio
import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        QueueFull, SlotScheduler)
from distributed_llm_pipeline_tpu_torch.runtime import engine as engine_mod
from distributed_llm_pipeline_tpu_torch.runtime import scheduler as sched_mod
from distributed_llm_pipeline_tpu_torch.serving import ChatServer

from .fixtures import make_spm_vocab, spm_metadata

KW = dict(n_slots=2, decode_chunk=4, kv_block=16, prefill_chunk=16)
N = 12


def _ids(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(5, 250, size=n)]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # the head's specials and byte tokens at zero: greedy text is pieces
    params["lm_head"] = params["lm_head"].at[:, :259].set(0.0)
    path = tmp_path_factory.mktemp("models") / "slo.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


@contextlib.contextmanager
def held(sched):
    """Hold the worker inside a control operation (either package's
    scheduler); what is submitted meanwhile is admitted in EDF order."""
    inside, release = threading.Event(), threading.Event()

    def block():
        inside.set()
        release.wait(60)

    t = threading.Thread(target=sched._control, args=(block,))
    t.start()
    assert inside.wait(60)
    try:
        yield
    finally:
        release.set()
        t.join(60)


def _submit_all(sched, reqs, gen_cls, **sched_kw):
    """Submit (name, prompt, gen kwargs) while held; returns the events of
    each request and the global order of its grant ("slot r/B" log) and of
    its first token."""
    lock = threading.Lock()
    events: dict[str, list] = {n: [] for n, _, _ in reqs}
    order: list[tuple[str, str]] = []
    done = threading.Semaphore(0)

    def emit_for(name):
        def emit(ev):
            with lock:
                events[name].append(ev)
                if ev.kind == "log" and ev.content.startswith("slot "):
                    order.append(("grant", name))
                elif ev.kind == "log" and ev.content.startswith("prefill:"):
                    order.append(("ttft", name))
            if ev.kind == "done":
                done.release()
        return emit

    with held(sched):
        for name, prompt, kw in reqs:
            sched.submit(prompt, gen_cls(**kw), emit=emit_for(name), **sched_kw)
    for _ in reqs:
        assert done.acquire(timeout=120)
    return events, order


def _text(evs):
    return "".join(e.content for e in evs if e.kind == "token")


def _done(evs):
    return [e for e in evs if e.kind == "done"][-1].data


# -- EDF admission -------------------------------------------------------------

def test_grants_and_prefill_budget_follow_the_reference_edf_order(engines):
    greedy = dict(max_new_tokens=6, temperature=0.0, stop_on_eos=False)
    reqs = [("b1", _ids(1, 9), dict(greedy, priority="batch")),
            ("n1", _ids(2, 9), dict(greedy, priority="normal")),
            ("i1", _ids(3, 9), dict(greedy, priority="interactive")),
            ("n2", _ids(4, 9), dict(greedy, priority="normal", deadline_ms=60000.0)),
            ("b2", _ids(5, 9), dict(greedy, priority="batch"))]
    # two long prompts prefilling together: the interactive one takes the
    # mixed step's budget first and reaches its first token first
    long = [("lb", _ids(6, 40), dict(greedy, priority="batch")),
            ("li", _ids(7, 40), dict(greedy, priority="interactive"))]
    got = {}
    for key, sched, gen_cls in (
            ("port", SlotScheduler(engines[1], **KW), GenerationConfig),
            ("ref", JaxSlotScheduler(engines[0], preempt=False, **KW), JaxGen)):
        try:
            got[key] = (_submit_all(sched, reqs, gen_cls),
                        _submit_all(sched, long, gen_cls))
        finally:
            sched.close()
    (pe, po), (ple, plo) = got["port"]
    (re_, ro), (rle, rlo) = got["ref"]
    grants = [n for kind, n in po if kind == "grant"]
    assert grants == [n for kind, n in ro if kind == "grant"]
    assert grants == ["i1", "n2", "n1", "b1", "b2"]
    ttfts = [n for kind, n in plo if kind == "ttft"]
    assert ttfts == [n for kind, n in rlo if kind == "ttft"] == ["li", "lb"]
    for name in pe:
        assert _text(pe[name]) == _text(re_[name]), name
    for name in ple:
        assert _text(ple[name]) == _text(rle[name]), name


# -- deadlines -------------------------------------------------------------------

class _Clock:
    """The ``time`` module a deadline check reads, with a movable offset."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self):
        return time.monotonic() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


def _bump_on_call(obj, name, clock, call: int):
    """Wrap ``obj.name`` so that its ``call``-th call moves the clock on
    by 1000 s."""
    fn = getattr(obj, name)
    n = [0]

    def wrapped(*a, **k):
        n[0] += 1
        if n[0] == call:
            clock.offset += 1000.0
        return fn(*a, **k)

    setattr(obj, name, wrapped)


def _ref_text(jeng, prompt, n=N):
    return "".join(e.content for e in jeng.generate(
        prompt, JaxGen(max_new_tokens=n, temperature=0.0, stop_on_eos=False))
        if e.kind == "token")


def test_slot_deadline_mid_decode_delivers_a_prefix(engines, monkeypatch):
    jeng, peng = engines
    clock = _Clock()
    monkeypatch.setattr(sched_mod, "time", clock)
    sched = SlotScheduler(peng, **KW)
    try:
        # the first decode chunk is delivered; the deadline has passed when
        # the second one is read back, whose tokens are dropped
        _bump_on_call(sched, "_launch", clock, 3)
        prompt = _ids(8, 10)
        evs = list(sched.generate(prompt, GenerationConfig(
            max_new_tokens=N, temperature=0.0, stop_on_eos=False,
            deadline_ms=60000.0)))
        d = _done(evs)
        assert d["finish_reason"] == "timeout" and d["n_gen"] == 5
        want = _ref_text(jeng, prompt)
        assert want.startswith(_text(evs)) and want != _text(evs)
        assert any("deadline exceeded" in e.content for e in evs if e.kind == "log")
        assert sched.counters["requests_timed_out_total"] == 1
        # the row keeps its KV as a retained prefix (prompt + fed tokens)
        assert any(len(ids) == len(prompt) + 4 for ids in sched._row_ids)
    finally:
        sched.close()


def test_slot_deadline_after_prefill_and_in_the_queue(engines, monkeypatch):
    _, peng = engines
    clock = _Clock()
    monkeypatch.setattr(sched_mod, "time", clock)
    sched = SlotScheduler(peng, **KW)
    try:
        gen = GenerationConfig(max_new_tokens=N, temperature=0.0, stop_on_eos=False,
                               deadline_ms=60000.0)
        prompt = _ids(9, 10)
        _bump_on_call(sched._backend, "prefill_row", clock, 1)
        evs = list(sched.generate(prompt, gen))
        assert _done(evs)["finish_reason"] == "timeout" and _done(evs)["n_gen"] == 0
        assert prompt in sched._row_ids          # the prompt's KV is kept
        # expired while queued: no prefill at all
        before = sched.counters["prefill_tokens_total"]
        out = []
        with held(sched):
            sched.submit(_ids(10, 10), gen, emit=out.append)
            clock.offset += 1000.0
        t_end = time.monotonic() + 60
        while not out or out[-1].kind != "done":
            assert time.monotonic() < t_end
            time.sleep(0.005)
        d = out[-1].data
        assert d["finish_reason"] == "timeout" and d["n_gen"] == 0
        assert "while queued" in out[-1].content
        assert sched.counters["prefill_tokens_total"] == before
    finally:
        sched.close()


def test_engine_deadline_mid_decode_delivers_a_prefix(engines, monkeypatch):
    jeng, peng = engines
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    monkeypatch.setattr(peng, "decode_chunk", 4)
    prompt = _ids(11, 10)
    gen = GenerationConfig(max_new_tokens=N, temperature=0.0, stop_on_eos=False,
                           deadline_ms=60000.0)
    _bump_on_call(peng, "_decode_chunk", clock, 2)
    try:
        evs = list(peng.generate(prompt, gen))
    finally:
        del peng._decode_chunk
    d = _done(evs)
    assert d["finish_reason"] == "timeout" and d["n_gen"] == 5
    want = _ref_text(jeng, prompt)
    assert want.startswith(_text(evs)) and want != _text(evs)
    # after prefill: nothing sampled
    monkeypatch.setattr(peng, "prefill", _bumped(peng.prefill, clock))
    evs = list(peng.generate(prompt, gen))
    assert _done(evs)["finish_reason"] == "timeout" and _done(evs)["n_gen"] == 0
    assert any("during prefill" in e.content for e in evs if e.kind == "log")


def _bumped(fn, clock):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        clock.offset += 1000.0
        return out
    return wrapped


def test_engine_constrained_deadline_stops_the_stream(engines, monkeypatch):
    _, peng = engines
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    gen = GenerationConfig(max_new_tokens=N, temperature=0.0, json_mode=True)
    full = _text(list(peng.generate("hello", gen)))
    _bump_on_call(peng, "_shortlist", clock, 3)
    try:
        evs = list(peng.generate("hello", GenerationConfig(
            max_new_tokens=N, temperature=0.0, json_mode=True, deadline_ms=60000.0)))
    finally:
        del peng._shortlist
    d = _done(evs)
    assert d["finish_reason"] == "timeout" and d["n_gen"] == 3
    assert full.startswith(_text(evs))


@pytest.mark.parametrize("bad", [0, -5.0])
def test_nonpositive_deadline_is_refused_like_the_reference(engines, bad):
    jeng, peng = engines
    errs = []
    for eng, cls in ((jeng, JaxGen), (peng, GenerationConfig)):
        with pytest.raises(ValueError) as e:
            eng.generate("x", cls(deadline_ms=bad))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "deadline_ms must be positive" in errs[1]
    sched = SlotScheduler(peng, **KW)
    try:
        with pytest.raises(ValueError, match="deadline_ms must be positive"):
            sched.submit("x", GenerationConfig(deadline_ms=bad), emit=lambda ev: None)
        with pytest.raises(ValueError, match="unknown priority class 'high'"):
            sched.submit("x", GenerationConfig(priority="high"), emit=lambda ev: None)
    finally:
        sched.close()


# -- shedding and tenants ----------------------------------------------------------

def _backlog(sched, gen_cls, n=4, **kw):
    for i in range(n):
        sched.submit(_ids(20 + i, 9), gen_cls(max_new_tokens=2, temperature=0.0, **kw),
                     emit=lambda ev: None)


def _strip(shed):
    return None if shed is None else {k: v for k, v in shed.items() if k != "request_id"}


def test_shed_decisions_match_the_reference(engines, monkeypatch):
    monkeypatch.setenv("DLP_TENANT_QUOTA", "1")
    jeng, peng = engines
    got = {}
    for key, sched, cls in (
            ("port", SlotScheduler(peng, max_queue=6, **KW), GenerationConfig),
            ("ref", JaxSlotScheduler(jeng, max_queue=6, preempt=False, **KW), JaxGen)):
        try:
            out = {}
            with held(sched):
                _backlog(sched, cls)
                sched.submit(_ids(30, 9), cls(max_new_tokens=2), emit=lambda ev: None,
                             tenant="a")
                out["deadline"] = sched.shed_check(cls(deadline_ms=1000.0))
                out["deadline_ok"] = sched.shed_check(cls(deadline_ms=9000.0))
                out["interactive"] = sched.shed_check(
                    cls(deadline_ms=1000.0, priority="interactive"))
                out["tenant_a"] = sched.shed_check(cls(), tenant="a")
                out["tenant_b"] = sched.shed_check(cls(), tenant="b")
                with pytest.raises(QueueFull if key == "port" else Exception,
                                   match="over quota"):
                    sched.submit("x", cls(), emit=lambda ev: None, tenant="a")
                sched.submit("y", cls(max_new_tokens=2), emit=lambda ev: None)
                out["full"] = sched.shed_check(cls())
                with pytest.raises(Exception, match="queue full"):
                    sched.submit("z", cls(), emit=lambda ev: None)
            got[key] = {k: _strip(v) for k, v in out.items()}
        finally:
            sched.close()
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p["deadline"]["status"] == 429 and p["deadline"]["retry_after_s"] == 3
    assert p["deadline_ok"] is None and p["interactive"] is None
    assert p["tenant_a"]["status"] == 429 and p["tenant_b"] is None
    assert p["full"]["status"] == 429


async def _post(client, route, body, headers=None):
    r = await client.post(route, json=body, headers=headers or {})
    ra = r.headers.get("Retry-After")
    if r.content_type == "text/event-stream":
        return r.status, (await r.text()), ra
    return r.status, await r.json(), ra


def _serve(server, calls, hold=None, before=None):
    """POST each (route, body, headers) to ``server``; with ``hold`` (a
    scheduler) the worker is held meanwhile, ``before`` run inside."""
    async def go():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            return [await _post(client, *c) for c in calls]
        finally:
            await client.close()

    if hold is None:
        return asyncio.run(go())
    with held(hold):
        if before is not None:
            before()
        return asyncio.run(go())


VALIDATION = [("/chat", {"prompt": "x", "priority": "urgent"}),
              ("/chat", {"prompt": "x", "deadline_ms": "soon"}),
              ("/chat", {"prompt": "x", "deadline_ms": -1}),
              ("/completion", {"prompt": "x", "priority": 7}),
              ("/completion", {"prompt": "x", "deadline_ms": 0}),
              ("/v1/completions", {"prompt": "x", "deadline_ms": "x"}),
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                                        "priority": "high"})]


def test_priority_and_deadline_validation_matches_the_reference(engines):
    jeng, peng = engines
    calls = [(r, b) for r, b in VALIDATION]
    port = _serve(ChatServer(peng, GenerationConfig(temperature=0.0)), calls)
    ref = _serve(JaxChatServer(jeng, JaxGen(temperature=0.0)), calls)
    for (route, body), p, r in zip(calls, port, ref):
        assert p[0] == r[0] == 400, (route, body, p)
        assert p[1] == r[1], (route, body)


def test_routes_serve_priority_and_deadline(engines):
    jeng, peng = engines
    greedy = {"temperature": 0.0, "priority": "interactive", "deadline_ms": 60000}
    calls = [("/chat", {"prompt": "hello", "max_new_tokens": 4, **greedy}),
             ("/completion", {"prompt": "hello", "n_predict": 4, **greedy}),
             ("/v1/completions", {"prompt": "hello", "max_tokens": 4, **greedy}),
             ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                       "max_tokens": 4, **greedy})]
    for parallel in (1, 2):
        server = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=parallel)
        ref = JaxChatServer(jeng, JaxGen(temperature=0.0), parallel=parallel)
        try:
            got, want = _serve(server, calls), _serve(ref, calls)
        finally:
            for s in (server.scheduler, ref.scheduler):
                if s is not None:
                    s.close()
        assert [g[0] for g in got] == [200] * 4
        assert got[1][1]["content"] == want[1][1]["content"]
        assert got[1][1]["timed_out"] is False
        assert got[2][1]["choices"][0]["text"] == want[2][1]["choices"][0]["text"]
        assert got[3][1]["choices"][0]["message"] == want[3][1]["choices"][0]["message"]


def test_sheds_reach_the_client_with_retry_after(engines, monkeypatch):
    monkeypatch.setenv("DLP_TENANT_QUOTA", "1")
    _, peng = engines
    server = ChatServer(peng, GenerationConfig(temperature=0.0, max_new_tokens=2),
                        parallel=2)
    sched = server.scheduler
    msgs = [{"role": "user", "content": "hi"}]
    shed_calls = [("/completion", {"prompt": "x", "deadline_ms": 1000}),
                  ("/v1/completions", {"prompt": "x", "deadline_ms": 1000, "stream": True}),
                  ("/v1/chat/completions", {"messages": msgs, "deadline_ms": 1000}),
                  ("/chat", {"prompt": "x", "deadline_ms": 1000}),
                  ("/chat", {"prompt": "x"}, {"X-DLP-Tenant": "a"}),
                  ("/chat", {"prompt": "x", "tenant": "a"})]

    def tenant_a():
        sched.submit("t", GenerationConfig(max_new_tokens=2), emit=lambda ev: None,
                     tenant="a")

    async def go():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            with held(sched):
                _backlog(sched, GenerationConfig)
                tenant_a()
                shed = [await _post(client, *c) for c in shed_calls]
            # the other tenant is admitted while "a" is at its quota
            with held(sched):
                if sched.tenant_load("a") < 1:
                    tenant_a()
                depth = sched.queue_depth
                task = asyncio.ensure_future(_post(
                    client, "/chat", {"prompt": "x", "max_new_tokens": 2},
                    {"X-DLP-Tenant": "b"}))
                t_end = time.monotonic() + 60
                while sched.queue_depth == depth:
                    assert time.monotonic() < t_end and not task.done()
                    await asyncio.sleep(0.005)
            served = await task
            # a stalled device is a 503
            sched._stalled.set()
            try:
                stalled = await _post(client, "/v1/completions", {"prompt": "x"})
            finally:
                sched._stalled.clear()
            return shed, served, stalled
        finally:
            await client.close()   # closes the scheduler too

    shed, served, stalled = asyncio.run(go())
    for (route, body, *_), (status, ans, ra) in zip(shed_calls, shed):
        assert status == 429 and ra is not None and ra.isdigit(), (route, ans)
        assert int(ra) >= 1
        err = ans["error"]
        msg = err["message"] if isinstance(err, dict) else err
        assert ("deadline" in msg) if "deadline_ms" in body else ("over quota" in msg)
    assert served[0] == 200 and '"finish_reason": "length"' in served[1]
    status, ans, ra = stalled
    assert status == 503 and ra.isdigit() and "stalled" in ans["error"]["message"]
