"""The port's request tracer (``utils/tracing.py``) against the JAX package's,
on the CPU.

The copied functions give the reference's answers on the same inputs: the
``X-DLP-Trace`` context round trip, the ring's eviction with failures and
sheds pinned in their own pools, ``export`` as loadable Chrome / Perfetto
trace-event JSON, ``tree`` and ``summary``, and the fleet merge; ``finish``
seals once across threads. ``join_profile`` reads a ``torch.profiler``
Chrome trace: kernel timelines clipped into the request window on a shared
clock, attributed coarsely on another, host lanes on the CPU.

The port's engine and slots beside the JAX engine at f32 over a fixture
GGUF record the same span families and finish reasons for a greedy request,
an abort and a shed, with ``request_id`` in the done event; the server puts
it on ``/completion`` chunks and answers and on the shed body, and serves
``/debug/trace``, ``/debug/perf`` and a 1-step ``/debug/profile``
(``torch.profiler`` on the CPU); ``--profile-dir`` joins each request's run
onto its trace.
"""

import asyncio
import gc
import io
import json
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import distributed_llm_pipeline_tpu.utils.tracing as ref
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig, SlotScheduler
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.utils import TRACER, profile_trace, tracing

from .fixtures import make_spm_vocab, spm_metadata

HEADERS = ["req-00000001;hop=2;attempt=1", "fleet", "f;hop=x;attempt=3", "", None,
           ";hop=1", "a" * 129, " id ; hop = 4 ;attempt=0;extra=1", 7, "x;hop=-1"]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_trace_context_parses_as_the_reference(header):
    assert tracing.parse_trace_context(header) == ref.parse_trace_context(header)


@pytest.mark.parametrize("fleet_id,hop,attempt", [("req-00000001", 0, 0), ("f-9", 3, 2)])
def test_trace_context_round_trips(fleet_id, hop, attempt):
    wire = tracing.format_trace_context(fleet_id, hop, attempt)
    assert wire == ref.format_trace_context(fleet_id, hop, attempt)
    assert tracing.parse_trace_context(wire) == {"fleet_id": fleet_id, "hop": hop,
                                                 "attempt": attempt}
    assert tracing.TRACE_HEADER == ref.TRACE_HEADER == "X-DLP-Trace"


FINISHES = ["stop", "error", "length", "shed", "timeout", "stop", "abort", "shed",
            "stop", "length", "error", "shed", "stop", "shed", "timeout"]


def _ring(mod):
    tr = mod.Tracer(capacity=3, pin_capacity=4, enabled=True, json_log=False)
    for i, reason in enumerate(FINISHES):
        if reason == "shed":
            tr.record_shed(f"queue full {i}", 429, model="llama")
        else:
            tr.start_request(kind="engine").finish(reason, n_gen=i)
    tr.start_request(kind="slots")   # one live
    return [(s["request_id"], s["finish_reason"], s["pinned"]) for s in tr.requests()]


def test_the_ring_evicts_as_the_reference_and_pins_failures():
    got = _ring(tracing)
    assert got == _ring(ref)
    reasons = [r for _, r, _ in got]
    # the last three clean finishes, the last three sheds, the last four of
    # five failures (pinned), one live
    assert sorted(reasons[:-1]) == sorted(["stop", "length", "stop", "shed", "shed",
                                           "shed", "timeout", "abort", "error", "timeout"])
    assert reasons[-1] is None
    assert [p for _, r, p in got if r in ("error", "timeout", "abort", "shed")] == [True] * 7


def _built(mod, kind="engine", fleet="fleet-1", hop=1):
    tracer = mod.Tracer(capacity=4, enabled=True, json_log=False)
    tracer.epoch_ns = 1_700_000_000_000_000_000
    t = tracer.start_request(kind=kind, model="llama")
    t.t0, t.t0_epoch_ns = 100.0, 1_700_000_000_500_000_000
    for span in (("queue", 100.0, 100.002, {"depth": 1}),
                 ("prefill", 100.002, 100.010, {"n_prompt": 5, "reused": 0}),
                 ("decode[1]", 100.010, 100.030, {"tokens": 4}),
                 ("detokenize", 100.030, 100.031, {}),
                 ("swap_out", 100.031, 100.032, {"row": 1}),
                 ("device:cuda:0", 100.011, 100.029,
                  {"busy_ms": 1.0, "bubble_pct": 5.0, "mode": "device",
                   "correlation": "clock"})):
        t.add_span(span[0], span[1], span[2], **span[3])
    t.events.append(("deadline_exceeded", 100.02, {"phase": "decode"}))
    t.set_context(fleet, hop=hop, attempt=0)
    t.finish("stop", n_prompt=5, n_gen=4, ttft_ms=10.0, tok_s=200.0, model="llama")
    t.t1 = 100.05
    return t


def test_export_is_the_reference_s_loadable_trace_event_json():
    got, want = _built(tracing), _built(ref)
    exp = json.loads(json.dumps(got.export()))
    assert exp == json.loads(json.dumps(want.export()))
    assert {e["ph"] for e in exp["traceEvents"]} == {"M", "X", "i"}
    assert [e["name"] for e in exp["traceEvents"] if e["ph"] == "X"][:3] == \
        ["request", "queue", "prefill"]
    assert got.tree() == want.tree()
    assert got.summary() == want.summary()
    assert got.span_durations_ms() == want.span_durations_ms()
    assert tracing.rid_args(got) == {"request_id": got.request_id}
    assert tracing.rid_args(tracing.NULL_TRACE) == ref.rid_args(ref.NULL_TRACE) == {}
    assert not tracing.NULL_TRACE and tracing.NULL_TRACE.request_id is None


def test_fleet_merge_is_the_reference_s():
    def sources(mod):
        router = _built(mod, kind="router", hop=0)
        replica = _built(mod, hop=1)
        replica.t0_epoch_ns += 2_000_000
        return [{"label": "router", "traces": [router.export()]},
                {"label": "r1", "traces": [replica.export(), router.export()]}]

    got = tracing.merge_fleet_traces(sources(tracing), "fleet-1")
    assert got == ref.merge_fleet_traces(sources(ref), "fleet-1")
    assert got["otherData"]["processes"] == 2 and got["otherData"]["aligned"]
    assert got["budget_ms"]["total_ms"] == pytest.approx(50.0)
    tr = tracing.Tracer(enabled=True, json_log=False)
    t = tr.start_request()
    t.set_context("fleet-9", hop=2)
    tr.start_request().set_context("other")
    assert [x["otherData"]["request_id"] for x in tr.export_fleet("fleet-9")["traces"]] \
        == [t.request_id]


def test_finish_seals_once_across_threads():
    log = io.StringIO()
    tr = tracing.Tracer(capacity=8, enabled=True, json_log=True, log_stream=log)
    t = tr.start_request(kind="slots")
    gate = threading.Barrier(16)

    def finish(i):
        gate.wait()
        t.finish("error" if i % 2 else "stop", n_gen=i)

    threads = [threading.Thread(target=finish, args=(i,)) for i in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(tr.requests()) == 1
    lines = log.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert (line["request_id"], line["finish_reason"]) == (t.request_id, t.finish_reason)
    assert line["event"] == "request_finish" and line["n_gen"] == t.stats["n_gen"]


def _chrome(path, base_ns, events):
    path.mkdir(parents=True, exist_ok=True)
    (path / "trace.json").write_text(json.dumps(
        {"baseTimeNanoseconds": base_ns, "traceEvents": events}))


def _kernel(ts_us, dur_us, device=0, name="split_kernel", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": device, "tid": 7, "args": {"device": device, "stream": 7}}


def test_join_profile_clips_device_timelines_into_the_request(tmp_path):
    tr = tracing.Tracer(enabled=True, json_log=False)
    t = tr.start_request()
    time.sleep(0.02)
    t.finish("stop")
    # device 0: two kernels 2 ms and 5 ms into the request (busy 1.5 ms of a
    # 4 ms window, the overlap counted once); device 1: a copy
    _chrome(tmp_path / "clock", t.t0_epoch_ns, [
        _kernel(2000.0, 1000.0), _kernel(2500.0, 500.0, name="merge_kernel"),
        _kernel(5500.0, 500.0), _kernel(3000.0, 100.0, device=1, cat="gpu_memcpy"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0, "dur": 9.0,
         "pid": 1, "tid": 1}])
    assert t.join_profile(str(tmp_path / "clock")) == 2
    spans = {n: (a, b, args) for n, a, b, args in t.spans}
    a, b, args = spans["device:cuda:0"]
    assert (a - t.t0, b - t.t0) == pytest.approx((0.002, 0.006), abs=1e-6)
    assert args["busy_ms"] == 1.5 and args["bubble_pct"] == 62.5
    assert (args["mode"], args["correlation"]) == ("device", "clock")
    assert spans["device:cuda:1"][2]["busy_ms"] == 0.1
    # no shared clock: the whole timeline lands on the request, coarsely
    t2 = tr.start_request()
    t2.finish("stop")
    _chrome(tmp_path / "coarse", 0, [_kernel(100.0, 40.0)])
    assert t2.join_profile(str(tmp_path / "coarse")) == 1
    assert t2.spans[0][3]["correlation"] == "coarse"
    # the CPU: host operator lanes stand in
    t3 = tr.start_request()
    _chrome(tmp_path / "cpu", t3.t0_epoch_ns, [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10.0, "dur": 5.0,
         "pid": 1, "tid": 42}])
    assert t3.join_profile(str(tmp_path / "cpu")) == 1
    assert t3.spans[0][0] == "device:host:42" and t3.spans[0][3]["mode"] == "lanes"
    assert tracing.NULL_TRACE.join_profile(str(tmp_path / "cpu")) == 0
    assert t3.join_profile(str(tmp_path / "missing")) == 0
    assert profile_trace.top_kernels(str(tmp_path / "clock")) == [
        {"kernel": "split_kernel", "total_ms": 1.5, "count": 2},
        {"kernel": "merge_kernel", "total_ms": 0.5, "count": 1}]


# -- the engine, the slots and the server beside the JAX engine ----------------

N = 8
PROMPT = "once upon a time there was"


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params["lm_head"] = params["lm_head"].at[:, :259].set(0.0)
    path = tmp_path_factory.mktemp("models") / "trace.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


def _families(trace) -> list[str]:
    return list(dict.fromkeys(n.split("[", 1)[0] for n in trace.span_names()))


def _started(tracer, before: set):
    """The one trace started since the ids ``before`` were listed."""
    (rid,) = {s["request_id"] for s in tracer.requests()} - before
    return tracer.get(rid)


def _aborted(gen_fn, prompt, cfg, tracer):
    """Leave a stream at its first token; its trace once sealed."""
    before = {s["request_id"] for s in tracer.requests()}
    stream = gen_fn(prompt, cfg)
    next(e for e in stream if e.kind == "token")
    stream.close()
    trace = _started(tracer, before)
    t_end = time.monotonic() + 10.0
    while not trace.done and time.monotonic() < t_end:
        time.sleep(0.01)
    return trace


def test_the_engine_traces_the_reference_spans_and_finishes(engines):
    je, pe = engines
    want = list(je.generate(PROMPT, JaxGen(max_new_tokens=N, temperature=0.0)))
    got = list(pe.generate(PROMPT, GenerationConfig(max_new_tokens=N, temperature=0.0)))
    tw = ref.TRACER.get(want[-1].data["request_id"])
    tg = TRACER.get(got[-1].data["request_id"])
    assert tg.finish_reason == tw.finish_reason == "length"
    assert _families(tg) == _families(tw) == ["prefill", "decode", "detokenize"]
    assert {k: tg.summary()[k] for k in ("kind", "n_prompt", "n_gen", "pinned")} == \
        {k: tw.summary()[k] for k in ("kind", "n_prompt", "n_gen", "pinned")}
    assert tg.stats["n_gen"] == N
    # a client that leaves mid-stream: an abort, on both
    for gen_fn, cfg, tracer in ((je.generate, JaxGen, ref.TRACER),
                                (pe.generate, GenerationConfig, TRACER)):
        aborted = _aborted(gen_fn, PROMPT, cfg(max_new_tokens=N, temperature=0.0), tracer)
        assert aborted.finish_reason == "abort" and aborted.summary()["pinned"]


def test_a_deleted_engine_is_freed_without_a_collection(gguf_path):
    """The perf monitor reads its engine's metrics through a weak reference,
    so the last reference's drop frees the engine, and its device memory, at
    once rather than at the next garbage collection."""
    gc.collect()
    gc.disable()
    try:
        engine = Engine(gguf_path, dtype=torch.float32, device="cpu")
        list(engine.generate(PROMPT, GenerationConfig(max_new_tokens=2, temperature=0.0)))
        assert engine.perf._metrics_fn() is engine.metrics
        (steps,) = engine.perf.snapshot()["backends"].values()
        assert steps["steps_total"] >= 1
        alive = weakref.ref(engine)
        del engine
        assert alive() is None
    finally:
        gc.enable()


def test_the_slots_trace_the_reference_spans_and_sheds(engines):
    je, pe = engines
    kw = dict(n_slots=2, decode_chunk=4, kv_block=16, prefill_chunk=16, max_queue=0)
    jax_sched, port_sched = JaxSlotScheduler(je, **kw), SlotScheduler(pe, **kw)
    try:
        out = {}
        for name, sched, cfg, tracer in (("ref", jax_sched, JaxGen, ref.TRACER),
                                         ("port", port_sched, GenerationConfig, TRACER)):
            shed = sched.shed_check(cfg(max_new_tokens=N), PROMPT)
            sched.max_queue = 8
            events = list(sched.generate(PROMPT, cfg(max_new_tokens=N, temperature=0.0)))
            trace = tracer.get(events[-1].data["request_id"])
            aborted = _aborted(sched.generate, PROMPT,
                               cfg(max_new_tokens=64, temperature=0.0), tracer)
            out[name] = (shed, tracer.get(shed["request_id"]), trace, aborted)
        for name in ("ref", "port"):
            shed, shed_tr, trace, aborted = out[name]
            assert shed["status"] == 429 and shed["request_id"] == shed_tr.request_id
            assert (shed_tr.kind, shed_tr.finish_reason) == ("shed", "shed")
            assert aborted.finish_reason == "abort"
        (rs, rst, rt, ra), (ps, pst, pt, pa) = out["ref"], out["port"]
        assert {k: v for k, v in ps.items() if k != "request_id"} == \
            {k: v for k, v in rs.items() if k != "request_id"}
        assert pst.summary()["events"] == rst.summary()["events"] == ["shed"]
        assert pt.finish_reason == rt.finish_reason == "length"
        assert _families(pt) == _families(rt)
        assert {"queue", "prefill", "decode", "detokenize"} <= set(_families(pt))
        assert [e[0] for e in pt.events] == [e[0] for e in rt.events] == ["admit"]
        assert _families(pa)[:2] == _families(ra)[:2] == ["queue", "prefill"]
    finally:
        jax_sched.close()
        port_sched.close()


async def _serve(app, steps):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await steps(client)
    finally:
        await client.close()


def test_the_server_carries_request_ids_and_serves_the_debug_routes(engines, tmp_path,
                                                                    monkeypatch):
    monkeypatch.setenv("DLP_PROFILE_DIR", str(tmp_path))
    pe = engines[1]
    server = ChatServer(pe, GenerationConfig(temperature=0.0), parallel=2)

    async def steps(c):
        out = {}
        r = await c.post("/chat", json={"prompt": PROMPT, "max_new_tokens": 4},
                         headers={"X-DLP-Trace": "fleet-7;hop=1;attempt=0"})
        out["chat"] = [json.loads(ln[6:]) for ln in (await r.text()).splitlines()
                       if ln.startswith("data: ")]
        r = await c.post("/completion", json={"prompt": PROMPT, "n_predict": 4})
        out["completion"] = await r.json()
        r = await c.post("/completion", json={"prompt": PROMPT, "n_predict": 4,
                                              "stream": True})
        out["stream"] = [json.loads(ln[6:]) for ln in (await r.text()).splitlines()
                         if ln.startswith("data: ")]
        server.scheduler.max_queue = 0
        for route in ("/chat", "/completion"):
            r = await c.post(route, json={"prompt": PROMPT, "max_new_tokens": 4,
                                          "n_predict": 4})
            out[f"shed{route}"] = (r.status, r.headers.get("Retry-After"), await r.json())
        server.scheduler.max_queue = 64
        out["list"] = await (await c.get("/debug/trace")).json()
        rid = out["completion"]["request_id"]
        out["one"] = await (await c.get(f"/debug/trace?id={rid}")).json()
        r = await c.get("/debug/trace?id=req-ffffffff")
        out["missing"] = r.status
        out["fleet"] = await (await c.get("/debug/trace?fleet=fleet-7")).json()
        out["perf"] = await (await c.get("/debug/perf")).json()
        r = await c.post("/debug/profile", json={"steps": 0})
        out["bad_profile"] = r.status
        profile = asyncio.create_task(c.post("/debug/profile",
                                             json={"steps": 1, "timeout_s": 20}))
        while pe.perf._profile is None and not profile.done():
            await asyncio.sleep(0.005)   # the request starts once the window is armed
        r = await c.post("/chat", json={"prompt": PROMPT, "max_new_tokens": 8})
        await r.read()
        r = await profile
        out["profile"] = (r.status, await r.json())
        return out

    out = asyncio.run(_serve(server.app, steps))
    done = out["chat"][-1]
    assert done["finish_reason"] == "length" and done["request_id"].startswith("req-")
    assert out["completion"]["request_id"].startswith("req-")
    assert out["stream"][-1]["stop"] and out["stream"][-1]["request_id"].startswith("req-")
    assert all("request_id" not in ch for ch in out["stream"][:-1])
    for route in ("/chat", "/completion"):
        status, retry, body = out[f"shed{route}"]
        assert status == 429 and retry.isdigit() and "queue full" in str(body["error"])
        shed = TRACER.get(body["request_id"])
        assert shed.finish_reason == "shed" and shed.summary()["pinned"]
    listed = {s["request_id"] for s in out["list"]["requests"]}
    assert {done["request_id"], out["completion"]["request_id"],
            out["shed/chat"][2]["request_id"]} <= listed
    assert out["list"]["enabled"] and out["list"]["capacity"] == TRACER.capacity
    names = [e["name"] for e in out["one"]["traceEvents"] if e["ph"] == "X"]
    assert names[0] == "request" and "prefill" in names and "decode[1]" in names
    assert out["missing"] == 404
    assert [t["otherData"]["request_id"] for t in out["fleet"]["traces"]] == \
        [done["request_id"]]
    perf = out["perf"]
    assert perf["enabled"] and perf["kernels_static"] == []
    assert perf["roofline"]["hbm_peak_source"] == "assumed:cpu"
    assert perf["backends"]["paged"]["step_ms"]["p50"] > 0
    assert set(perf["compile"]) == {"xla_compiles_total", "xla_retraces_total"}
    assert out["bad_profile"] == 400
    status, summary = out["profile"]
    assert status == 200 and summary["steps_captured"] == 1
    assert summary["profile_dir"].startswith(str(tmp_path))
    assert profile_trace.trace_file(summary["profile_dir"]) is not None


def test_profile_dir_joins_each_request_s_run(engines, tmp_path):
    pe = engines[1]
    pe.profile_dir = str(tmp_path)
    try:
        events = list(pe.generate(PROMPT, GenerationConfig(max_new_tokens=4,
                                                           temperature=0.0)))
    finally:
        pe.profile_dir = None
    trace = TRACER.get(events[-1].data["request_id"])
    runs = list((tmp_path / "plugins" / "profile").glob("*/trace.json"))
    assert len(runs) == 1
    device = [s for s in trace.spans if s[0].startswith("device:")]
    assert device and device[0][3]["mode"] == "lanes"
    assert device[0][3]["correlation"] == "clock"
    # the server refuses an on-demand session while per-request profiling runs
    server = ChatServer(pe, GenerationConfig())
    server.engine.profile_dir = str(tmp_path)

    async def steps(c):
        r = await c.post("/debug/profile", json={"steps": 1})
        return r.status, await r.json()

    try:
        status, body = asyncio.run(_serve(server.app, steps))
    finally:
        server.engine.profile_dir = None
    assert status == 409 and "--profile-dir" in body["error"]
