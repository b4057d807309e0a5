"""The port's /chat SSE server on the CPU against the reference's contract:
``POST /chat`` streams ``data: {"msg_type": "log"|"token", ...}`` events
closed by the done summary, in the same shape the JAX package's server
sends; bad bodies get 400; ``/healthz``, CORS preflight and the UI answer.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.serving.server import build_argparser

from .fixtures import make_spm_vocab, spm_metadata


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "srv.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engine(gguf_path):
    return Engine(gguf_path, dtype=torch.float32, device="cpu")


def _run(app, coro_fn):
    async def wrapper():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await coro_fn(client)
        finally:
            await client.close()

    return asyncio.run(wrapper())


def _chat(app, body):
    async def go(client):
        resp = await client.post("/chat", json=body)
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        assert resp.headers["Access-Control-Allow-Origin"] == "*"
        return (await resp.read()).decode()

    text = _run(app, go)
    return [json.loads(line[6:]) for line in text.split("\n")
            if line.startswith("data: ")]


def test_chat_streams_the_reference_sse_shape(gguf_path, engine):
    body = {"prompt": "hello world", "max_new_tokens": 6}
    port = _chat(ChatServer(engine, GenerationConfig(temperature=0.0)).app, body)
    ref = _chat(JaxChatServer(JaxEngine(gguf_path, dtype=jnp.float32),
                              JaxGen(temperature=0.0)).app, body)
    for events in (port, ref):
        assert {e["msg_type"] for e in events} == {"log", "token"}
        assert any("offloaded" in e["content"] for e in events
                   if e["msg_type"] == "log")
    # the done summary closes both streams with the same keys (the
    # reference's tracer adds its request id)
    assert set(port[-1]) == set(ref[-1]) - {"request_id"}
    assert port[-1]["n_gen"] == ref[-1]["n_gen"] == 6
    assert port[-1]["finish_reason"] == ref[-1]["finish_reason"] == "length"
    # greedy f32: the same text, token event by token event
    assert [e["content"] for e in port if e["msg_type"] == "token"] == \
        [e["content"] for e in ref if e["msg_type"] == "token"]
    for e in port[:-1]:
        assert set(e) == {"msg_type", "content"}


def test_request_overrides_and_stop(engine):
    app = ChatServer(engine, GenerationConfig(temperature=0.0)).app
    full = _chat(app, {"prompt": "hello", "max_new_tokens": 8})
    text = "".join(e["content"] for e in full if e["msg_type"] == "token")
    short = _chat(ChatServer(engine, GenerationConfig(temperature=0.0)).app,
                  {"prompt": "hello", "max_new_tokens": 2})
    assert short[-1]["n_gen"] == 2
    stop = text[3:5]
    stopped = _chat(ChatServer(engine, GenerationConfig(temperature=0.0)).app,
                    {"prompt": "hello", "max_new_tokens": 8, "stop": stop})
    assert stopped[-1]["finish_reason"] == "stop"
    assert stop not in "".join(e["content"] for e in stopped
                               if e["msg_type"] == "token")


def test_bad_bodies_are_400(engine):
    app = ChatServer(engine).app

    async def go(client):
        statuses = []
        for kw in ({"data": b"not json",
                    "headers": {"Content-Type": "application/json"}},
                   {"json": {"nope": 1}}, {"json": ["prompt"]},
                   {"json": {"prompt": 5}},
                   {"json": {"prompt": "hi", "stop": [1]}},
                   {"json": {"prompt": "hi", "stop": 3}}):
            statuses.append((await client.post("/chat", **kw)).status)
        return statuses

    assert _run(app, go) == [400] * 6


def test_healthz_preflight_and_ui(engine):
    app = ChatServer(engine).app

    async def go(client):
        h = await client.get("/healthz")
        pre = await client.options("/chat")
        ui = await client.get("/")
        return (h.status, await h.json(), pre.status,
                pre.headers["Access-Control-Allow-Origin"], ui.status,
                await ui.text())

    hs, health, ps, origin, us, page = _run(app, go)
    assert hs == 200 and health["status"] == "ok" and health["n_layers"] == 2
    assert health["device"] == "cpu" and health["busy"] is False
    assert ps == 200 and origin == "*"
    assert us == 200 and "msg_type" in page


def test_engine_failure_becomes_a_done_event(engine, monkeypatch):
    def broken(prompt, gen):
        raise RuntimeError("boom")
        yield

    app = ChatServer(engine).app
    monkeypatch.setattr(engine, "generate", broken)
    events = _chat(app, {"prompt": "hi"})
    assert events[-1]["finish_reason"] == "error" and "boom" in events[-1]["error"]


def test_cli_defaults():
    args = build_argparser().parse_args(["--model", "m.gguf"])
    assert (args.port, args.ctx_size, args.n_predict, args.cpu) == (3005, 2048, 200, False)
    assert build_argparser().parse_args(["--model", "m.gguf", "--cpu"]).cpu


def test_parallel_slots_serve_concurrent_streams(engine):
    """--parallel 2: two concurrent /chat streams decode in one batched
    step, both complete, and each greedy text is the single-stream
    server's; /healthz reports the slots."""
    bodies = [{"prompt": "hello world", "max_new_tokens": 6},
              {"prompt": "once upon a time", "max_new_tokens": 9}]
    single = [_chat(ChatServer(engine, GenerationConfig(temperature=0.0)).app, b)
              for b in bodies]
    server = ChatServer(engine, GenerationConfig(temperature=0.0), parallel=2)

    async def go(client):
        health = await (await client.get("/healthz")).json()

        async def one(body):
            resp = await client.post("/chat", json=body)
            assert resp.status == 200
            text = (await resp.read()).decode()
            return [json.loads(line[6:]) for line in text.split("\n")
                    if line.startswith("data: ")]

        return health, await asyncio.gather(*(one(b) for b in bodies))

    health, streams = _run(server.app, go)
    assert health["slots_total"] == 2 and health["queue_depth"] == 0
    for events, ref, body in zip(streams, single, bodies):
        assert events[-1]["finish_reason"] == "length"
        assert events[-1]["n_gen"] == body["max_new_tokens"]
        assert [e["content"] for e in events if e["msg_type"] == "token"] == \
            [e["content"] for e in ref if e["msg_type"] == "token"]
    assert server.scheduler._closed.is_set()   # closed with the app


def test_cli_parallel_flag():
    assert build_argparser().parse_args(["--model", "m.gguf"]).parallel == 1
    assert build_argparser().parse_args(["--model", "m.gguf", "-np", "4"]).parallel == 4
