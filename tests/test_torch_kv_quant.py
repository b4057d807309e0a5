"""``--kv-quant q8_0`` in the port against the JAX package, on the CPU at f32,
and the two repairs that go with it.

- ``kv_quantize`` is bit-equal to the reference as it runs under ``jit``
  (scale ``amax · f32(1/127)``) on 4096 random head vectors of width 64.
- ``Engine(kv_quant="q8_0")``: int8 codes and f32 scales in the cache; the
  single stream's greedy text equals the reference engine's, and its logits
  through a prefill and decode steps are within atol 2e-4 of the
  reference's (the tolerance of the quantized model tests); the slot
  scheduler's pools are int8 and its greedy streams equal the reference
  scheduler's. These inputs put no K/V element on an int8 rounding tie.
- The server takes ``--kv-quant q8_0`` and ``/healthz`` reports it.
- ``/chat`` takes a token-id prompt and streams the reference server's
  greedy tokens for it; a list that is not all ints gets 400.
"""

import asyncio
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models import forward as jax_forward
from distributed_llm_pipeline_tpu.models.llama import kv_quantize as jax_kv_quantize
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu_torch.models.llama import kv_quantize
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        SlotScheduler)
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.serving.server import build_argparser

from .fixtures import make_spm_vocab, spm_metadata


def test_kv_quantize_is_bit_equal_to_the_jitted_reference():
    x = np.random.default_rng(0).standard_normal((4096, 64)).astype(np.float32)
    jq, js = jax.jit(jax_kv_quantize)(jnp.asarray(x))
    q, s = kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "kvq.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32, kv_quant="q8_0"),
            Engine(gguf_path, dtype=torch.float32, device="cpu", kv_quant="q8_0"))


def _greedy(cls, n=12):
    return cls(max_new_tokens=n, temperature=0.0, stop_on_eos=False)


def test_single_stream_matches_the_reference(engines):
    ref, port = engines
    cache = port.make_cache()
    assert cache.k.dtype == torch.int8 and cache.k_scale.dtype == torch.float32
    assert any("(q8_0)" in e.content for e in port._events_on_load)

    def text(eng, gen):
        return "".join(e.content for e in eng.generate("hello world once upon", gen)
                       if e.kind == "token")

    got, want = text(port, _greedy(GenerationConfig)), text(ref, _greedy(JaxGen))
    assert got == want and got
    toks = np.random.default_rng(3).integers(0, ref.cfg.vocab_size, (1, 12))
    jcache = ref.make_cache()
    fwd = jax.jit(jax_forward, static_argnums=1)
    for _ in range(4):
        jl, jcache = fwd(ref.params, ref.cfg, jnp.asarray(toks, jnp.int32), jcache)
        tl = port.model(torch.from_numpy(toks).long(), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-4)
        assert (tl[:, -1].argmax(-1).numpy() == np.asarray(jl)[:, -1].argmax(-1)).all()
        toks = np.asarray(jl)[:, -1:].argmax(-1)


def test_slots_match_the_reference(engines):
    ref, port = engines
    kw = dict(n_slots=3, decode_chunk=4, kv_block=32, prefill_chunk=16)
    prompts = [[int(t) for t in np.random.default_rng(s).integers(5, 250, size=n)]
               for s, n in ((1, 9), (2, 40), (3, 23))]
    out = {}
    for name, eng, cls, gen in (("ref", ref, JaxSlotScheduler, JaxGen),
                                ("port", port, SlotScheduler, GenerationConfig)):
        sched = cls(eng, **kw)
        try:
            if name == "port":
                assert sched.kv_quant == "q8_0"
                assert sched._bufs["k"].dtype == torch.int8
                assert sched._bufs["ks"].shape[-1] == 1
            texts = {}
            threads = [threading.Thread(target=lambda i=i: texts.__setitem__(
                i, sched.generate_text(prompts[i], _greedy(gen, 10)))) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            out[name] = [texts[i] for i in range(3)]
        finally:
            sched.close()
    assert out["port"] == out["ref"] and all(out["port"])


def test_engine_and_slots_refuse_token_ids_outside_the_vocabulary(engines):
    port = engines[1]
    vocab = port.cfg.vocab_size
    sched = SlotScheduler(port, n_slots=2, kv_block=32)
    try:
        for ids in ([-1], [3, vocab]):
            with pytest.raises(ValueError, match="outside the vocabulary"):
                list(port.generate(ids, _greedy(GenerationConfig, 2)))
            with pytest.raises(ValueError, match="outside the vocabulary"):
                sched.submit(ids, _greedy(GenerationConfig, 2), emit=lambda ev: None)
        [end] = [e for e in sched.generate([0, vocab - 1], _greedy(GenerationConfig, 2))
                 if e.kind == "done"]
        assert end.data["n_gen"] == 2
    finally:
        sched.close()


def _run(app, coro_fn):
    async def wrapper():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await coro_fn(client)
        finally:
            await client.close()

    return asyncio.run(wrapper())


def _post(app, *bodies):
    """POST each body to /chat on one server: [(status, text)]."""
    async def go(client):
        out = []
        for body in bodies:
            resp = await client.post("/chat", json=body)
            out.append((resp.status, (await resp.read()).decode()))
        return out

    return _run(app, go)


def _tokens(text):
    return [json.loads(line[6:])["content"] for line in text.split("\n")
            if line.startswith("data: ") and json.loads(line[6:])["msg_type"] == "token"]


def test_server_takes_kv_quant_and_healthz_reports_it(engines):
    args = build_argparser().parse_args(["--model", "m.gguf", "--kv-quant", "q8_0"])
    assert args.kv_quant == "q8_0"
    assert build_argparser().parse_args(["--model", "m.gguf"]).kv_quant is None
    with pytest.raises(SystemExit):
        build_argparser().parse_args(["--model", "m.gguf", "--kv-quant", "q4_0"])

    async def health(client):
        resp = await client.get("/healthz")
        return resp.status, await resp.json()

    status, body = _run(ChatServer(engines[1]).app, health)
    assert status == 200 and body["status"] == "ok" and body["kv_quant"] == "q8_0"


def test_chat_streams_a_token_id_prompt_as_the_reference(gguf_path):
    body = {"prompt": [1, 5, 9], "max_new_tokens": 6, "temperature": 0.0,
            "stop_on_eos": False}
    port = ChatServer(Engine(gguf_path, dtype=torch.float32, device="cpu"),
                      GenerationConfig(temperature=0.0))
    ref = JaxChatServer(JaxEngine(gguf_path, dtype=jnp.float32), JaxGen(temperature=0.0))
    vocab = port.engine.cfg.vocab_size
    bad = (["a"], [1, 2.5], [], [True])
    out_of_range = ([-1], [vocab], [1, vocab + 7])
    (ps, pt), *refused = _post(port.app, body,
                               *({"prompt": b} for b in bad + out_of_range))
    [(rs, rt)] = _post(ref.app, body)
    assert ps == rs == 200
    assert _tokens(pt) == _tokens(rt) and _tokens(pt)
    for b, (status, text) in zip(bad + out_of_range, refused):
        assert status == 400, b
        assert ("token ids" if b in bad else "outside the vocabulary") \
            in json.loads(text)["error"], b
