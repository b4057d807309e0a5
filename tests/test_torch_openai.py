"""The port's llama-server / OpenAI routes against the JAX package's, on the
CPU: the same tiny f32 GGUF served greedy by the port's ChatServer and the
reference's, single-stream and on ``parallel=4`` slots. ``/v1/chat/completions``,
``/v1/completions`` and ``/completion`` give identical text and
``finish_reason``, streamed and whole, in the same JSON shape (keys, nesting
and value kinds; ``id``, ``created``, ``timings`` and the reference tracer's
``request_id`` aside); logprobs of the greedy tokens agree within 1e-4; a
logit bias that bans the greedy token gives identical text; ``/tokenize``,
``/detokenize`` and ``/apply-template`` agree; bad bodies get the reference's
400s, and fields the port does not serve yet get a 400 that names them.
"""

import asyncio
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu.serving import build_prompt as jax_build_prompt
from distributed_llm_pipeline_tpu.tokenizer import tokenizer_from_metadata as jax_tokenizer
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.runtime.scheduler import LP_TOPK
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.serving.openai import build_prompt
from distributed_llm_pipeline_tpu_torch.tokenizer import tokenizer_from_metadata

from .fixtures import make_spm_vocab, spm_metadata

LOGPROB_TOL = 1e-4     # f32 model, the two packages' logits agree to ~1e-6
N = 6                  # tokens a request
IGNORED = {"id", "created", "timings", "request_id"}
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello world"}]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # the head's columns of the specials and the 256 byte tokens at zero: the
    # greedy text is made of the vocabulary's pieces, not of lone bytes that
    # decode to U+FFFD
    params["lm_head"] = params["lm_head"].at[:, :259].set(0.0)
    path = tmp_path_factory.mktemp("models") / "api.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


def _greedy_ids(engine, prompt: str) -> list[int]:
    gen = GenerationConfig(temperature=0.0, max_new_tokens=N, logprobs=1)
    return [e.data["id"] for e in engine.generate(prompt, gen)
            if e.kind == "token" and e.data]


def _sse(text: str) -> list:
    out = []
    for line in text.split("\n"):
        if line.startswith("data: "):
            data = line[6:]
            out.append(data if data == "[DONE]" else json.loads(data))
    return out


def _shape(x):
    """Keys, nesting and value kinds of a JSON value."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items() if k not in IGNORED}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return type(x).__name__
    return "number"


def _requests(ban_id: int, stop: str) -> dict:
    """name → (route, body) of the requests every server answers."""
    greedy = {"temperature": 0.0}
    chat = {"messages": MESSAGES, "max_tokens": N, **greedy}
    cmpl = {"prompt": "hello world", "max_tokens": N, **greedy}
    llama = {"prompt": "hello world", "n_predict": N, **greedy}
    reqs = {}
    for stream in (False, True):
        tag = "_stream" if stream else ""
        reqs["chat" + tag] = ("/v1/chat/completions", {**chat, "stream": stream})
        reqs["cmpl" + tag] = ("/v1/completions", {**cmpl, "stream": stream})
        reqs["llama" + tag] = ("/completion", {**llama, "stream": stream})
        reqs["chat_lp" + tag] = ("/v1/chat/completions", {
            **chat, "logprobs": True, "top_logprobs": 3, "stream": stream})
        reqs["cmpl_lp" + tag] = ("/v1/completions", {**cmpl, "logprobs": 2,
                                                     "stream": stream})
        reqs["llama_lp" + tag] = ("/completion", {**llama, "n_probs": 4,
                                                  "stream": stream})
    reqs["cmpl_ban"] = ("/v1/completions", {**cmpl, "logit_bias": {str(ban_id): -100.0}})
    reqs["llama_ban"] = ("/completion", {**llama, "logit_bias": [[ban_id, False]],
                                         "n_probs": 2})
    reqs["cmpl_stop_lp"] = ("/v1/completions", {**cmpl, "logprobs": 1, "stop": stop})
    reqs["tokenize"] = ("/tokenize", {"content": "hello world once"})
    reqs["apply_template"] = ("/apply-template", {"messages": MESSAGES})
    return reqs


async def _answer(client, route: str, body: dict | None):
    resp = await (client.get(route) if body is None else client.post(route, json=body))
    if body is not None and body.get("stream"):
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        return resp.status, _sse((await resp.read()).decode())
    return resp.status, await resp.json()


def _serve(app, reqs: dict, together: tuple[str, ...] = ()) -> dict:
    """Answer every request (``together`` concurrently, first; the rest one
    after another) and /detokenize the /tokenize answer's ids."""
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = dict(zip(together, await asyncio.gather(
                *(_answer(client, *reqs[k]) for k in together))))
            for name, (route, body) in reqs.items():
                if name not in together:
                    out[name] = await _answer(client, route, body)
            out["detokenize"] = await _answer(client, "/detokenize",
                                              {"tokens": out["tokenize"][1]["tokens"]})
            for route in ("/v1/models", "/props", "/health", "/slots"):
                out[route] = await _answer(client, route, None)
            return out
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def answers(engines):
    """Each server's answers: the port's and the reference's, one stream and
    four slots (two logprob requests beside a biased one, together)."""
    jeng, peng = engines
    ids = _greedy_ids(peng, "hello world")
    text = peng.tokenizer.decode(ids)
    # a stop string inside the greedy text, past its first character
    stop = text[len(text) // 2:len(text) // 2 + 2]
    assert len(ids) == N and len(stop) == 2 and text.find(stop) > 0
    reqs = _requests(ids[0], stop)
    out = {}
    for slots in (1, 4):
        together = ("cmpl_lp", "llama_lp", "llama_ban") if slots > 1 else ()
        port = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=slots)
        ref = JaxChatServer(jeng, JaxGen(temperature=0.0), parallel=slots)
        out[slots] = (_serve(ref.app, reqs, together), _serve(port.app, reqs, together))
    return out


COMPLETIONS = ["chat", "cmpl", "llama", "chat_lp", "cmpl_lp", "llama_lp", "cmpl_ban",
               "llama_ban", "cmpl_stop_lp"]


def _text_and_finish(name: str, status_body) -> tuple[str, object]:
    status, body = status_body
    assert status == 200, body
    if isinstance(body, list):        # a stream: concatenate its chunks
        chunks = [c for c in body if c != "[DONE]"]
        if name.startswith("llama"):
            return ("".join(c["content"] for c in chunks),
                    (chunks[-1]["stopped_eos"], chunks[-1]["stopped_limit"]))
        key = "delta" if name.startswith("chat") else None
        text = "".join((c["choices"][0][key].get("content", "") if key
                        else c["choices"][0]["text"]) for c in chunks)
        return text, chunks[-1]["choices"][0]["finish_reason"]
    if name.startswith("llama"):
        return body["content"], (body["stopped_eos"], body["stopped_limit"])
    choice = body["choices"][0]
    text = choice["message"]["content"] if name.startswith("chat") else choice["text"]
    return text, choice["finish_reason"]


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("name", COMPLETIONS + [c + "_stream" for c in COMPLETIONS[:6]])
def test_routes_give_the_reference_text_and_shape(answers, slots, name):
    ref, port = answers[slots]
    assert _text_and_finish(name, port[name]) == _text_and_finish(name, ref[name])
    assert _shape(port[name][1]) == _shape(ref[name][1])


@pytest.mark.parametrize("slots", [1, 4])
def test_banned_greedy_token_changes_the_text(answers, slots):
    _, port = answers[slots]
    assert port["cmpl_ban"][1]["choices"][0]["text"] != port["cmpl"][1]["choices"][0]["text"]
    assert port["llama_ban"][1]["content"] == port["cmpl_ban"][1]["choices"][0]["text"]


def _logprobs(name: str, body) -> tuple[list, list, list]:
    """(token strings, their logprobs, each token's alternatives as (string,
    logprob) pairs) of a whole or streamed answer."""
    if isinstance(body, list):
        chunks = [c for c in body if c != "[DONE]"]
        parts = [_logprobs(name, c) for c in chunks
                 if (c.get("completion_probabilities") if name.startswith("llama")
                     else c["choices"][0]["logprobs"])]
        return tuple(sum((p[i] for p in parts), []) for i in range(3))
    if name.startswith("llama"):
        probs = body["completion_probabilities"]
        return ([p["content"] for p in probs], [None] * len(probs),
                [[(a["tok_str"], math.log(a["prob"])) for a in p["probs"]]
                 for p in probs])
    lp = body["choices"][0]["logprobs"]
    if name.startswith("chat"):
        c = lp["content"]
        return ([e["token"] for e in c], [e["logprob"] for e in c],
                [[(a["token"], a["logprob"]) for a in e["top_logprobs"]] for e in c])
    return (lp["tokens"], lp["token_logprobs"],
            [list(d.items()) for d in lp["top_logprobs"]])


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("name", ["chat_lp", "cmpl_lp", "llama_lp", "chat_lp_stream",
                                  "cmpl_lp_stream", "llama_lp_stream", "llama_ban",
                                  "cmpl_stop_lp"])
def test_logprobs_match_the_reference(answers, slots, name):
    ref, port = answers[slots]
    r_tok, r_lp, r_top = _logprobs(name, ref[name][1])
    p_tok, p_lp, p_top = _logprobs(name, port[name][1])
    assert p_tok == r_tok and len(p_tok) > 0
    assert [[s for s, _ in t] for t in p_top] == [[s for s, _ in t] for t in r_top]
    got = [v for v in p_lp if v is not None] + [v for t in p_top for _, v in t]
    want = [v for v in r_lp if v is not None] + [v for t in r_top for _, v in t]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGPROB_TOL)
    for vals, top in zip(p_lp, p_top):
        lps = [v for _, v in top]
        assert lps == sorted(lps, reverse=True) and all(v <= 0 for v in lps)
        if vals is not None and top:   # greedy: the token is the top-1
            assert abs(vals - lps[0]) <= LOGPROB_TOL


def test_stop_string_trims_the_logprob_entries(answers):
    _, port = answers[1]
    choice = port["cmpl_stop_lp"][1]["choices"][0]
    assert choice["finish_reason"] == "stop" and choice["text"]
    lp = choice["logprobs"]
    assert all(o < len(choice["text"]) for o in lp["text_offset"])
    assert lp["text_offset"] == sorted(lp["text_offset"])


@pytest.mark.parametrize("slots", [1, 4])
def test_utility_routes_match_the_reference(answers, engines, slots):
    ref, port = answers[slots]
    for name in ("tokenize", "detokenize", "apply_template"):
        assert port[name] == ref[name]
    assert port["tokenize"][1]["tokens"] == engines[1].tokenizer.encode("hello world once")
    assert port["detokenize"][1]["content"].endswith(" hello world once")
    for route in ("/v1/models", "/props", "/health", "/slots"):
        assert port[route][0] == ref[route][0] == 200
        assert _shape(port[route][1]) == _shape(ref[route][1])
    assert port["/props"][1]["total_slots"] == slots
    assert port["/props"][1]["model"] == ref["/props"][1]["model"]
    assert port["/v1/models"][1]["data"][0]["id"] == "default"
    assert len(port["/slots"][1]) == slots


# name → (route, body): the reference's 400s, which the port's must equal
BAD = {
    "completion_no_prompt": ("/completion", {"nope": 1}),
    "completion_int_prompt": ("/completion", {"prompt": 5}),
    "cmpl_not_json": ("/v1/completions", b"not json"),
    "chat_messages_str": ("/v1/chat/completions", {"messages": "hi"}),
    "chat_bad_message": ("/v1/chat/completions", {"messages": [{"content": "x"}]}),
    "temperature_str": ("/v1/completions", {"prompt": "x", "temperature": "hot"}),
    "stop_int": ("/v1/completions", {"prompt": "x", "stop": 3}),
    "bias_key": ("/v1/completions", {"prompt": "x", "logit_bias": {"not_an_id": 1.0}}),
    "bias_true": ("/v1/completions", {"prompt": "x", "logit_bias": {"5": True}}),
    "n_probs_big": ("/completion", {"prompt": "x", "n_probs": LP_TOPK + 1}),
    "top_logprobs_big": ("/v1/chat/completions", {
        "messages": MESSAGES, "logprobs": True, "top_logprobs": LP_TOPK + 1}),
    "logprobs_str": ("/v1/completions", {"prompt": "x", "logprobs": "yes"}),
    "mirostat_logprobs": ("/completion", {"prompt": "x", "n_probs": 2, "mirostat": 2,
                                          "temperature": 0.5}),
    "n_zero": ("/v1/completions", {"prompt": "x", "n": 0}),
    "model_int": ("/v1/completions", {"prompt": "x", "model": 3}),
    "model_unknown": ("/v1/chat/completions", {"messages": MESSAGES, "model": "other"}),
    "response_format_bad": ("/v1/chat/completions", {"messages": MESSAGES,
                                                     "response_format": "json"}),
    "tokenize_int": ("/tokenize", {"content": 5}),
    "detokenize_str": ("/detokenize", {"tokens": ["x"]}),
    "detokenize_range": ("/detokenize", {"tokens": [10_000]}),
    "apply_template_str": ("/apply-template", {"messages": "x"}),
}


async def _post_raw(client, route, body):
    if isinstance(body, bytes):
        resp = await client.post(route, data=body,
                                 headers={"Content-Type": "application/json"})
    else:
        resp = await client.post(route, json=body)
    return resp.status, await resp.json()


def _post_all(app, bodies: dict) -> dict:
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return {k: await _post_raw(client, *v) for k, v in bodies.items()}
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def bad_answers(engines):
    jeng, peng = engines
    return (_post_all(JaxChatServer(jeng, JaxGen(temperature=0.0)).app, BAD),
            _post_all(ChatServer(peng, GenerationConfig(temperature=0.0)).app, BAD))


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_bodies_get_the_reference_errors(bad_answers, name):
    ref, port = bad_answers
    assert port[name][0] == ref[name][0] and port[name][0] in (400, 404)
    assert port[name][1] == ref[name][1]


# a field or route the port does not serve yet, and the word its 400 names
UNSERVED = {
    "grammar": ("/completion", {"prompt": "x", "grammar": 'root ::= "a"'}, "grammar"),
    "json_schema": ("/completion", {"prompt": "x", "json_schema": {"type": "object"}},
                    "json_schema"),
    "response_format": ("/v1/chat/completions", {
        "messages": MESSAGES, "response_format": {"type": "json_object"}},
        "response_format"),
    "lora": ("/completion", {"prompt": "x", "lora": [{"id": 0, "scale": 1.0}]}, "lora"),
    "context_shift": ("/v1/completions", {"prompt": "x", "context_shift": True},
                      "context_shift"),
    "n_keep": ("/completion", {"prompt": "x", "n_keep": 4}, "n_keep"),
    "priority": ("/v1/completions", {"prompt": "x", "priority": "high"}, "priority"),
    "deadline_ms": ("/completion", {"prompt": "x", "deadline_ms": 500}, "deadline_ms"),
    "n": ("/v1/chat/completions", {"messages": MESSAGES, "n": 2}, "'n'"),
    "prompt_list": ("/v1/completions", {"prompt": ["a", "b"]}, "list"),
    "infill": ("/infill", {"input_prefix": "a", "input_suffix": "b"}, "/infill"),
    "embedding": ("/embedding", {"content": "x"}, "/embedding"),
    "v1_embeddings": ("/v1/embeddings", {"input": "x"}, "/v1/embeddings"),
    "slot_save": ("/slots/0?action=save", {"filename": "a.bin"}, "/slots/{slot_id}"),
}


@pytest.fixture(scope="module")
def unserved_answers(engines):
    app = ChatServer(engines[1], GenerationConfig(temperature=0.0)).app
    out = _post_all(app, {k: v[:2] for k, v in UNSERVED.items()})

    async def lora_adapters():
        client = TestClient(TestServer(ChatServer(engines[1]).app))
        await client.start_server()
        try:
            resp = await client.get("/lora-adapters")
            return resp.status, await resp.json()
        finally:
            await client.close()

    out["lora_adapters"] = asyncio.run(lora_adapters())
    return out


@pytest.mark.parametrize("name", sorted(UNSERVED) + ["lora_adapters"])
def test_unserved_fields_and_routes_are_400(unserved_answers, name):
    status, body = unserved_answers[name]
    word = UNSERVED[name][2] if name in UNSERVED else "/lora-adapters"
    err = body["error"]
    msg = err["message"] if isinstance(err, dict) else err
    assert status == 400 and word in msg and "not yet served" in msg, body


def test_neutral_values_of_unserved_fields_are_accepted(engines):
    """A client that sends the fields at the values that ask for nothing
    (as SDKs send nulls and defaults) is served."""
    body = {"prompt": "x", "max_tokens": 2, "grammar": None, "context_shift": False,
            "n_keep": 0, "priority": "normal", "deadline_ms": None, "n": 1,
            "response_format": {"type": "text"}, "lora": []}
    got = _post_all(ChatServer(engines[1], GenerationConfig(temperature=0.0)).app,
                    {"ok": ("/v1/completions", body)})["ok"]
    assert got[0] == 200 and got[1]["usage"]["completion_tokens"] == 2


def test_sampled_typical_and_mirostat_run_single_stream(engines):
    """On slots, typical-p and mirostat requests go to the engine (the row
    sampler has neither); each answers in the reference's shape, the
    mirostat one with a finite μ in its done event."""
    bodies = {"typical": ("/completion", {"prompt": "hello", "n_predict": 4,
                                          "temperature": 0.9, "typical_p": 0.9,
                                          "seed": 3}),
              "mirostat": ("/v1/completions", {"prompt": "hello", "max_tokens": 4,
                                               "temperature": 0.9, "mirostat": 2,
                                               "seed": 3})}
    jeng, peng = engines
    server = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=4)
    api = server.api
    for name, (_, body) in bodies.items():
        gen = api._gen_config(body, n_key="max_tokens" if name == "mirostat"
                              else "n_predict")
        assert api._target(peng, gen) == (peng, True)
    got = _post_all(server.app, bodies)
    want = _post_all(JaxChatServer(jeng, JaxGen(temperature=0.0)).app, bodies)
    for name in bodies:
        assert got[name][0] == want[name][0] == 200
        assert _shape(got[name][1]) == _shape(want[name][1])
    done = list(peng.generate("hello", GenerationConfig(
        temperature=0.9, mirostat=2, max_new_tokens=4, seed=3)))[-1]
    assert done.data["n_gen"] == 4 and math.isfinite(done.data["mirostat_mu"])


CHATML = ("{% for message in messages %}<|im_start|>{{ message['role'] }}\n"
          "{{ message['content'] }}<|im_end|>\n{% endfor %}"
          "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
TEMPLATES = {
    "plain": (None, ()),
    "chatml": (CHATML, ()),
    "bos_in_template": ("{{ bos_token }}{% for m in messages %}[{{ m['role'] }}] "
                        "{{ m['content'] }}{{ eos_token }}{% endfor %}", ()),
    "broken_template": ("{% for %}", ()),
    "raising_template": ("{{ raise_exception('no system role') }}", ()),
    "llama3": (None, ("<|begin_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
                      "<|eot_id|>")),
}


class _Stub:
    """An engine with only a tokenizer: what /apply-template reads."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_apply_template_matches_the_reference(name):
    from distributed_llm_pipeline_tpu.serving.openai import CompletionAPI as JaxAPI
    from distributed_llm_pipeline_tpu_torch.serving.openai import CompletionAPI

    template, pieces = TEMPLATES[name]
    md = spm_metadata(make_spm_vocab([(p, 0.0) for p in pieces]))
    if template is not None:
        md["tokenizer.chat_template"] = template
    ptok, jtok = tokenizer_from_metadata(md), jax_tokenizer(md)
    messages = MESSAGES + [{"role": "assistant", "content": [
        {"type": "text", "text": "hi"}, {"type": "text", "text": " there"}]},
        {"role": "user", "content": "again"}]
    assert build_prompt(messages, ptok) == jax_build_prompt(messages, jtok)

    class Registry:
        def get(self, mid=None):
            return _Stub(jtok)

    def app_of(api):
        app = web.Application()
        api.register(app)
        return app

    body = {"messages": messages}
    got = _post_all(app_of(CompletionAPI(_Stub(ptok), asyncio.Lock(), GenerationConfig())),
                    {"t": ("/apply-template", body)})["t"]
    want = _post_all(app_of(JaxAPI(Registry(), asyncio.Lock(), JaxGen())),
                     {"t": ("/apply-template", body)})["t"]
    assert got == want and got[0] == 200
