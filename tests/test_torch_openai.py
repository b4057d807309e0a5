"""The port's llama-server / OpenAI routes against the JAX package's, on the
CPU: the same tiny f32 GGUF served greedy by the port's ChatServer and the
reference's, single-stream and on ``parallel=4`` slots. ``/v1/chat/completions``,
``/v1/completions`` and ``/completion`` give identical text and
``finish_reason``, streamed and whole, in the same JSON shape (keys, nesting
and value kinds; ``id``, ``created``, ``timings`` and the reference tracer's
``request_id`` aside); logprobs of the greedy tokens agree within 1e-4; a
logit bias that bans the greedy token gives identical text; ``/tokenize``,
``/detokenize`` and ``/apply-template`` agree; constrained requests
(``response_format`` ``json_object`` / ``json_schema``, ``grammar``,
``json_schema``) give the reference's text on one stream and on the slots,
and meet their constraint; ``context_shift`` requests run past the context
with the reference's text; bad bodies and refused combinations get the
reference's 400s; a request's ``lora`` field (which the reference does not
read: adapters merge at load) and ``GET /lora-adapters`` get the
reference's answers. Batches (``n`` > 1, a list of prompts), ``/embedding`` and
``/v1/embeddings`` (vectors within 1e-5), ``POST /slots/{id}`` (save, erase,
restore) and ``/infill`` give the reference's answers, refusals included.
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
from distributed_llm_pipeline_tpu.ops.json_constraint import prefix_ok
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
GRAMMAR = 'root ::= "hello" | "world" | "time"'
SCHEMA = {"type": "object", "properties": {"n": {"type": "integer"}}, "required": ["n"]}


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
    # constrained: a longer budget, so that a JSON value can close
    cons = {"max_tokens": 3 * N, **greedy}
    reqs["cmpl_json"] = ("/v1/completions", {
        "prompt": "produce json:", **cons, "response_format": {"type": "json_object"}})
    reqs["cmpl_json_stream"] = ("/v1/completions", {
        **reqs["cmpl_json"][1], "stream": True})
    reqs["llama_grammar"] = ("/completion", {
        "prompt": "pick:", "n_predict": 3 * N, **greedy, "grammar": GRAMMAR})
    reqs["llama_schema"] = ("/completion", {
        "prompt": "produce:", "n_predict": 8 * N, **greedy, "json_schema": SCHEMA})
    reqs["chat_schema"] = ("/v1/chat/completions", {
        "messages": MESSAGES, "max_tokens": 8 * N, **greedy,
        "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}})
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
        together = (("cmpl_lp", "llama_lp", "llama_ban", "llama_schema")
                    if slots > 1 else ())
        port = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=slots)
        ref = JaxChatServer(jeng, JaxGen(temperature=0.0), parallel=slots)
        out[slots] = (_serve(ref.app, reqs, together), _serve(port.app, reqs, together))
    return out


COMPLETIONS = ["chat", "cmpl", "llama", "chat_lp", "cmpl_lp", "llama_lp", "cmpl_ban",
               "llama_ban", "cmpl_stop_lp"]
CONSTRAINED = ["cmpl_json", "cmpl_json_stream", "llama_grammar", "llama_schema",
               "chat_schema"]


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
@pytest.mark.parametrize("name", COMPLETIONS + [c + "_stream" for c in COMPLETIONS[:6]]
                         + CONSTRAINED)
def test_routes_give_the_reference_text_and_shape(answers, slots, name):
    ref, port = answers[slots]
    assert _text_and_finish(name, port[name]) == _text_and_finish(name, ref[name])
    assert _shape(port[name][1]) == _shape(ref[name][1])


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("name", CONSTRAINED)
def test_constrained_answers_meet_their_constraint(answers, slots, name):
    text, finish = _text_and_finish(name, answers[slots][1][name])
    done = finish in ("stop", (True, False))
    if name.endswith("grammar"):
        assert done and text in ("hello", "world", "time")
    elif done:
        doc = json.loads(text)
        assert "schema" not in name or isinstance(doc["n"], int)
    else:   # the budget cut it: still a prefix of a JSON value
        assert prefix_ok(text)


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
    # constraints and the context shift: the refused values and combinations
    "rf_yaml": ("/v1/completions", {"prompt": "x", "response_format": {"type": "yaml"}}),
    "rf_schema_missing": ("/v1/chat/completions", {
        "messages": MESSAGES, "response_format": {"type": "json_schema",
                                                  "json_schema": {"name": "x"}}}),
    "json_and_grammar": ("/completion", {"prompt": "x", "grammar": GRAMMAR,
                                         "response_format": {"type": "json_object"}}),
    "schema_and_grammar": ("/completion", {"prompt": "x", "grammar": GRAMMAR,
                                           "json_schema": SCHEMA}),
    "schema_not_object": ("/completion", {"prompt": "x", "json_schema": 5}),
    "schema_unsupported": ("/completion", {"prompt": "x", "json_schema": {
        "type": "array", "maxItems": 1000}}),
    "grammar_broken": ("/v1/completions", {"prompt": "x", "grammar": "root = broken"}),
    "grammar_int": ("/completion", {"prompt": "x", "grammar": 5}),
    "json_penalty": ("/v1/completions", {"prompt": "x", "repeat_penalty": 1.3,
                                         "response_format": {"type": "json_object"}}),
    "grammar_presence": ("/completion", {"prompt": "x", "grammar": GRAMMAR,
                                         "presence_penalty": 0.5}),
    "json_bias": ("/v1/completions", {"prompt": "x", "logit_bias": {"5": 1.0},
                                      "response_format": {"type": "json_object"}}),
    "grammar_logprobs": ("/completion", {"prompt": "x", "grammar": GRAMMAR,
                                         "n_probs": 2}),
    "schema_logprobs": ("/v1/chat/completions", {
        "messages": MESSAGES, "logprobs": True, "response_format": {
            "type": "json_schema", "json_schema": {"schema": SCHEMA}}}),
    "context_shift_str": ("/v1/completions", {"prompt": "x", "context_shift": "yes"}),
    "context_shift_null": ("/completion", {"prompt": "x", "context_shift": None}),
    "n_keep_negative": ("/completion", {"prompt": "x", "n_keep": -1}),
    "n_keep_float": ("/v1/completions", {"prompt": "x", "n_keep": 1.5}),
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


# fields and routes the port once refused with a 400, each now answered as
# the reference answers it: a bad priority or deadline_ms gets the
# reference's 400, which names the field (UNSERVED: the route, the body and
# the word); a request's lora field is not read, as in the reference, which
# merges adapters at load (LORA); GET /lora-adapters lists the merged ones
UNSERVED = {
    "priority": ("/v1/completions", {"prompt": "x", "priority": "high"}, "priority"),
    "deadline_ms": ("/completion", {"prompt": "x", "deadline_ms": -5}, "deadline_ms"),
}
LORA = {"lora": ("/completion", {"prompt": "x", "n_predict": N, "temperature": 0.0,
                                 "lora": [{"id": 0, "scale": 1.0}]})}


@pytest.fixture(scope="module")
def unserved_answers(engines):
    bodies = {k: v[:2] for k, v in {**UNSERVED, **LORA}.items()}
    out = _post_all(ChatServer(engines[1], GenerationConfig(temperature=0.0)).app, bodies)
    ref = _post_all(JaxChatServer(engines[0], JaxGen(temperature=0.0)).app, bodies)
    out.update({f"ref_{k}": v for k, v in ref.items()})

    async def lora_adapters(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.get("/lora-adapters")
            return resp.status, await resp.json()
        finally:
            await client.close()

    out["lora_adapters"] = asyncio.run(lora_adapters(ChatServer(engines[1]).app))
    out["ref_lora_adapters"] = asyncio.run(lora_adapters(JaxChatServer(engines[0]).app))
    return out


@pytest.mark.parametrize("name", sorted({**UNSERVED, **LORA}) + ["lora_adapters"])
def test_unserved_fields_and_routes_are_400(unserved_answers, name):
    """Each field or route the port once refused gets the reference's
    answer: the 400s name their field; the lora request is served."""
    status, body = unserved_answers[name]
    ref = tuple(unserved_answers[f"ref_{name}"])
    if name in UNSERVED:
        err = body["error"]
        msg = err["message"] if isinstance(err, dict) else err
        assert status == 400 and UNSERVED[name][2] in msg, body
        assert (status, body) == ref, body
    elif name in LORA:
        assert status == ref[0] == 200 and body["content"] == ref[1]["content"], body
        assert body["tokens_predicted"] == ref[1]["tokens_predicted"] == N
    else:
        assert (status, body) == ref == (200, [])


def test_neutral_values_of_unserved_fields_are_accepted(engines):
    """A client that sends the fields at the values that ask for nothing
    (as SDKs send nulls and defaults) is served."""
    body = {"prompt": "x", "max_tokens": 2, "grammar": None, "context_shift": False,
            "n_keep": 0, "priority": "normal", "deadline_ms": None, "n": 1,
            "response_format": {"type": "text"}, "lora": [], "json_schema": None}
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
        """What /apply-template reads of a model registry."""

        def __init__(self, tok):
            self.tok = tok

        def get(self, mid=None):
            return _Stub(self.tok)

    def app_of(api):
        app = web.Application()
        api.register(app)
        return app

    body = {"messages": messages}
    got = _post_all(app_of(CompletionAPI(Registry(ptok), asyncio.Lock(), GenerationConfig())),
                    {"t": ("/apply-template", body)})["t"]
    want = _post_all(app_of(JaxAPI(Registry(jtok), asyncio.Lock(), JaxGen())),
                     {"t": ("/apply-template", body)})["t"]
    assert got == want and got[0] == 200


# name → (route, body) of the context-shift requests: past the 64-token ctx
SHIFTED = {
    "cmpl": ("/v1/completions", {"prompt": "hello world", "max_tokens": 100,
                                 "temperature": 0.0, "context_shift": True,
                                 "n_keep": 2}),
    "llama_stream": ("/completion", {"prompt": "hello world once upon a time",
                                     "n_predict": 90, "temperature": 0.0,
                                     "context_shift": True, "stream": True}),
    "chat": ("/v1/chat/completions", {"messages": MESSAGES, "max_tokens": 80,
                                      "temperature": 0.0, "context_shift": True,
                                      "n_keep": 4}),
}


@pytest.fixture(scope="module")
def shifted_answers(engines):
    """The context-shift requests, on servers with 4 slots: they run on the
    engine, as the reference routes them."""
    jeng, peng = engines
    port = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=4)
    ref = JaxChatServer(jeng, JaxGen(temperature=0.0), parallel=4)
    for name, (route, body) in SHIFTED.items():
        gen = port.api._gen_config(body, n_key="n_predict" if route == "/completion"
                                   else "max_tokens")
        assert gen.context_shift and port.api._target(peng, gen) == (peng, True)

    def serve(app):
        async def go():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                return {k: await _answer(client, *v) for k, v in SHIFTED.items()}
            finally:
                await client.close()

        return asyncio.run(go())

    return serve(ref.app), serve(port.app)


@pytest.mark.parametrize("name", sorted(SHIFTED))
def test_context_shift_runs_past_ctx_with_the_reference_text(shifted_answers, name):
    ref, port = shifted_answers
    assert _text_and_finish(name, port[name]) == _text_and_finish(name, ref[name])
    assert _shape(port[name][1]) == _shape(ref[name][1])
    body = port[name][1]
    n = (body[-1]["tokens_predicted"] if isinstance(body, list)
         else body["usage"]["completion_tokens"])
    assert n == SHIFTED[name][1].get("max_tokens", SHIFTED[name][1].get("n_predict")) > 64


# the batch, embedding, fill-in-middle and slot-file routes, in the order
# each server answers them: name → (route, body). The slot is saved before
# the batches, which drop the engine's prefix cache. The fixture's
# vocabulary has no FIM tokens, so /infill answers the reference's 400 for it
ENTRY = {
    "cmpl": ("/v1/completions", {"prompt": "hello world once upon a time the world",
                                 "max_tokens": N, "temperature": 0.0}),
    "slot_save": ("/slots/0?action=save", {"filename": "s.bin"}),
    "cmpl_n": ("/v1/completions", {"prompt": "hello world", "n": 3, "max_tokens": N,
                                   "temperature": 0.0}),
    "cmpl_list": ("/v1/completions", {"prompt": ["hello world", "once upon a time the",
                                                 "a"], "max_tokens": N, "temperature": 0.0}),
    "chat_n": ("/v1/chat/completions", {"messages": MESSAGES, "n": 2, "max_tokens": N,
                                        "temperature": 0.0}),
    "cmpl_list_stop": ("/v1/completions", {"prompt": ["hello world", "once upon"],
                                           "max_tokens": N, "temperature": 0.0,
                                           "stop": "o"}),
    "embedding": ("/embedding", {"content": "hello world once"}),
    "embedding_cls": ("/embedding", {"content": "hello world once", "pooling": "cls"}),
    "embedding_last": ("/embedding", {"content": "hello world once", "pooling": "last"}),
    "v1_embeddings": ("/v1/embeddings", {"input": ["hello world", "once upon a time"]}),
    "v1_embeddings_str": ("/v1/embeddings", {"input": "hello"}),
    "slot_erase": ("/slots/0?action=erase", {}),
    "slot_save_empty": ("/slots/0?action=save", {"filename": "t.bin"}),
    "slot_restore": ("/slots/0?action=restore", {"filename": "s.bin"}),
    "after_restore": ("/v1/completions", {
        "prompt": "hello world once upon a time the world once", "max_tokens": N,
        "temperature": 0.0}),
    # the reference's 400s (and one 404)
    "chat_n_stream": ("/v1/chat/completions", {"messages": MESSAGES, "n": 2,
                                               "stream": True}),
    "cmpl_n_stream": ("/v1/completions", {"prompt": "a", "n": 2, "stream": True}),
    "cmpl_list_stream": ("/v1/completions", {"prompt": ["a", "b"], "stream": True}),
    "cmpl_n_list": ("/v1/completions", {"prompt": ["a", "b"], "n": 2}),
    "n_big": ("/v1/chat/completions", {"messages": MESSAGES, "n": 65}),
    "n_str": ("/v1/completions", {"prompt": "a", "n": "2"}),
    "batch_logprobs": ("/v1/completions", {"prompt": ["a", "b"], "logprobs": 2}),
    "batch_grammar": ("/v1/completions", {"prompt": "a", "n": 2, "grammar": GRAMMAR}),
    "infill_no_fim": ("/infill", {"input_prefix": "a", "input_suffix": "b"}),
    "infill_bad_body": ("/infill", {"input_prefix": 1, "input_suffix": "b"}),
    "infill_grammar": ("/infill", {"input_prefix": "a", "input_suffix": "b",
                                   "grammar": GRAMMAR}),
    "embedding_bad_pooling": ("/embedding", {"content": "x", "pooling": "max"}),
    "embedding_no_content": ("/embedding", {"text": "x"}),
    "v1_embeddings_bad": ("/v1/embeddings", {"input": [1, 2]}),
    "slot_bad_name": ("/slots/0?action=save", {"filename": "../up"}),
    "slot_dot_name": ("/slots/0?action=restore", {"filename": ".hidden"}),
    "slot_bad_action": ("/slots/0?action=copy", {}),
    "slot_bad_id": ("/slots/x?action=erase", {}),
    "slot_out_of_range": ("/slots/9?action=erase", {}),
    "slot_missing": ("/slots/0?action=restore", {"filename": "none.bin"}),
}
# the answers whose float vectors are compared within EMBED_TOL
EMBED_TOL = 1e-5


def _entry_answers(app, bodies: dict) -> dict:
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = {}
            for name, (route, body) in bodies.items():
                resp = await client.post(route, json=body)
                out[name] = (resp.status, await resp.json())
            return out
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def entry_answers(engines, tmp_path_factory):
    """The reference's and the port's answers, one stream and four slots,
    each server saving its slot files in a directory of its own."""
    jeng, peng = engines
    out = {}
    for slots in (1, 4):
        dirs = [tmp_path_factory.mktemp(f"slots{slots}_{who}") for who in ("ref", "port")]
        ref = JaxChatServer(jeng, JaxGen(temperature=0.0), parallel=slots,
                            slot_save_path=str(dirs[0]))
        port = ChatServer(peng, GenerationConfig(temperature=0.0), parallel=slots,
                          slot_save_path=str(dirs[1]))
        out[slots] = (_entry_answers(ref.app, ENTRY), _entry_answers(port.app, ENTRY))
    return out


def _vectors(body) -> list:
    if "embedding" in body:
        return [body["embedding"]]
    return [d["embedding"] for d in body["data"]]


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("name", list(ENTRY))
def test_entry_routes_give_the_reference_answer(entry_answers, slots, name):
    """Batches give the reference's texts and usage, embeddings its vectors
    within EMBED_TOL, slot files its counts, every refusal its status and
    text."""
    ref, port = entry_answers[slots]
    (status, body), (want_status, want) = port[name], ref[name]
    assert status == want_status, (body, want)
    assert _shape(body) == _shape(want)
    if status == 200 and name.startswith(("embedding", "v1_embeddings")):
        for got_v, want_v in zip(_vectors(body), _vectors(want), strict=True):
            np.testing.assert_allclose(got_v, want_v, rtol=0, atol=EMBED_TOL)
            assert abs(np.linalg.norm(got_v) - 1.0) < 1e-5
        if "usage" in body:
            assert body["usage"] == want["usage"]
    else:
        strip = (lambda d: {k: v for k, v in d.items() if k not in IGNORED}
                 if isinstance(d, dict) else d)
        assert strip(body) == strip(want)


def test_entry_routes_serve_what_they_should(entry_answers):
    """The served answers are not refusals: batches have a choice a row,
    the slot file saved and restored the prefix, and the request after the
    restore reused it."""
    for slots in (1, 4):
        port = entry_answers[slots][1]
        assert [len(port[n][1]["choices"]) for n in ("cmpl_n", "cmpl_list", "chat_n")] \
            == [3, 3, 2]
        assert port["slot_save"][1]["n_saved"] == port["slot_restore"][1]["n_restored"] > 16
        assert port["slot_save_empty"][0] == 400
        assert port["slot_missing"][0] == 404
        assert port["infill_no_fim"][0] == 400 and \
            "fill-in-middle" in port["infill_no_fim"][1]["error"]


def test_infill_is_served_on_a_fim_model(tmp_path):
    """/infill on a GGUF with FIM markers, streamed and whole, gives the
    reference's text and evaluates the reference's PSM prompt."""
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    md = spm_metadata(vocab)
    for key, i in (("prefix", 10), ("suffix", 11), ("middle", 12)):
        md[f"tokenizer.ggml.{key}_token_id"] = np.int32(i)
    path = tmp_path / "fim.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params), tokenizer_metadata=md)
    bodies = {"whole": ("/infill", {"input_prefix": "hello ", "input_suffix": "world",
                                    "n_predict": N, "temperature": 0.0}),
              "stream": ("/infill", {"input_prefix": "hello ", "input_suffix": "world",
                                     "n_predict": N, "temperature": 0.0, "stream": True})}
    ref = JaxChatServer(JaxEngine(path, dtype=jnp.float32), JaxGen(temperature=0.0))
    port = ChatServer(Engine(path, dtype=torch.float32, device="cpu"),
                      GenerationConfig(temperature=0.0))

    def answers(app):
        async def go():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                return {k: await _answer(client, *v) for k, v in bodies.items()}
            finally:
                await client.close()
        return asyncio.run(go())

    want, got = answers(ref.app), answers(port.app)
    for name in bodies:
        assert _text_and_finish("llama" + name, got[name]) == \
            _text_and_finish("llama" + name, want[name])
        assert _shape(got[name][1]) == _shape(want[name][1])
    assert got["whole"][1]["tokens_evaluated"] == want["whole"][1]["tokens_evaluated"] == 7
