"""The llama-server and OpenAI completion routes, on the port's engine.

The counterpart of ``distributed_llm_pipeline_tpu/serving/openai.py``:

- ``POST /completion``            llama-server: {prompt, n_predict, n_probs, ...}
- ``POST /v1/completions``        OpenAI text completion (+ SSE streaming)
- ``POST /v1/chat/completions``   OpenAI chat (+ SSE streaming)
- ``GET  /v1/models``             the registry's loaded models
- ``POST /infill``                llama-server fill-in-middle (FIM tokens)
- ``POST /embedding``, ``POST /v1/embeddings``: pooled embeddings
- ``POST /slots/{id}?action=save|restore|erase``: a slot's KV as a file
  under ``--slot-save-path`` (the engine's prefix cache without slots)
- ``POST /tokenize``, ``POST /detokenize``, ``POST /apply-template``,
  ``GET /props``, ``GET /health``, ``GET /slots``: llama-server's utilities
- ``GET /lora-adapters``: the adapters merged into the default model at load

A request decodes in the slot scheduler's shared batch when the server has
one (``--parallel N``), constrained requests (``grammar``, ``json_schema``,
``response_format`` ``json_object`` / ``json_schema``) included, except
typical-p, mirostat and ``context_shift`` requests, which run on the engine
as one stream under the decode lock, as every request does without slots.
``n`` > 1 and a list of prompts run as one batch on the engine
(``Engine.generate_batch``) under the decode lock, as embeddings do.
Usage counts come from the engine's ``done`` event.

``priority`` (a class name) and ``deadline_ms`` are served on both
dialects, with the reference's 400 texts for bad values; on the slots a
request the scheduler sheds (``SlotScheduler.shed_check``: a full queue or
an unmeetable deadline, a stalled device, a poisoned request) gets its
status with an integer ``Retry-After``, and a request that runs out of
time ends with finish reason ``timeout`` (``timed_out`` on /completion).
``/completion``'s chunks, final answers and shed bodies carry the
request's trace id (``request_id``, ``GET /debug/trace?id=``), and every
completion route stamps a propagated ``X-DLP-Trace`` context on its trace.

Requests pick a model of the server's ``ModelRegistry`` with the
standard ``model`` field (left out: the default model); a model that is not
loaded is a 404. LoRA adapters are merged at load, as in the reference, so
a request's ``lora`` field asks for nothing and is not read (the
reference's answer).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import re
import threading
import time
import uuid
from pathlib import Path

from aiohttp import web

from ..models.llama import POOLING_TYPES
from ..runtime import GenerationConfig
from ..runtime.scheduler import LP_TOPK
from ..utils.tracing import TRACE_HEADER, parse_trace_context
from .chat_template import ChatTemplateError, render_chat_template
from .chat_template import _text_of as text_of
from .common import (acquire_with_keepalive, cors, engine_events, json_response,
                     priority_error, retry_after_value, shed_response,
                     sse_response)

def _retry_headers(final: dict) -> dict | None:
    """``Retry-After`` for an error that came from a shed decision (its
    ``retry_after_s``), in integer seconds."""
    ra = final.get("retry_after_s")
    return {"Retry-After": retry_after_value(ra)} if ra is not None else None


def build_prompt(messages: list[dict], tokenizer) -> str:
    """Render an OpenAI ``messages`` list to one prompt string: the GGUF's
    own Jinja template (``tokenizer.chat_template``) when present and valid;
    else Llama-3's header tokens when the vocabulary has them; else a plain
    transcript ending with the assistant cue."""
    v = tokenizer.vocab
    if getattr(v, "chat_template", None):
        bos = v.tokens[v.bos_id] if v.bos_id is not None else ""
        eos = v.tokens[v.eos_id] if v.eos_id is not None else ""
        try:
            out = render_chat_template(v.chat_template, messages,
                                       bos_token=bos, eos_token=eos)
            # encode() adds BOS itself; a template that emits it too would
            # double it
            if v.add_bos and bos and out.startswith(bos):
                out = out[len(bos):]
            return out
        except (ChatTemplateError, TypeError, KeyError):
            pass  # a malformed or unsupported template: the fallbacks below

    t2i = v.token_to_id
    if "<|start_header_id|>" in t2i and "<|eot_id|>" in t2i:
        parts = ["<|begin_of_text|>"] if "<|begin_of_text|>" in t2i else []
        for m in messages:
            parts.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                         f"{text_of(m)}<|eot_id|>")
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts)
    lines = [f"{m['role']}: {text_of(m)}" for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


def _finite(x) -> float | None:
    """NaN and inf are not JSON: strict clients reject the body."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


class BadRequest(Exception):
    pass


class ModelNotFound(Exception):
    pass


class CompletionAPI:
    """The completion routes, registered onto a ChatServer's app; they share
    its model registry, its decode lock and its slot scheduler (None without
    ``--parallel``), which serves the default model."""

    def __init__(self, registry, busy: asyncio.Lock, gen: GenerationConfig,
                 model_id: str = "default", slots=None,
                 slot_save_path: str | None = None, pooling: str = "mean"):
        if pooling not in POOLING_TYPES:
            raise ValueError(f"unsupported pooling {pooling!r} "
                             f"(one of {', '.join(POOLING_TYPES)})")
        self.registry = registry
        self._busy = busy
        self.gen = gen
        self.model_id = model_id
        self.slots = slots
        self.slot_save_path = slot_save_path   # llama-server --slot-save-path
        self.pooling = pooling                 # llama-server --pooling

    def _resolve(self, body: dict):
        """The engine and model label for a body's ``model`` field."""
        mid = body.get("model")
        if mid is not None and not isinstance(mid, str):
            raise BadRequest(f"'model' must be a string, got {mid!r}")
        try:
            return self.registry.get(mid), (mid or self.model_id)
        except KeyError as e:
            raise ModelNotFound(str(e)) from None

    def register(self, app: web.Application) -> None:
        for path in ("/completion", "/v1/completions", "/v1/chat/completions"):
            app.router.add_options(path, self._preflight)
        app.router.add_post("/completion", self.completion)
        app.router.add_post("/infill", self.infill)
        app.router.add_post("/v1/completions", self.v1_completions)
        app.router.add_post("/v1/chat/completions", self.v1_chat)
        app.router.add_get("/v1/models", self.v1_models)
        app.router.add_post("/embedding", self.embedding)
        app.router.add_post("/v1/embeddings", self.v1_embeddings)
        app.router.add_post("/tokenize", self.tokenize)
        app.router.add_post("/detokenize", self.detokenize)
        app.router.add_post("/apply-template", self.apply_template)
        app.router.add_get("/props", self.props)
        app.router.add_get("/health", self.health)
        app.router.add_get("/slots", self.slots_handler)
        app.router.add_post("/slots/{slot_id}", self.slot_action)
        app.router.add_get("/lora-adapters", self.lora_adapters)

    # -- shared plumbing ----------------------------------------------------

    def _target(self, engine, gen: GenerationConfig):
        """(target, needs_lock): the slot scheduler, without the lock, when
        the server has one and it serves this engine (the default model;
        constrained requests run on a slot too), except for context-shift
        requests and sampled typical-p and mirostat ones (per-row shifted
        windows, per-request entropy filtering and μ state are not in the
        batched row sampler); else the engine under the decode lock."""
        single = gen.temperature > 0.0 and (gen.typical_p < 1.0 or bool(gen.mirostat))
        s = self.slots
        if (s is not None and engine is s._src and not gen.context_shift
                and not single):
            return s, False
        return engine, True

    def _tok_str(self, engine, tid: int) -> str:
        return engine.tokenizer.token_bytes(int(tid)).decode("utf-8", "replace")

    def _lp_entries(self, engine, tok_data: list[dict], n: int):
        """Per-token (text, logprob, [(alt text, alt logprob), ...]) from the
        token events' data."""
        out = []
        for d in tok_data:
            top = []
            if n > 0:
                top = [(self._tok_str(engine, i), float(v)) for i, v in
                       zip(d.get("top_ids", [])[:n], d.get("top_logprobs", [])[:n])]
            out.append((self._tok_str(engine, d["id"]), float(d["logprob"]), top))
        return out

    def _openai_lp(self, engine, tok_data: list[dict], n: int) -> dict:
        """The OpenAI completions ``logprobs`` object. ``_collect`` stamps
        each entry's offset in the returned text (``_text_start``); the
        streaming path, one token a chunk, counts per-token lengths."""
        entries = self._lp_entries(engine, tok_data, n)
        if tok_data and all("_text_start" in d for d in tok_data):
            offsets = [d["_text_start"] for d in tok_data]
        else:
            offsets, pos = [], 0
            for s, _, _ in entries:
                offsets.append(pos)
                pos += len(s)

        def first_wins(top):
            # two ids can decode to the same string; entries are sorted
            # descending, so the first keeps the larger logprob
            d = {}
            for s, v in top:
                d.setdefault(s, v)
            return d

        return {"tokens": [s for s, _, _ in entries],
                "token_logprobs": [lp for _, lp, _ in entries],
                "top_logprobs": ([first_wins(top) for _, _, top in entries]
                                 if n > 0 else None),
                "text_offset": offsets}

    def _chat_lp(self, engine, tok_data: list[dict], n: int) -> dict:
        """The OpenAI chat ``logprobs`` object ({"content": [...]})."""
        return {"content": [
            {"token": s, "logprob": lp, "bytes": list(s.encode("utf-8")),
             "top_logprobs": [{"token": ts, "logprob": tl,
                               "bytes": list(ts.encode("utf-8"))} for ts, tl in top]}
            for s, lp, top in self._lp_entries(engine, tok_data, n)]}

    def _llama_probs(self, engine, tok_data: list[dict], n: int) -> list:
        """llama-server's ``completion_probabilities`` list."""
        return [{"content": s,
                 "probs": [{"tok_str": ts, "prob": math.exp(tl)} for ts, tl in top]}
                for s, _, top in self._lp_entries(engine, tok_data, n)]

    async def _preflight(self, request: web.Request) -> web.Response:
        return cors(web.Response())

    def _llama_writer(self, engine, gen: GenerationConfig):
        def write_event(ev):
            if ev.kind == "token":
                chunk = {"content": ev.content, "stop": False}
                if gen.logprobs is not None and ev.data and "id" in ev.data:
                    chunk["completion_probabilities"] = self._llama_probs(
                        engine, [ev.data], gen.logprobs)
            elif ev.kind == "done":
                d = ev.data or {}
                chunk = {"content": "", "stop": True,
                         "stopped_eos": d.get("finish_reason") == "stop",
                         "stopped_limit": d.get("finish_reason") == "length",
                         "timed_out": d.get("finish_reason") == "timeout",
                         "tokens_predicted": d.get("n_gen", 0),
                         "tokens_evaluated": d.get("n_prompt", 0)}
                if d.get("request_id"):
                    # the lifecycle-trace id (GET /debug/trace?id=), the
                    # one in the JSON finish log and the trace ring
                    chunk["request_id"] = d["request_id"]
                if "error" in d:
                    chunk["error"] = d["error"]
            else:
                return None
            return f"data: {json.dumps(chunk)}\n\n".encode()

        return write_event

    def _llama_final(self, engine, gen: GenerationConfig, text: str,
                     final: dict, tok_data: list[dict]) -> web.Response:
        rid = {"request_id": final["request_id"]} if final.get("request_id") else {}
        if "error" in final:
            return json_response({"error": final["error"], **rid},
                                 status=final.get("status", 500),
                                 headers=_retry_headers(final))
        extra = dict(rid)
        if gen.logprobs is not None:
            extra["completion_probabilities"] = self._llama_probs(
                engine, tok_data, gen.logprobs)
        return json_response({
            "content": text, "stop": True, **extra,
            "stopped_eos": final.get("finish_reason") == "stop",
            "stopped_limit": final.get("finish_reason") == "length",
            "timed_out": final.get("finish_reason") == "timeout",
            "tokens_predicted": final.get("n_gen", 0),
            "tokens_evaluated": final.get("n_prompt", 0),
            "timings": {"predicted_per_second": _finite(final.get("tok_s")),
                        "prompt_ms": _finite(final.get("ttft_ms"))},
        })

    def _gen_config(self, body: dict, *, n_key: str) -> GenerationConfig:
        """Client overrides with strict validation: absent or null keys fall
        back to the server's defaults; a non-numeric value is a 400, as is a
        field the port does not serve yet and a constraint combined with
        another constraint, a penalty, a bias or logprobs (the reference's
        texts)."""
        g = self.gen
        def take(keys: tuple[str, ...], conv, default):
            for k in keys:
                v = body.get(k)
                if v is not None:
                    try:
                        return conv(v)
                    except (TypeError, ValueError):
                        raise BadRequest(f"parameter {k!r} must be numeric, "
                                         f"got {v!r}") from None
            return default

        stop = body.get("stop")
        if stop is None:
            stop = g.stop
        elif isinstance(stop, str):
            stop = (stop,)
        elif isinstance(stop, list) and all(isinstance(s, str) for s in stop):
            stop = tuple(stop)
        else:
            raise BadRequest(f"parameter 'stop' must be a string or list of "
                             f"strings, got {stop!r}")
        rf = body.get("response_format")
        json_mode = g.json_mode
        schema = body.get("json_schema")    # llama-server dialect
        if rf is not None:
            if not (isinstance(rf, dict) and rf.get("type") in
                    ("json_object", "text", "json_schema")):
                raise BadRequest(
                    "response_format must be {'type': 'json_object'}, "
                    "{'type': 'text'} or {'type': 'json_schema', "
                    "'json_schema': {...}}")
            json_mode = rf["type"] == "json_object"
            if rf["type"] == "json_schema":   # OpenAI structured outputs
                js = rf.get("json_schema")
                if not isinstance(js, dict) or "schema" not in js:
                    # the wrapper dict as a schema would constrain nothing
                    # while the client believes the output was validated
                    raise BadRequest("response_format json_schema needs "
                                     "{'json_schema': {'schema': {...}}}")
                schema = js["schema"]
        grammar = body.get("grammar", g.grammar)
        if grammar is not None and not isinstance(grammar, str):
            raise BadRequest("'grammar' must be a GBNF string")
        if schema is not None:
            if grammar:
                raise BadRequest("'json_schema' and 'grammar' are mutually "
                                 "exclusive constraints; pick one")
            if not isinstance(schema, (dict, bool)):
                raise BadRequest("'json_schema' must be a schema object")
            from ..ops.json_schema import schema_to_gbnf

            try:
                grammar = schema_to_gbnf(schema)
            except ValueError as e:
                raise BadRequest(f"unsupported json_schema: {e}") from None
        if grammar:
            from ..ops.gbnf import GBNFError, compile_grammar

            try:
                compile_grammar(grammar)   # a bad grammar is a 400
            except GBNFError as e:
                raise BadRequest(f"invalid grammar: {e}") from None
        if json_mode and grammar:
            raise BadRequest("response_format json_object and 'grammar' are "
                             "mutually exclusive constraints; pick one")
        if (json_mode or grammar) and (
                take(("repeat_penalty",), float, g.repeat_penalty) != 1.0
                or take(("presence_penalty",), float, g.presence_penalty) != 0.0
                or take(("frequency_penalty",), float, g.frequency_penalty) != 0.0):
            raise BadRequest("repeat/presence/frequency penalties do not "
                             "combine with constrained sampling")
        if (json_mode or grammar) and (body.get("logit_bias") or g.logit_bias):
            raise BadRequest("logit_bias does not combine with constrained "
                             "sampling")
        # logit_bias: OpenAI's {"token_id": bias}, or llama-server's
        # [[id, bias], ...] where false bans the token
        lb = body.get("logit_bias")
        bias_pairs = g.logit_bias
        if lb is not None:
            pairs = []
            try:
                items = (lb.items() if isinstance(lb, dict)
                         else [(e[0], e[1]) for e in lb])
                for tid, bv in items:
                    if bv is False:
                        bv = float("-inf")
                    elif bv is True:
                        raise ValueError("true is not a bias")
                    pairs.append((int(tid), float(bv)))
            except (TypeError, ValueError, IndexError):
                raise BadRequest(
                    "'logit_bias' must be {token_id: bias} or "
                    "[[token_id, bias], ...] (false bans a token)") from None
            bias_pairs = tuple(pairs)
        # the slots compute LP_TOPK alternatives a step: no more are taken
        lp = None
        n_probs = body.get("n_probs")                    # llama-server dialect
        if n_probs is not None:
            if not isinstance(n_probs, int) or not 0 <= n_probs <= LP_TOPK:
                raise BadRequest(f"'n_probs' must be an int in [0, {LP_TOPK}]")
            lp = n_probs if n_probs > 0 else None
        v = body.get("logprobs")                         # OpenAI dialects
        if v is not None:
            if isinstance(v, bool):                      # chat: bool + top_logprobs
                if v:
                    t = body.get("top_logprobs", 0) or 0
                    if not isinstance(t, int) or not 0 <= t <= LP_TOPK:
                        raise BadRequest(
                            f"'top_logprobs' must be an int in [0, {LP_TOPK}]")
                    lp = t
            elif isinstance(v, int) and 0 <= v <= LP_TOPK:  # completions: int
                lp = v
            else:
                raise BadRequest(f"'logprobs' must be a bool or an int "
                                 f"in [0, {LP_TOPK}]")
        if lp is not None and (json_mode or grammar):
            raise BadRequest("logprobs does not combine with constrained "
                             "sampling")
        miro = take(("mirostat",), int, g.mirostat)
        temp = take(("temperature",), float, g.temperature)
        if lp is not None and miro and temp > 0.0:
            raise BadRequest("logprobs does not combine with mirostat")
        ctx_shift = body.get("context_shift", False)
        if not isinstance(ctx_shift, bool):
            raise BadRequest("'context_shift' must be a boolean")
        n_keep = body.get("n_keep", 0)
        if not isinstance(n_keep, int) or n_keep < 0:
            raise BadRequest("'n_keep' must be a non-negative int")
        deadline = take(("deadline_ms",), float, g.deadline_ms)
        if deadline is not None and deadline <= 0:
            raise BadRequest("'deadline_ms' must be a positive number "
                             "of milliseconds")
        prio = body.get("priority")
        err = priority_error(prio)
        if err is not None:
            raise BadRequest(err)
        if prio is None:
            prio = g.priority   # null: the server's default
        return GenerationConfig(
            deadline_ms=deadline,
            priority=prio,
            max_new_tokens=take((n_key, "n_predict"), int, g.max_new_tokens),
            temperature=temp,
            top_k=take(("top_k",), int, g.top_k),
            top_p=take(("top_p",), float, g.top_p),
            min_p=take(("min_p",), float, g.min_p),
            typical_p=take(("typical_p", "typical"), float, g.typical_p),
            mirostat=miro,
            mirostat_tau=take(("mirostat_tau",), float, g.mirostat_tau),
            mirostat_eta=take(("mirostat_eta",), float, g.mirostat_eta),
            repeat_penalty=take(("repeat_penalty",), float, g.repeat_penalty),
            repeat_last_n=take(("repeat_last_n",), int, g.repeat_last_n),
            presence_penalty=take(("presence_penalty",), float, g.presence_penalty),
            frequency_penalty=take(("frequency_penalty",), float, g.frequency_penalty),
            logit_bias=bias_pairs,
            seed=take(("seed",), int, g.seed),
            stop=stop,
            json_mode=json_mode,
            grammar=grammar,
            logprobs=lp,
            context_shift=ctx_shift,
            keep=n_keep,
        )

    @staticmethod
    async def _read_json(request: web.Request) -> dict | None:
        try:
            body = await request.json()
            return body if isinstance(body, dict) else None
        except json.JSONDecodeError:
            return None

    @staticmethod
    def _usage(d: dict) -> dict:
        return {"prompt_tokens": d.get("n_prompt", 0),
                "completion_tokens": d.get("n_gen", 0),
                "total_tokens": d.get("n_prompt", 0) + d.get("n_gen", 0)}

    @staticmethod
    def _openai_error(msg: str, status: int = 400,
                      headers: dict | None = None) -> web.Response:
        err_type = "invalid_request_error" if status < 500 else "server_error"
        return json_response({"error": {"message": msg, "type": err_type}},
                             status=status, headers=headers)

    async def _collect(self, engine, prompt, gen: GenerationConfig,
                       trace_ctx: dict | None = None
                       ) -> tuple[str, dict, list[dict]]:
        """Run to completion: (text, the done event's data, the token
        events' data, each stamped with its offset in the text).
        ``trace_ctx`` stamps a propagated fleet context on the trace."""
        target, lock = self._target(engine, gen)
        if not lock:
            shed = target.shed_check(
                gen, prompt if isinstance(prompt, str) else None)
            if shed is not None:   # 429 / 503 / 400 with Retry-After
                final = {"error": shed["reason"], "finish_reason": "error",
                         "status": shed["status"],
                         "retry_after_s": shed["retry_after_s"]}
                if shed.get("request_id"):
                    final["request_id"] = shed["request_id"]
                return "", final, []
        abort = threading.Event()
        text: list[str] = []
        final: dict = {}
        tok_data: list[dict] = []
        emitted = 0
        async with contextlib.AsyncExitStack() as stack:
            if lock:
                await stack.enter_async_context(self._busy)
            async with contextlib.aclosing(
                    engine_events(target, prompt, gen, abort,
                                  trace_ctx=trace_ctx)) as events:
                async for ev in events:
                    if ev is None:
                        continue
                    if ev.kind == "token":
                        if ev.data and "id" in ev.data:
                            tok_data.append({**ev.data, "_text_start": emitted})
                        text.append(ev.content)
                        emitted += len(ev.content)
                    elif ev.kind == "done":
                        final = ev.data or {}
        full = "".join(text)
        if gen.stop and gen.logprobs is not None and tok_data:
            # the tokens a stop string consumed are not in the text: their
            # logprob entries go too, so tokens and offsets match the text
            tok_data = [d for d in tok_data if d["_text_start"] < len(full)]
        return full, final, tok_data

    async def _stream(self, request: web.Request, engine, prompt,
                      gen: GenerationConfig, write_event, epilogue: bytes = b""):
        """SSE with keep-alives while queued and while idle; ``write_event``
        maps an engine event to bytes (or None to skip it). The propagated
        ``X-DLP-Trace`` context is parsed here, once for every streaming
        dialect, and stamped on the request's trace."""
        trace_ctx = parse_trace_context(request.headers.get(TRACE_HEADER))
        target, lock = self._target(engine, gen)
        if not lock:
            shed = target.shed_check(
                gen, prompt if isinstance(prompt, str) else None)
            if shed is not None:   # 429 / 503 / 400 with Retry-After
                return shed_response(shed)
        resp = await sse_response(request)
        if lock and not await acquire_with_keepalive(self._busy, resp):
            return resp
        abort = threading.Event()
        broke = False
        try:
            async with contextlib.aclosing(
                    engine_events(target, prompt, gen, abort,
                                  trace_ctx=trace_ctx)) as events:
                async for ev in events:
                    payload = b": keep-alive\n\n" if ev is None else write_event(ev)
                    if payload is None:
                        continue
                    try:
                        await resp.write(payload)
                    except (ConnectionResetError, asyncio.CancelledError):
                        abort.set()
                        broke = True
                        break
            if epilogue and not broke:
                with contextlib.suppress(ConnectionResetError, asyncio.CancelledError):
                    await resp.write(epilogue)
        finally:
            abort.set()
            if lock:
                self._busy.release()
        with contextlib.suppress(ConnectionResetError):
            await resp.write_eof()
        return resp

    # -- llama-server ---------------------------------------------------------

    async def completion(self, request: web.Request) -> web.StreamResponse:
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("prompt"), str):
            return json_response({"error": "body must be JSON with a string 'prompt'"},
                                 status=400)
        try:
            gen = self._gen_config(body, n_key="n_predict")
            engine, _ = self._resolve(body)
        except BadRequest as e:
            return json_response({"error": str(e)}, status=400)
        except ModelNotFound as e:
            return json_response({"error": str(e)}, status=404)
        if body.get("stream"):
            return await self._stream(request, engine, body["prompt"], gen,
                                      self._llama_writer(engine, gen))
        text, final, tok_data = await self._collect(
            engine, body["prompt"], gen,
            trace_ctx=parse_trace_context(request.headers.get(TRACE_HEADER)))
        return self._llama_final(engine, gen, text, final, tok_data)

    async def infill(self, request: web.Request) -> web.StreamResponse:
        """llama-server's ``POST /infill``: a completion between
        ``input_prefix`` and ``input_suffix`` through the model's
        fill-in-middle tokens, in ``/completion``'s shape, streamed or
        whole."""
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("input_prefix"), str) \
                or not isinstance(body.get("input_suffix"), str):
            return json_response(
                {"error": "body must be JSON with string 'input_prefix' "
                          "and 'input_suffix'"}, status=400)
        try:
            gen = self._gen_config(body, n_key="n_predict")
            engine, _ = self._resolve(body)
        except BadRequest as e:
            return json_response({"error": str(e)}, status=400)
        except ModelNotFound as e:
            return json_response({"error": str(e)}, status=404)
        if gen.json_mode or gen.grammar:
            return json_response({"error": "constrained sampling does not "
                                           "combine with /infill"}, status=400)
        try:
            ids = engine.infill_ids(body["input_prefix"], body["input_suffix"])
        except ValueError as e:   # a vocabulary without FIM tokens
            return json_response({"error": str(e)}, status=400)
        if body.get("stream"):
            return await self._stream(request, engine, ids, gen,
                                      self._llama_writer(engine, gen))
        text, final, tok_data = await self._collect(engine, ids, gen)
        return self._llama_final(engine, gen, text, final, tok_data)

    async def embedding(self, request: web.Request) -> web.Response:
        """llama-server's ``POST /embedding``: {"embedding": [...]}, pooled
        by the body's ``pooling`` or the server's ``--pooling``."""
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("content"), str):
            return json_response({"error": "body must be JSON with string "
                                           "'content'"}, status=400)
        try:
            engine, _ = self._resolve(body)
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        except BadRequest as e:
            return self._openai_error(str(e))
        pooling = body.get("pooling", self.pooling)
        if pooling not in POOLING_TYPES:
            return json_response({"error": "pooling must be one of "
                                           + ", ".join(POOLING_TYPES)},
                                 status=400)
        try:
            async with self._busy:
                emb = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: engine.embed(body["content"], pooling=pooling))
        except NotImplementedError as e:   # the mesh
            return json_response({"error": str(e)}, status=400)
        return json_response({"embedding": emb})

    async def v1_embeddings(self, request: web.Request) -> web.Response:
        """OpenAI's ``POST /v1/embeddings``: one string or a list of them,
        pooled by ``--pooling``."""
        body = await self._read_json(request)
        if body is None or "input" not in body:
            return self._openai_error("body must be JSON with 'input'")
        inp = body["input"]
        if isinstance(inp, str):
            texts = [inp]
        elif isinstance(inp, list) and inp and all(isinstance(t, str) for t in inp):
            texts = inp
        else:
            return self._openai_error(
                "'input' must be a string or non-empty list of strings")
        try:
            engine, model_label = self._resolve(body)
        except BadRequest as e:
            return self._openai_error(str(e))
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        loop = asyncio.get_running_loop()
        data, n_tok = [], 0
        try:
            async with self._busy:
                for i, t in enumerate(texts):
                    emb, n = await loop.run_in_executor(
                        None, lambda t=t: engine.embed(t, with_count=True,
                                                       pooling=self.pooling))
                    data.append({"object": "embedding", "index": i,
                                 "embedding": emb})
                    n_tok += n   # the tokens evaluated, after truncation
        except NotImplementedError as e:   # the mesh
            return self._openai_error(str(e))
        return json_response({
            "object": "list", "data": data, "model": model_label,
            "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}})

    async def slot_action(self, request: web.Request) -> web.Response:
        """llama-server's ``POST /slots/{id}?action=save|restore|erase``: a
        slot's KV and token ids saved to or restored from a file under
        ``--slot-save-path``, or dropped. Without slots there is one slot,
        id 0, the engine's prefix cache: the state ``--prompt-cache``
        keeps."""
        action = request.query.get("action")
        if action not in ("save", "restore", "erase"):
            return json_response(
                {"error": "action must be save, restore or erase"}, status=400)
        try:
            slot_id = int(request.match_info["slot_id"])
        except ValueError:
            return json_response({"error": "slot id must be an integer"},
                                 status=400)
        sched = self.slots
        if sched is None and slot_id != 0:
            return json_response(
                {"error": "without --parallel there is one slot (id 0)"},
                status=400)
        if sched is not None and not 0 <= slot_id < sched.n_slots:
            return json_response(
                {"error": f"slot id out of range (0..{sched.n_slots - 1})"},
                status=400)
        sup = self.registry.get()
        engine = getattr(sup, "engine", sup)
        loop = asyncio.get_running_loop()
        try:
            if action == "erase":
                if sched is not None:
                    await loop.run_in_executor(None, lambda: sched.erase_slot(slot_id))
                else:
                    # under the decode lock: a request in flight owns the
                    # prefix cache until it ends
                    async with self._busy:
                        engine.erase_session()
                return json_response({"id_slot": slot_id, "erased": True})
            if self.slot_save_path is None:
                return json_response(
                    {"error": "slot save/restore needs --slot-save-path"},
                    status=400)
            body = await self._read_json(request) or {}
            fname = body.get("filename")
            if not isinstance(fname, str) or not re.fullmatch(
                    r"[A-Za-z0-9._-]{1,128}", fname) or fname.startswith("."):
                return json_response(
                    {"error": "'filename' must be a plain file name "
                              "(letters, digits, ., _, -)"}, status=400)
            path = Path(self.slot_save_path) / fname
            if action == "save":
                # the directory may not exist yet; a missing one is no 404
                Path(self.slot_save_path).mkdir(parents=True, exist_ok=True)
                if sched is not None:
                    n_saved = await loop.run_in_executor(
                        None, lambda: sched.save_slot(slot_id, path))
                else:
                    async with self._busy:
                        ok = await loop.run_in_executor(
                            None, lambda: engine.save_session(path))
                        # counted under the lock: the next request replaces
                        # the prefix
                        n_saved = len(engine._prefix_ids) if ok else 0
                if not n_saved:
                    return json_response(
                        {"error": "no decode state to save (slot is idle "
                                  "and holds no KV)"}, status=400)
                return json_response({"id_slot": slot_id, "filename": fname,
                                      "n_saved": n_saved})
            if sched is not None:
                n = await loop.run_in_executor(
                    None, lambda: sched.restore_slot(slot_id, path))
            else:
                async with self._busy:
                    n = await loop.run_in_executor(
                        None, lambda: engine.load_session(path))
            if n == 0:
                return json_response(
                    {"error": "session file does not match this model/ctx"},
                    status=400)
            return json_response({"id_slot": slot_id, "filename": fname,
                                  "n_restored": n})
        except NotImplementedError as e:   # the mesh
            return json_response({"error": str(e)}, status=400)
        except RuntimeError as e:   # a busy slot
            return json_response({"error": str(e)}, status=409)
        except FileNotFoundError:
            return json_response({"error": f"no such session: {fname}"},
                                 status=404)
        except Exception as e:
            return json_response({"error": repr(e)}, status=500)

    async def _batch(self, engine, prompts: list[str], gen: GenerationConfig):
        """A batch on the engine under the decode lock: (results, None), or
        (None, the error response)."""
        try:
            async with self._busy:
                results = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: engine.generate_batch(prompts, gen))
        except (NotImplementedError, ValueError) as e:
            return None, self._openai_error(str(e))
        except Exception as e:
            return None, self._openai_error(repr(e), status=500)
        return results, None

    @staticmethod
    def _batch_usage(results: list[dict]) -> dict:
        return {"prompt_tokens": sum(r["n_prompt"] for r in results),
                "completion_tokens": sum(r["n_gen"] for r in results),
                "total_tokens": sum(r["n_prompt"] + r["n_gen"] for r in results)}

    async def tokenize(self, request: web.Request) -> web.Response:
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("content"), str):
            return json_response({"error": "body must be JSON with string "
                                           "'content'"}, status=400)
        try:
            engine, _ = self._resolve(body)
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        except BadRequest as e:
            return self._openai_error(str(e))
        return json_response({"tokens": engine.tokenizer.encode(body["content"])})

    async def detokenize(self, request: web.Request) -> web.Response:
        body = await self._read_json(request)
        toks = body.get("tokens") if body else None
        if not isinstance(toks, list) or not all(isinstance(t, int) for t in toks):
            return json_response({"error": "body must be JSON with int list "
                                           "'tokens'"}, status=400)
        try:
            engine, _ = self._resolve(body)
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        except BadRequest as e:
            return self._openai_error(str(e))
        V = engine.cfg.vocab_size
        bad = [t for t in toks if not 0 <= t < V]
        if bad:  # a negative id would index the vocabulary from its end
            return json_response(
                {"error": f"token ids out of range [0, {V}): {bad[:5]}"}, status=400)
        return json_response({"content": engine.tokenizer.decode(toks)})

    async def apply_template(self, request: web.Request) -> web.Response:
        """Render the chat template over a messages list without generating:
        the prompt a /v1/chat/completions call would evaluate."""
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("messages"), list):
            return json_response({"error": "body must be JSON with a "
                                           "'messages' list"}, status=400)
        try:
            engine, _ = self._resolve(body)
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        except BadRequest as e:
            return self._openai_error(str(e))
        try:
            prompt = build_prompt(body["messages"], engine.tokenizer)
        except (KeyError, TypeError, ValueError) as e:
            return json_response({"error": f"invalid messages: {e}"}, status=400)
        return json_response({"prompt": prompt})

    async def lora_adapters(self, request: web.Request) -> web.Response:
        """llama-server's ``GET /lora-adapters``: the adapters merged into
        the default model's weights at load, each scale as merged (the list
        is fixed until the model reloads)."""
        sup = self.registry.get()
        eng = getattr(sup, "engine", sup)
        ads = getattr(eng, "lora_adapters", []) or []
        return json_response([{"id": i, "path": path, "scale": scale}
                              for i, (path, scale) in enumerate(ads)])

    async def props(self, request: web.Request) -> web.Response:
        g, eng = self.gen, self.registry.get()
        return json_response({
            "default_generation_settings": {
                "n_predict": g.max_new_tokens, "temperature": g.temperature,
                "top_k": g.top_k, "top_p": g.top_p, "min_p": g.min_p,
                "typical_p": g.typical_p, "mirostat": g.mirostat,
                "mirostat_tau": g.mirostat_tau, "mirostat_eta": g.mirostat_eta,
                "repeat_penalty": g.repeat_penalty,
                "presence_penalty": g.presence_penalty,
                "frequency_penalty": g.frequency_penalty,
            },
            "total_slots": self.slots.n_slots if self.slots else 1,
            "chat_template": getattr(eng.tokenizer.vocab, "chat_template", None) or "",
            "model": {"arch": eng.cfg.arch, "n_ctx": eng.max_seq,
                      "n_layers": eng.cfg.n_layers, "dim": eng.cfg.dim,
                      "vocab_size": eng.cfg.vocab_size},
        })

    async def health(self, request: web.Request) -> web.Response:
        """llama-server's ``GET /health``: ok while every loaded model is
        healthy, else 503 (``/healthz`` has the per-model view)."""
        models = self.registry.health()
        ok = all(h["status"] == "healthy" for h in models.values())
        return json_response({"status": "ok" if ok else "error"},
                             status=200 if ok else 503)

    async def slots_handler(self, request: web.Request) -> web.Response:
        """llama-server's ``GET /slots``; without slots, the one implicit
        slot is the decode lock."""
        if self.slots is None:
            state = "processing" if self._busy.locked() else "idle"
            return json_response([{"id": 0, "state": state, "n_decoded": 0}])
        return json_response(self.slots.slot_states())

    # -- OpenAI ---------------------------------------------------------------

    async def v1_models(self, request: web.Request) -> web.Response:
        return json_response({"object": "list", "data": [
            {"id": mid, "object": "model", "created": int(time.time()),
             "owned_by": "distributed_llm_pipeline_tpu_torch"}
            for mid in self.registry.ids()]})

    async def v1_completions(self, request: web.Request) -> web.StreamResponse:
        body = await self._read_json(request)
        if body is None or "prompt" not in body:
            return self._openai_error("body must be JSON with 'prompt'")
        prompt = body["prompt"]
        if isinstance(prompt, list) and len(prompt) == 1 and isinstance(prompt[0], str):
            prompt = prompt[0]
        if not (isinstance(prompt, str)
                or (isinstance(prompt, list) and prompt
                    and all(isinstance(p, str) for p in prompt))):
            return self._openai_error(
                "'prompt' must be a string or a non-empty list of strings")
        try:
            gen = self._gen_config(body, n_key="max_tokens")
            engine, model_label = self._resolve(body)
        except BadRequest as e:
            return self._openai_error(str(e))
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        n = body.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 64:
            return self._openai_error("'n' must be an int in [1, 64]")
        if n > 1:
            # n completions of one prompt: an n-row batch, each row sampling
            # on its own
            if isinstance(prompt, list):
                return self._openai_error(
                    "'n' > 1 does not combine with a list of prompts")
            prompt = [prompt] * n
        if isinstance(prompt, list):
            # a batch completes as one unit: no streaming
            if body.get("stream"):
                return self._openai_error(
                    "streaming is not supported with a batch of prompts")
            results, err = await self._batch(engine, prompt, gen)
            if err is not None:
                return err
            return json_response({
                "id": rid, "object": "text_completion", "created": created,
                "model": model_label,
                "choices": [{"index": i, "text": r["text"], "logprobs": None,
                             "finish_reason": r["finish_reason"]}
                            for i, r in enumerate(results)],
                "usage": self._batch_usage(results),
            })

        if body.get("stream"):
            run_offset = [0]  # the completion's text so far, across chunks

            def write_event(ev):
                if ev.kind == "token":
                    text, finish = ev.content, None
                elif ev.kind == "done":
                    text, finish = "", (ev.data or {}).get("finish_reason", "length")
                else:
                    return None
                lp_obj = None
                if (gen.logprobs is not None and ev.kind == "token"
                        and ev.data and "id" in ev.data):
                    lp_obj = self._openai_lp(engine, [ev.data], gen.logprobs)
                    # text_offset counts over the whole completion
                    lp_obj["text_offset"] = [o + run_offset[0]
                                             for o in lp_obj["text_offset"]]
                if ev.kind == "token":
                    run_offset[0] += len(ev.content)
                chunk = {"id": rid, "object": "text_completion", "created": created,
                         "model": model_label,
                         "choices": [{"index": 0, "text": text, "logprobs": lp_obj,
                                      "finish_reason": finish}]}
                return f"data: {json.dumps(chunk)}\n\n".encode()

            return await self._stream(request, engine, prompt, gen, write_event,
                                      epilogue=b"data: [DONE]\n\n")

        text, final, tok_data = await self._collect(engine, prompt, gen)
        if "error" in final:
            return self._openai_error(final["error"], status=final.get("status", 500),
                                      headers=_retry_headers(final))
        lp_obj = (self._openai_lp(engine, tok_data, gen.logprobs)
                  if gen.logprobs is not None else None)
        return json_response({
            "id": rid, "object": "text_completion", "created": created,
            "model": model_label,
            "choices": [{"index": 0, "text": text, "logprobs": lp_obj,
                         "finish_reason": final.get("finish_reason", "length")}],
            "usage": self._usage(final),
        })

    async def v1_chat(self, request: web.Request) -> web.StreamResponse:
        body = await self._read_json(request)
        if body is None or not isinstance(body.get("messages"), list):
            return self._openai_error("body must be JSON with 'messages'")
        try:
            gen = self._gen_config(body, n_key="max_tokens")
            engine, model_label = self._resolve(body)
        except BadRequest as e:
            return self._openai_error(str(e))
        except ModelNotFound as e:
            return self._openai_error(str(e), status=404)
        try:
            prompt = build_prompt(body["messages"], engine.tokenizer)
        except (KeyError, TypeError, ValueError):
            return self._openai_error("messages must be [{role, content}, ...]")
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        n = body.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 64:
            return self._openai_error("'n' must be an int in [1, 64]")
        if n > 1:
            # n samples of one conversation: an n-row batch, not streamed
            if body.get("stream"):
                return self._openai_error("streaming is not supported with 'n' > 1")
            results, err = await self._batch(engine, [prompt] * n, gen)
            if err is not None:
                return err
            return json_response({
                "id": rid, "object": "chat.completion", "created": created,
                "model": model_label,
                "choices": [{"index": i, "logprobs": None,
                             "finish_reason": r["finish_reason"],
                             "message": {"role": "assistant", "content": r["text"]}}
                            for i, r in enumerate(results)],
                "usage": self._batch_usage(results),
            })

        def chunk_bytes(delta: dict, finish: str | None,
                        logprobs: dict | None = None) -> bytes:
            chunk = {"id": rid, "object": "chat.completion.chunk",
                     "created": created, "model": model_label,
                     "choices": [{"index": 0, "delta": delta, "logprobs": logprobs,
                                  "finish_reason": finish}]}
            return f"data: {json.dumps(chunk)}\n\n".encode()

        if body.get("stream"):
            def write_event(ev):
                if ev.kind == "token":
                    lp_obj = None
                    if gen.logprobs is not None and ev.data and "id" in ev.data:
                        lp_obj = self._chat_lp(engine, [ev.data], gen.logprobs)
                    return chunk_bytes({"content": ev.content}, None, lp_obj)
                if ev.kind == "done":
                    return chunk_bytes({}, (ev.data or {}).get("finish_reason", "length"))
                return None

            # the role chunk leads, even before a zero-token completion
            return await self._stream(
                request, engine, prompt, gen,
                _WithPrologue(chunk_bytes({"role": "assistant", "content": ""}, None),
                              write_event),
                epilogue=b"data: [DONE]\n\n")

        text, final, tok_data = await self._collect(engine, prompt, gen)
        if "error" in final:
            return self._openai_error(final["error"], status=final.get("status", 500),
                                      headers=_retry_headers(final))
        lp_obj = (self._chat_lp(engine, tok_data, gen.logprobs)
                  if gen.logprobs is not None else None)
        return json_response({
            "id": rid, "object": "chat.completion", "created": created,
            "model": model_label,
            "choices": [{"index": 0, "logprobs": lp_obj,
                         "finish_reason": final.get("finish_reason", "length"),
                         "message": {"role": "assistant", "content": text}}],
            "usage": self._usage(final),
        })


class _WithPrologue:
    """An event writer that puts fixed bytes before its first payload."""

    def __init__(self, prologue: bytes, inner):
        self.prologue = prologue
        self.inner = inner

    def __call__(self, ev):
        payload = self.inner(ev)
        if payload is None:
            return None
        out, self.prologue = self.prologue + payload, b""
        return out
