"""The llama-server and OpenAI completion routes, on the port's engine.

The counterpart of ``distributed_llm_pipeline_tpu/serving/openai.py``:

- ``POST /completion``            llama-server: {prompt, n_predict, n_probs, ...}
- ``POST /v1/completions``        OpenAI text completion (+ SSE streaming)
- ``POST /v1/chat/completions``   OpenAI chat (+ SSE streaming)
- ``GET  /v1/models``             the one loaded model
- ``POST /tokenize``, ``POST /detokenize``, ``POST /apply-template``,
  ``GET /props``, ``GET /health``, ``GET /slots``: llama-server's utilities

A request decodes in the slot scheduler's shared batch when the server has
one (``--parallel N``), except typical-p and mirostat requests, which run on
the engine as one stream under the decode lock, as every request does
without slots. Usage counts come from the engine's ``done`` event.

The server holds one model: ``model`` may name it or be left out, and any
other name is a 404. Fields and routes of the reference that the port does
not serve yet (constrained decoding, LoRA, context shift, priority,
deadlines, batches of prompts, infill, embeddings, slot save and restore)
get a 400 that names them; none is ignored.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import threading
import time
import uuid

from aiohttp import web

from ..runtime import GenerationConfig
from ..runtime.scheduler import LP_TOPK
from .chat_template import ChatTemplateError, render_chat_template
from .chat_template import _text_of as text_of
from .common import (acquire_with_keepalive, cors, engine_events, json_response,
                     sse_response)

# request fields of the reference the port does not serve yet, each with the
# values that ask for nothing (a client may send those)
_NOT_SERVED = {"grammar": (None, ""), "json_schema": (None,), "lora": (None, []),
               "context_shift": (None, False), "n_keep": (None, 0),
               "priority": (None, "normal"), "deadline_ms": (None,)}


def not_served(what: str) -> str:
    return f"{what} is not yet served by the PyTorch/CUDA port"


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
    its engine, its decode lock and its slot scheduler (None without
    ``--parallel``)."""

    def __init__(self, engine, busy: asyncio.Lock, gen: GenerationConfig,
                 model_id: str = "default", slots=None):
        self.engine = engine
        self._busy = busy
        self.gen = gen
        self.model_id = model_id
        self.slots = slots

    def _resolve(self, body: dict):
        """The engine and model label for a body's ``model`` field."""
        mid = body.get("model")
        if mid is not None and not isinstance(mid, str):
            raise BadRequest(f"'model' must be a string, got {mid!r}")
        if mid and mid != self.model_id:
            # the reference's registry message, a KeyError's text
            raise ModelNotFound(str(KeyError(
                f"model {mid!r} is not loaded (loaded: {[self.model_id]})")))
        return self.engine, (mid or self.model_id)

    def register(self, app: web.Application) -> None:
        for path in ("/completion", "/v1/completions", "/v1/chat/completions"):
            app.router.add_options(path, self._preflight)
        app.router.add_post("/completion", self.completion)
        app.router.add_post("/v1/completions", self.v1_completions)
        app.router.add_post("/v1/chat/completions", self.v1_chat)
        app.router.add_get("/v1/models", self.v1_models)
        app.router.add_post("/tokenize", self.tokenize)
        app.router.add_post("/detokenize", self.detokenize)
        app.router.add_post("/apply-template", self.apply_template)
        app.router.add_get("/props", self.props)
        app.router.add_get("/health", self.health)
        app.router.add_get("/slots", self.slots_handler)
        for method, path in (("POST", "/infill"), ("POST", "/embedding"),
                             ("POST", "/v1/embeddings"), ("POST", "/slots/{slot_id}"),
                             ("GET", "/lora-adapters")):
            app.router.add_route(method, path, self._not_served)

    async def _not_served(self, request: web.Request) -> web.Response:
        path = request.match_info.route.resource.canonical
        return json_response({"error": not_served(f"'{path}'")}, status=400)

    # -- shared plumbing ----------------------------------------------------

    def _target(self, engine, gen: GenerationConfig):
        """(target, needs_lock): the slot scheduler, without the lock, when
        the server has one, except for sampled typical-p and mirostat
        requests (per-request entropy filtering and μ state are not in the
        batched row sampler); else the engine under the decode lock."""
        single = gen.temperature > 0.0 and (gen.typical_p < 1.0 or bool(gen.mirostat))
        if self.slots is not None and not single:
            return self.slots, False
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
                if "error" in d:
                    chunk["error"] = d["error"]
            else:
                return None
            return f"data: {json.dumps(chunk)}\n\n".encode()

        return write_event

    def _llama_final(self, engine, gen: GenerationConfig, text: str,
                     final: dict, tok_data: list[dict]) -> web.Response:
        if "error" in final:
            return json_response({"error": final["error"]},
                                 status=final.get("status", 500))
        extra = {}
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
        field the port does not serve yet."""
        g = self.gen
        for k, neutral in _NOT_SERVED.items():
            v = body.get(k)
            if not any(v is n or v == n for n in neutral):
                raise BadRequest(not_served(f"'{k}'"))
        rf = body.get("response_format")
        if rf is not None:
            if not (isinstance(rf, dict) and rf.get("type") in
                    ("json_object", "text", "json_schema")):
                raise BadRequest(
                    "response_format must be {'type': 'json_object'}, "
                    "{'type': 'text'} or {'type': 'json_schema', "
                    "'json_schema': {...}}")
            if rf["type"] != "text":
                raise BadRequest(not_served(f"'response_format' {rf['type']!r}"))

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
        miro = take(("mirostat",), int, g.mirostat)
        temp = take(("temperature",), float, g.temperature)
        if lp is not None and miro and temp > 0.0:
            raise BadRequest("logprobs does not combine with mirostat")
        return GenerationConfig(
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
            logprobs=lp,
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
    def _openai_error(msg: str, status: int = 400) -> web.Response:
        err_type = "invalid_request_error" if status < 500 else "server_error"
        return json_response({"error": {"message": msg, "type": err_type}},
                             status=status)

    async def _collect(self, engine, prompt, gen: GenerationConfig
                       ) -> tuple[str, dict, list[dict]]:
        """Run to completion: (text, the done event's data, the token
        events' data, each stamped with its offset in the text)."""
        target, lock = self._target(engine, gen)
        abort = threading.Event()
        text: list[str] = []
        final: dict = {}
        tok_data: list[dict] = []
        emitted = 0
        async with contextlib.AsyncExitStack() as stack:
            if lock:
                await stack.enter_async_context(self._busy)
            async with contextlib.aclosing(
                    engine_events(target, prompt, gen, abort)) as events:
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
        maps an engine event to bytes (or None to skip it)."""
        target, lock = self._target(engine, gen)
        resp = await sse_response(request)
        if lock and not await acquire_with_keepalive(self._busy, resp):
            return resp
        abort = threading.Event()
        broke = False
        try:
            async with contextlib.aclosing(
                    engine_events(target, prompt, gen, abort)) as events:
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
        text, final, tok_data = await self._collect(engine, body["prompt"], gen)
        return self._llama_final(engine, gen, text, final, tok_data)

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

    async def props(self, request: web.Request) -> web.Response:
        g, eng = self.gen, self.engine
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
        """llama-server's ``GET /health``: the model is loaded once the
        server answers."""
        return json_response({"status": "ok"})

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
            {"id": self.model_id, "object": "model", "created": int(time.time()),
             "owned_by": "distributed_llm_pipeline_tpu_torch"}]})

    @staticmethod
    def _check_n(body: dict) -> str | None:
        """The client error of an ``n`` field, or None: n > 1 (several
        completions as one batch) is not served yet."""
        n = body.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 64:
            return "'n' must be an int in [1, 64]"
        if n > 1:
            return not_served("'n' > 1")
        return None

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
        err = self._check_n(body)
        if err is None and isinstance(prompt, list):
            err = not_served("a list of several prompts")
        if err is not None:
            return self._openai_error(err)
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

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
            return self._openai_error(final["error"], status=final.get("status", 500))
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
        err = self._check_n(body)
        if err is not None:
            return self._openai_error(err)
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

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
            return self._openai_error(final["error"], status=final.get("status", 500))
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
