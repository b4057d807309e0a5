"""The SSE chat server: ``POST /chat`` and the completion routes, on the
engine or the slot scheduler.

The counterpart of ``distributed_llm_pipeline_tpu/serving/server.py`` on its
default path and on ``--parallel N``. ``POST /chat`` with JSON
``{"prompt": ...}`` answers ``text/event-stream`` events
``data: {"msg_type": "log"|"token", "content": ...}``, closed by the
``done`` summary (sent as a ``log`` with ``finish_reason`` and ``n_gen``);
``OPTIONS /chat`` answers CORS preflight, ``GET /healthz`` reports the model,
the queue and the slots, and ``GET /`` serves the web UI. The llama-server
and OpenAI routes (``/completion``, ``/v1/completions``,
``/v1/chat/completions`` and their utilities) are ``openai.CompletionAPI``'s.

With ``--parallel 1`` (the default) requests take the one decode stream in
turn through an asyncio lock, writing SSE keep-alives while they wait. With
``--parallel N`` (llama-server's ``-np``) they stream from a
:class:`SlotScheduler` with N slots, decoding together in one batched step.

With ``--mesh PPxTP`` (e.g. ``2x2``) the model is served by a
:class:`ShardedEngine`: pp pipeline stages of tp tensor-parallel ranks, one
process per rank; this process is rank 0 and starts the others. ``/chat``
streams from rank 0, one stream or ``--parallel N`` slots.

Run: ``dlp-serve-torch --model m.gguf [--parallel N] [--quant MODE]
[--kv-quant q8_0] [--mesh PPxTP] [--dtype D] [--cpu] [--config FILE]`` or
``python -m distributed_llm_pipeline_tpu_torch.serving.server ...`` (port
3005 by default; settings also from a JSON/TOML ``--config`` file and
``DLP_*`` variables, flags winning). Without ``--cpu`` it needs a CUDA
device. ``--quant``
takes the reference's choices: int8, q8_0, q2_k, q3_k, q4_k, q5_k, q6_k or
native; ``--kv-quant q8_0`` keeps the KV cache in int8. As in the reference,
``DLP_FUSED_DECODE=1`` runs the slots' decode steps through the fused
decode-step kernel and ``DLP_KV_LATENT=1`` (rank ``DLP_KV_LATENT_RANK``)
caches latents instead of per-head K/V.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import sys
import threading
from dataclasses import replace
from pathlib import Path

from aiohttp import web

from ..config import DTYPES, config_from_args, torch_dtype
from ..models.llama import QUANT_MODES
from ..runtime import Engine, GenerationConfig, SlotScheduler
from ..runtime.engine import check_token_ids
from .common import (acquire_with_keepalive, cors, engine_events,
                     json_response, sse_response)
from .openai import CompletionAPI

STATIC_DIR = Path(__file__).parent / "static"

# request-body fields a client may override per request (plus "stop"), as
# the reference's /chat takes them
_OVERRIDES = ("max_new_tokens", "temperature", "top_k", "top_p", "min_p",
              "repeat_penalty", "repeat_last_n", "seed")


class ChatServer:
    def __init__(self, engine: Engine, gen: GenerationConfig | None = None,
                 parallel: int = 1, model_id: str = "default"):
        self.engine = engine
        self.gen = gen or GenerationConfig()
        self._busy = asyncio.Lock()
        # --parallel N: continuous batching over N decode slots
        self.scheduler = (SlotScheduler(engine, n_slots=parallel)
                          if parallel > 1 else None)
        self.app = web.Application()
        self.app.router.add_post("/chat", self.chat)
        self.app.router.add_options("/chat", self.preflight)
        self.app.router.add_get("/healthz", self.healthz)
        self.app.router.add_get("/", self.index)
        self.api = CompletionAPI(engine, self._busy, self.gen, model_id=model_id,
                                 slots=self.scheduler)
        self.api.register(self.app)
        self.app.router.add_static("/", STATIC_DIR, show_index=False)
        if self.scheduler is not None:
            async def close_scheduler(app):
                self.scheduler.close()

            self.app.on_cleanup.append(close_scheduler)

    async def preflight(self, request: web.Request) -> web.Response:
        return cors(web.Response())

    async def healthz(self, request: web.Request) -> web.Response:
        eng = self.engine
        sched = self.scheduler
        if sched is not None:
            load = {"queue_depth": sched.queue_depth,
                    "slots_active": sched.slots_active,
                    "slots_total": sched.n_slots,
                    "fused_decode": sched.fused_decode}
        else:
            load = {"queue_depth": 0, "slots_active": int(self._busy.locked()),
                    "slots_total": 1}
        return json_response({"status": "ok", "model": eng.cfg.arch,
                              "n_layers": eng.cfg.n_layers, "ctx": eng.max_seq,
                              "device": str(eng.device),
                              "kv_quant": eng.kv_quant, "kv_mode": eng.kv_mode,
                              "busy": self._busy.locked(), **load})

    async def index(self, request: web.Request) -> web.FileResponse:
        return web.FileResponse(STATIC_DIR / "index.html")

    def _gen_for(self, body) -> GenerationConfig | str:
        """The request's generation config, or the client-facing error."""
        overrides = {k: body[k] for k in _OVERRIDES if k in body}
        stop = body.get("stop")
        if isinstance(stop, str):
            overrides["stop"] = (stop,)
        elif isinstance(stop, list):
            if not all(isinstance(s, str) for s in stop):
                return "'stop' entries must be strings"
            overrides["stop"] = tuple(stop)
        elif stop is not None:
            return "'stop' must be a string or list of strings"
        return replace(self.gen, **overrides)

    async def chat(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
            prompt = body["prompt"]
        except (json.JSONDecodeError, KeyError, TypeError):
            return json_response({"error": "body must be JSON {\"prompt\": ...}"},
                                 status=400)
        # a string, or pre-tokenized ids as the reference's engine takes them
        if not (isinstance(prompt, str) or (
                isinstance(prompt, list) and prompt
                and all(type(t) is int for t in prompt))):
            return json_response(
                {"error": "'prompt' must be a string or a list of token ids"},
                status=400)
        if isinstance(prompt, list):
            try:
                check_token_ids(prompt, self.engine.cfg.vocab_size)
            except ValueError as e:
                return json_response({"error": f"'prompt': {e}"}, status=400)
        gen = self._gen_for(body)
        if isinstance(gen, str):
            return json_response({"error": gen}, status=400)
        resp = await sse_response(request)
        # the slot scheduler batches concurrent requests itself; the
        # single-stream engine takes them in turn under the decode lock
        locked = self.scheduler is None
        if locked and not await acquire_with_keepalive(self._busy, resp):
            return resp  # client gave up while queued; lock not held
        target = self.engine if locked else self.scheduler
        abort = threading.Event()
        try:
            # aclosing: a break closes the generator (joining the engine
            # thread) before the decode lock is released below
            async with contextlib.aclosing(
                    engine_events(target, prompt, gen, abort)) as events:
                async for ev in events:
                    try:
                        await resp.write(
                            b": keep-alive\n\n" if ev is None else
                            f"data: {ev.sse_json()}\n\n".encode())
                    except (ConnectionResetError, asyncio.CancelledError):
                        abort.set()
                        break
        finally:
            abort.set()
            if locked:
                self._busy.release()
        try:
            await resp.write_eof()
        except ConnectionResetError:
            pass
        return resp


def build_argparser():
    import argparse

    ap = argparse.ArgumentParser(prog="dlp-serve-torch",
                                 description="LLM pipeline chat server (PyTorch/CUDA)")
    ap.add_argument("--model", default=None, help="GGUF model file")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=3005)
    ap.add_argument("--ctx-size", type=int, default=2048)
    ap.add_argument("--n-predict", type=int, default=200)
    ap.add_argument("--parallel", "-np", type=int, default=1, metavar="N",
                    help="decode slots with continuous batching "
                         "(llama-server -np)")
    ap.add_argument("--quant", default=None, choices=QUANT_MODES,
                    help="keep the weights quantized on the device: int8 / "
                         "q8_0 / q2_k / q3_k / q4_k / q5_k / q6_k repack at "
                         "load, native serves the GGUF's own Q8_0 / Q2_K / "
                         "Q3_K / Q4_K / Q5_K / Q6_K blocks")
    ap.add_argument("--kv-quant", default=None, choices=["q8_0"],
                    help="int8 KV cache and slot pools (llama.cpp -ctk/-ctv "
                         "q8_0)")
    ap.add_argument("--mesh", default=None,
                    help="stages x chips, e.g. 2x1 (pp x tp ranks, one process "
                         "each)")
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES,
                    help="weight and activation dtype")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def build_engine(args) -> Engine:
    """The engine the parsed arguments (or an ``AppConfig``) ask for: a
    ShardedEngine with ``--mesh``, else the single-device Engine."""
    kw = dict(max_seq=args.ctx_size, device="cpu" if args.cpu else None,
              quant=args.quant, kv_quant=args.kv_quant,
              dtype=torch_dtype(args.dtype))
    if args.mesh:
        from ..parallel import MeshSpec, ShardedEngine

        return ShardedEngine(args.model, mesh_spec=MeshSpec.parse(args.mesh), **kw)
    return Engine(args.model, **kw)


def main(argv: list[str] | None = None) -> None:
    try:
        cfg, _ = config_from_args(argv, build_argparser)
        model = cfg.require_model()
        cfg.validate()
        engine = build_engine(cfg)
    except (NotImplementedError, ValueError) as e:   # an unserved mode or model
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    try:
        # the config's seed is not a server-wide default: every request with
        # the same prompt would give the same text
        gen = GenerationConfig(max_new_tokens=cfg.n_predict,
                               temperature=cfg.temperature, top_k=cfg.top_k,
                               top_p=cfg.top_p)
        server = ChatServer(engine, gen, parallel=cfg.parallel,
                            model_id=Path(model).stem)
        print(f"chat server listening on http://{cfg.host}:{cfg.port}", flush=True)
        web.run_app(server.app, host=cfg.host, port=cfg.port, print=None)
    finally:
        if cfg.mesh:
            engine.close()


if __name__ == "__main__":
    main()
