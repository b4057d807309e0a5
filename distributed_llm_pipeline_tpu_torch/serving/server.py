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

The server holds a :class:`ModelRegistry` (``serving/supervisor.py``): the
startup model (with ``--lora`` adapters merged at load) is pinned, and
``POST /models/load`` ``{id, path, mesh?, ctx?}`` / ``POST /models/unload``
``{id}`` add and drop others (at most ``--max-models``, LRU-evicted) that
requests pick by their ``model`` field; ``GET /models`` lists them with
their health. Each model is a :class:`SupervisedEngine`: a crash
mid-generation reloads it and retries the request once. ``GET /metrics``
serves the shared metrics registry as Prometheus text, or JSON under
``Accept: application/json``, with the perf monitor's gauges refreshed at
scrape time.

The observability routes: ``GET /debug/trace`` lists the request traces in
the ring (``?id=req-…`` gives one as Chrome / Perfetto trace-event JSON,
``?fleet=`` every trace recorded under a router's fleet id);
``GET /debug/perf`` is the perf monitor's snapshot (the roofline on the
card's peaks, step-time rings, build counters) with the built CUDA
kernels' static table; ``POST /debug/profile {steps?, timeout_s?}`` runs
``torch.profiler`` around the next N device steps and answers the top CUDA
kernels, joining device spans onto the traces of the requests it saw.
``--profile-dir DIR`` profiles every request instead. ``/chat`` and the
completion routes stamp a propagated ``X-DLP-Trace`` context on the trace.

Run: ``dlp-serve-torch --model m.gguf [--parallel N] [--quant MODE]
[--kv-quant q8_0] [--lora GGUF[=SCALE],...] [--max-models N] [--mesh PPxTP]
[--dtype D] [--slot-save-path DIR] [--pooling mean|cls|last]
[--profile-dir DIR] [--cpu] [--config FILE]`` or
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

from ..config import DTYPES, config_from_args, lora_list, torch_dtype
from ..models.llama import POOLING_TYPES, QUANT_MODES
from ..parallel.mesh import MeshSpec
from ..runtime import Engine, GenerationConfig, SlotScheduler
from ..runtime.engine import check_token_ids
from ..utils import TRACE_HEADER, TRACER, parse_trace_context, serving_identity
from .common import (acquire_with_keepalive, cors, engine_events,
                     json_response, priority_error, shed_response, sse_response)
from .openai import CompletionAPI
from .supervisor import ModelRegistry, SupervisedEngine

STATIC_DIR = Path(__file__).parent / "static"

# request-body fields a client may override per request (plus "stop"), as
# the reference's /chat takes them
_OVERRIDES = ("max_new_tokens", "temperature", "top_k", "top_p", "min_p",
              "repeat_penalty", "repeat_last_n", "seed", "deadline_ms",
              "priority")


class ChatServer:
    def __init__(self, engine: Engine, gen: GenerationConfig | None = None,
                 parallel: int = 1, model_id: str = "default",
                 slot_save_path: str | None = None, pooling: str = "mean",
                 registry: ModelRegistry | None = None):
        # without a registry the engine is the only model, supervised by a
        # wrapper whose restart reuses it
        self.registry = registry or ModelRegistry(model_id, engine)
        self.engine = self.registry.get()   # the supervised default model
        self.gen = gen or GenerationConfig()
        self._busy = asyncio.Lock()
        # --parallel N: continuous batching over N decode slots, for the
        # default model; other models take the decode lock
        self.scheduler = (SlotScheduler(self.engine, n_slots=parallel)
                          if parallel > 1 else None)
        self.app = web.Application()
        self.app.router.add_post("/chat", self.chat)
        self.app.router.add_options("/chat", self.preflight)
        self.app.router.add_get("/healthz", self.healthz)
        self.app.router.add_get("/metrics", self.metrics)
        self.app.router.add_get("/debug/trace", self.debug_trace)
        self.app.router.add_get("/debug/perf", self.debug_perf)
        self.app.router.add_post("/debug/profile", self.debug_profile)
        self.app.router.add_get("/models", self.models_list)
        self.app.router.add_post("/models/load", self.models_load)
        self.app.router.add_post("/models/unload", self.models_unload)
        self.app.router.add_get("/", self.index)
        self.api = CompletionAPI(self.registry, self._busy, self.gen,
                                 model_id=model_id, slots=self.scheduler,
                                 slot_save_path=slot_save_path, pooling=pooling)
        self.api.register(self.app)
        self.app.router.add_static("/", STATIC_DIR, show_index=False)
        if self.scheduler is not None:
            async def close_scheduler(app):
                self.scheduler.close()

            self.app.on_cleanup.append(close_scheduler)

    async def preflight(self, request: web.Request) -> web.Response:
        return cors(web.Response())

    async def healthz(self, request: web.Request) -> web.Response:
        models = self.registry.health()
        ok = all(h["status"] == "healthy" for h in models.values())
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
        return json_response({"status": "ok" if ok else "degraded",
                              "model": eng.cfg.arch,
                              "n_layers": eng.cfg.n_layers, "ctx": eng.max_seq,
                              "device": str(eng.device),
                              "kv_quant": eng.kv_quant, "kv_mode": eng.kv_mode,
                              "busy": self._busy.locked(), **load,
                              "models": models})

    # -- the model registry -------------------------------------------------

    async def models_list(self, request: web.Request) -> web.Response:
        return json_response({"default": self.registry.default_id,
                              "models": self.registry.health()})

    async def models_load(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            model_id, path = body["id"], body["path"]
        except (json.JSONDecodeError, KeyError, TypeError):
            return json_response(
                {"error": "body must be JSON {id, path, mesh?, ctx?}"}, status=400)
        # parameters are validated before any engine work: a malformed ctx
        # or mesh is the client's 400, not a 409 or a 500
        try:
            ctx = int(body.get("ctx", 2048))
            if ctx <= 0:
                raise ValueError(f"ctx must be positive, got {ctx}")
            mesh = body.get("mesh")
            if mesh is not None:
                MeshSpec.parse(str(mesh))
        except (ValueError, TypeError) as e:
            return json_response({"error": f"invalid parameters: {e}"}, status=400)
        try:
            # building an engine blocks (GGUF load, host packing, placement):
            # off the loop. The streams served meanwhile stall while it
            # parses the GGUF's metadata and builds its tokenizer (pure
            # Python, holding the interpreter lock)
            sup = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.registry.load(model_id, path, mesh, ctx))
        except NotImplementedError as e:
            # a recognized combination the engine does not serve
            return json_response({"error": str(e)}, status=400)
        except (ValueError, RuntimeError) as e:
            return json_response({"error": str(e)}, status=409)
        except Exception as e:
            return json_response({"error": repr(e)}, status=500)
        return json_response({"loaded": model_id, "n_layers": sup.cfg.n_layers,
                              "ctx": sup.max_seq})

    async def models_unload(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            model_id = body["id"]
        except (json.JSONDecodeError, KeyError, TypeError):
            return json_response({"error": "body must be JSON {id}"}, status=400)
        try:
            self.registry.unload(model_id)
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)
        except RuntimeError as e:
            # requests still stream from it: the client retries
            return json_response({"error": str(e)}, status=409)
        return json_response({"unloaded": model_id})

    async def metrics(self, request: web.Request) -> web.Response:
        """The shared metrics registry, every model's traffic: Prometheus
        text by default, JSON under ``Accept: application/json``. The
        queue and slot gauges and the perf monitor's rolling-window gauges
        and build counters are refreshed at scrape time."""
        m = self.registry.metrics
        m.set_gauge("busy", 1.0 if self._busy.locked() else 0.0)
        if self.scheduler is not None:
            self.scheduler._export_queue_gauges()
        perf = getattr(self.engine, "perf", None)
        if perf:
            perf.export_gauges(m)
        if "application/json" in request.headers.get("Accept", ""):
            return json_response(m.snapshot())
        return cors(web.Response(text=m.render_prometheus(),
                                 content_type="text/plain"))

    async def debug_trace(self, request: web.Request) -> web.Response:
        """``GET /debug/trace``: newest-first summaries of the trace ring;
        ``?id=req-…``: that request's Chrome / Perfetto trace-event JSON;
        ``?fleet=…``: every trace recorded under that fleet id, with this
        process's clock anchor and identity, for a router's aggregator."""
        fleet = request.query.get("fleet")
        if fleet:
            return json_response({**TRACER.export_fleet(fleet),
                                  **serving_identity()})
        rid = request.query.get("id")
        if rid:
            data = TRACER.export(rid)
            if data is None:
                return json_response(
                    {"error": f"no trace for request id {rid!r} (evicted "
                              f"from the ring, or tracing is disabled)"},
                    status=404)
            return json_response(data)
        return json_response({"enabled": TRACER.enabled,
                              "capacity": TRACER.capacity,
                              "epoch_ns": TRACER.epoch_ns,
                              "requests": TRACER.requests()})

    async def debug_perf(self, request: web.Request) -> web.Response:
        """``GET /debug/perf``: the perf monitor's snapshot (the roofline
        model's inputs with the peaks' sources, each backend's step-time
        ring, the build counters) and ``kernels_static``: each built CUDA library's kernels with their
        registers, shared memory and spills (empty on the CPU or before a
        build). The mesh's collective summary is not ported: ``comms``
        says so."""
        from ..ops.cuda_build import kernel_static_table

        perf = getattr(self.engine, "perf", None)
        body = perf.snapshot() if perf is not None else {"enabled": False}
        body["kernels_static"] = kernel_static_table()
        if hasattr(self.engine, "mesh_spec"):
            body["comms"] = {"note": "the mesh's per-step collective summary "
                                     "is not ported yet (ROADMAP.md §1)"}
        return json_response(body)

    async def debug_profile(self, request: web.Request) -> web.Response:
        """``POST /debug/profile`` ``{steps?, timeout_s?, top_k?}``: run
        ``torch.profiler`` (CPU + CUDA) around the next N recorded device
        steps of the live process, then answer the run's summary (per-device
        busy time, the ``top_k`` CUDA kernels by device time, 10 unless
        asked) and join its device timelines onto the request traces that
        ran inside the window."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}
        if not isinstance(body, dict):
            return json_response(
                {"error": "body must be a JSON object {steps?, timeout_s?, top_k?}"},
                status=400)
        try:
            steps = int(body.get("steps", 4))
            timeout_s = float(body.get("timeout_s", 30.0))
            top_k = int(body.get("top_k", 10))
            if not (1 <= steps <= 10000 and 0.1 <= timeout_s <= 600
                    and 1 <= top_k <= 100):
                raise ValueError
        except (TypeError, ValueError):
            return json_response(
                {"error": "'steps' must be 1..10000, 'timeout_s' 0.1..600 and "
                          "'top_k' 1..100"}, status=400)
        perf = getattr(self.engine, "perf", None)
        if not perf:
            return json_response(
                {"error": "perf monitoring is disabled or unavailable "
                          "(DLP_PERF=0?)"}, status=409)
        if self.engine.profile_dir:
            return json_response(
                {"error": "per-request profiling is already active "
                          "(--profile-dir); on-demand profiling needs the "
                          "profiler idle"}, status=409)

        # the profiler starts and stops on this (the loop's) thread, the one
        # torch registered its profiler client on; only the wait for the
        # steps runs in an executor. Its CUDA activity covers every thread's
        # kernels; its CPU operators are this thread's alone
        try:
            session = perf.arm_profile(steps)
        except (RuntimeError, ValueError) as e:
            # already armed, or the profiler refused to start
            return json_response({"error": str(e)}, status=409)
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, session.wait, timeout_s)
        finally:
            session.finish()   # idempotent: never leave the profiler on
        summary = session.summarize(top_k=top_k)
        summary["joined_request_ids"] = session.join_traces(TRACER)
        return json_response(summary)

    async def index(self, request: web.Request) -> web.FileResponse:
        return web.FileResponse(STATIC_DIR / "index.html")

    def _gen_for(self, body) -> GenerationConfig | str:
        """The request's generation config, or the client-facing error."""
        overrides = {k: body[k] for k in _OVERRIDES if k in body}
        if "priority" in overrides:
            err = priority_error(overrides["priority"])
            if err is not None:
                return err
            if overrides["priority"] is None:
                del overrides["priority"]   # null: the server's default
        if overrides.get("deadline_ms") is not None:
            try:
                overrides["deadline_ms"] = float(overrides["deadline_ms"])
                if overrides["deadline_ms"] <= 0:
                    raise ValueError
            except (TypeError, ValueError):
                return "'deadline_ms' must be a positive number"
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
        gen = self._gen_for(body)
        if isinstance(gen, str):
            return json_response({"error": gen}, status=400)
        try:
            engine = self.registry.get(body.get("model"))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        if isinstance(prompt, list):
            try:
                check_token_ids(prompt, engine.cfg.vocab_size)
            except ValueError as e:
                return json_response({"error": f"'prompt': {e}"}, status=400)
        # the slot scheduler batches concurrent requests to the default
        # model itself; an engine takes them in turn under the decode lock
        target, locked = self.api._target(engine, gen)
        # the tenant a quota charges: the X-DLP-Tenant header or the body's
        # field; only the slots keep quotas (the lock path serves one stream)
        tenant = request.headers.get("X-DLP-Tenant") or body.get("tenant")
        trace_ctx = parse_trace_context(request.headers.get(TRACE_HEADER))
        if not locked:
            shed = self.scheduler.shed_check(
                gen, prompt if isinstance(prompt, str) else None, tenant=tenant)
            if shed is not None:   # 429 / 503 / 400 with Retry-After
                return shed_response(shed)
        resp = await sse_response(request)
        if locked and not await acquire_with_keepalive(self._busy, resp):
            return resp  # client gave up while queued; lock not held
        abort = threading.Event()
        try:
            # aclosing: a break closes the generator (joining the engine
            # thread) before the decode lock is released below
            async with contextlib.aclosing(engine_events(
                    target, prompt, gen, abort,
                    tenant=None if locked else tenant,
                    trace_ctx=trace_ctx)) as events:
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
    ap.add_argument("--lora", default=None, metavar="GGUF[=SCALE],...",
                    help="LoRA adapter GGUF(s) merged at load, into the "
                         "startup model only")
    ap.add_argument("--max-models", type=int, default=2,
                    help="bound on concurrently loaded models (LRU eviction)")
    ap.add_argument("--mesh", default=None,
                    help="stages x chips, e.g. 2x1 (pp x tp ranks, one process "
                         "each)")
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES,
                    help="weight and activation dtype")
    ap.add_argument("--slot-save-path", default=None, metavar="DIR",
                    help="directory for POST /slots/{id}?action=save|restore "
                         "files (llama-server --slot-save-path)")
    ap.add_argument("--pooling", default="mean", choices=list(POOLING_TYPES),
                    help="embedding pooling type (llama-server --pooling)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler (Chrome) trace per request "
                         "and join it onto the request's trace")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def build_engine(args) -> Engine:
    """The engine the parsed arguments (or an ``AppConfig``) ask for: a
    ShardedEngine with ``--mesh``, else the single-device Engine, with the
    ``--lora`` adapters merged at load. On the CUDA device unless ``--cpu``."""
    kw = dict(max_seq=args.ctx_size, device="cpu" if args.cpu else None,
              quant=args.quant, kv_quant=args.kv_quant,
              dtype=torch_dtype(args.dtype), lora=lora_list(args.lora))
    if args.mesh:
        from ..parallel import MeshSpec, ShardedEngine

        return ShardedEngine(args.model, mesh_spec=MeshSpec.parse(args.mesh), **kw)
    return Engine(args.model, **kw)


def load_engine(cfg, path: str, mesh: str | None, ctx: int) -> Engine:
    """The registry's loader (``POST /models/load``): the startup settings
    with the request's model, mesh and context, and no adapters (``--lora``
    is the startup model's alone, as in llama-server)."""
    return build_engine(replace(cfg, model=path, mesh=mesh, ctx_size=ctx, lora=None))


def main(argv: list[str] | None = None) -> None:
    try:
        cfg, _ = config_from_args(argv, build_argparser)
        model = cfg.require_model()
        cfg.validate()
        default = SupervisedEngine(lambda: build_engine(cfg))
    except (NotImplementedError, ValueError) as e:   # an unserved mode or model
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    default.profile_dir = cfg.profile_dir
    model_id = Path(model).stem
    registry = ModelRegistry(
        model_id, default,
        loader=lambda mid, path, mesh, ctx: load_engine(cfg, path, mesh, ctx),
        max_models=cfg.max_models)
    try:
        # the config's seed is not a server-wide default: every request with
        # the same prompt would give the same text
        gen = GenerationConfig(max_new_tokens=cfg.n_predict,
                               temperature=cfg.temperature, top_k=cfg.top_k,
                               top_p=cfg.top_p)
        server = ChatServer(default, gen, parallel=cfg.parallel,
                            model_id=model_id, registry=registry,
                            slot_save_path=cfg.slot_save_path, pooling=cfg.pooling)
        print(f"chat server listening on http://{cfg.host}:{cfg.port}", flush=True)
        web.run_app(server.app, host=cfg.host, port=cfg.port, print=None)
    finally:
        for mid in registry.ids():
            close = getattr(registry.get(mid).engine, "close", None)
            if close is not None:   # a mesh ends its follower ranks
                close()


if __name__ == "__main__":
    main()
