"""ShardedEngine: the Engine surface over a pp × tp mesh of processes.

The counterpart of ``distributed_llm_pipeline_tpu/parallel/engine.py`` in its
interactive mode (dp = 1): one stream through ``generate``, or N streams
through the slot scheduler's mesh backend. Rank 0 is this process: it holds
the tokenizer, the ``Engine`` API, the sampler, the head and stage 0's tp
rank 0. ``ShardedEngine`` starts ranks 1 … pp·tp − 1 as spawned followers
(``dist.spawn_followers``); each loads only its own shard of the GGUF's
weights (``load_rank``) and then serves commands.

A command is a small tuple that rank 0 sends down each follower's pipe
(``RankRuntime.run`` lists them): allocate a cache, run a pipelined
forward (token ids, each row's first position and the positions the head
needs), report or reset counters. Every rank then runs the same forward on
its shard; the collectives inside it carry the data (``dist.Comm``). The
commands travel over pipes, not a collective, so an idle follower waits
for the next request without a time limit, while every collective of a
forward has the process group's timeout. A follower that fails sends its
traceback up its pipe and exits; a rank that dies or hangs makes rank 0's
next collective or command raise, the mesh is then down, and every later
call raises at once: the stream in flight ends with an error event and the
next admission is refused. Nothing falls back to one process.

On CUDA, rank 0 builds the kernel libraries before it spawns, so the ranks
load one build instead of compiling it once each.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..gguf import GGUFReader
from ..models import ModelConfig
from ..models.convert import load_params, native_quant_layers, select_rope_factors
from ..models.llama import KVCache, check_kv_mode, check_quant, quantized_bytes, shift_kv
from ..ops import flash_attention as fa
from ..ops import quant_matmul as qm
from ..runtime import capabilities
from ..runtime.engine import Engine, GenerationConfig, _bucket, resolve_device
from ..runtime.paged import kv_token_bytes
from ..tokenizer import tokenizer_from_metadata
from ..utils import Metrics, log
from ..utils.perf import (make_perf_monitor, metrics_reader, model_flops_per_token,
                          params_nbytes)
from .balance import stage_spans
from .dist import TIMEOUT_S, Comm, connect, initialize, spawn_followers
from .mesh import Mesh, MeshSpec, placement
from .pipeline import (CHUNK, StageModel, check_ported, make_sharded_cache,
                       pipeline_forward, rank_params, stage_counts, validate_mesh)

# the commands whose result each follower sends back
_REPLY_OPS = frozenset({"stats", "profile"})
# the longest a follower may take from its start to loading its shard
LOAD_TIMEOUT_S = 1800.0


@dataclass
class Loaded:
    """One rank's model: its config, stage layout, model part, rank 0's
    tokenizer and load events."""
    cfg: ModelConfig
    counts: list[int]
    model: StageModel
    tokenizer: object = None
    events: list = None
    pack_s: float = 0.0
    nbytes: tuple[int, int] = (0, 0)   # quantized_bytes of the shard


def load_rank(model_path: str | Path, mesh: Mesh, *, max_seq: int | None,
              dtype: torch.dtype, quant: str | None,
              lora: list[tuple[str, float]] | None = None) -> Loaded:
    """Load one rank's shard of a GGUF: its stage's layers (and, on rank 0,
    the tokenizer, final norm and head; on stage 0 the embedding table),
    merged with the ``lora`` adapters, packed with ``quant`` when asked (the
    byte-code K-quant packs at tp > 1), split to its tp slice and moved to
    its device. The merge runs on the dense host weights before the split,
    so each rank holds its slice of the merged model."""
    spec, rank = mesh.spec, mesh.rank
    events, pack_s = [], 0.0
    with GGUFReader(model_path) as reader:
        cfg = ModelConfig.from_gguf_metadata(reader.metadata)
        eff_ctx = min(max_seq or cfg.max_seq_len, cfg.max_seq_len)
        cfg = select_rope_factors(reader, cfg, eff_ctx)
        validate_mesh(cfg, spec.pp, spec.tp, uneven_stages=True)
        check_ported(cfg, spec.tp)
        counts = stage_counts(cfg, spec.pp)
        lo, hi = stage_spans(counts)[mesh.stage]
        tokenizer = tokenizer_from_metadata(reader.metadata) if rank == 0 else None
        if rank == 0:
            n_quant = sum(1 for t in reader.tensors.values() if int(t.ggml_type) > 1)
            events.append(log(
                f"model load: {Path(model_path).name} arch={cfg.arch} "
                f"layers={cfg.n_layers} dim={cfg.dim} tensors={len(reader.tensors)} "
                f"({n_quant} quantized)"))

        def keep(key: str) -> bool:
            if key.startswith("layers."):
                return lo <= int(key.split(".")[1]) < hi
            return rank == 0 or (key == "embed" and mesh.stage == 0)

        packs = {}
        if quant == "native":
            t_q = time.monotonic()
            packs = native_quant_layers(reader, cfg, byte_codes=spec.tp > 1,
                                        layers=range(lo, hi))
            pack_s = time.monotonic() - t_q
            if not packs:
                raise ValueError("--quant native: this GGUF stores no projection "
                                 "weight stack the mesh serves packed")
        skip = frozenset(k.rsplit(".", 1)[1] for k in packs)
        params = load_params(reader, cfg, dtype=dtype, device="cpu", skip=skip, keep=keep)
        if lora:
            if quant == "native":
                raise ValueError(
                    "--lora merges into dense weights; --quant native "
                    "serves packed blocks — drop one of the two")
            from ..models.lora import apply_lora

            for line in apply_lora(params, cfg, list(lora), keep=keep):
                events.append(log(line))
        params.update(packs)
    t_q = time.monotonic()
    params = rank_params(params, cfg, spec.pp, spec.tp, rank, counts,
                         quant if quant != "native" else None)
    if quant and quant != "native":
        pack_s = time.monotonic() - t_q
    params = {k: t.to(mesh.device) for k, t in params.items()}
    return Loaded(cfg, counts, StageModel(cfg, params, spec.pp, spec.tp, rank, counts),
                  tokenizer, events, pack_s, quantized_bytes(params))


class RankRuntime:
    """What a rank does with a command: its model part, its caches and its
    collectives. The same object serves rank 0 (called by ``MeshModel``)
    and a follower (called from its pipe)."""

    def __init__(self, mesh: Mesh, loaded: Loaded, max_seq: int, dtype: torch.dtype):
        self.mesh = mesh
        self.comm = Comm(mesh)
        self.model = loaded.model
        self.cfg = loaded.cfg
        self.n_layers = max(loaded.counts)
        self.max_seq = min(max_seq or loaded.cfg.max_seq_len, loaded.cfg.max_seq_len)
        self.dtype = dtype
        self.caches: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._profiler = None

    @torch.inference_mode()
    def run(self, op: str, kw: dict):
        """``cache`` (name, batch): allocate (or replace) a named cache.
        ``forward`` (name, tokens, pos0, last, rows): one pipelined forward
        over rows [r0, r1) of that cache (all rows when None).
        ``shift`` (name, keep, drop, new_len): the context shift of that cache's
        stage layers (``models.llama.shift_kv``), in place.
        ``stats``: this process's kernel launch counters, the M of each
        chunk its blocks ran and of each call of its head, its packs by kind
        and the time in collectives; ``reset_stats`` zeroes them.
        ``profile`` (on): start or stop ``torch.profiler`` on this rank;
        stopping returns the device time and the kernel count it saw."""
        if op == "cache":
            self.caches[kw["name"]] = make_sharded_cache(
                self.cfg, self.n_layers, kw["batch"], self.max_seq, self.mesh.tp,
                self.dtype, self.mesh.device)
            return self.caches[kw["name"]]
        if op == "forward":
            k, v = self.caches[kw["name"]]
            if kw.get("rows") is not None:
                r0, r1 = kw["rows"]
                k, v = k[:, r0:r1], v[:, r0:r1]
            return pipeline_forward(self.model, self.mesh, self.comm, k, v,
                                    kw["tokens"], kw["pos0"], kw.get("last"))
        if op == "shift":
            k, v = self.caches[kw["name"]]
            shift_kv(KVCache(k, v), kw["keep"], kw["drop"], kw["new_len"], self.cfg)
            return None
        if op == "stats":
            packs: dict[str, int] = {}
            for blk in self.model.layers:
                for m in blk.children():
                    if isinstance(m, qm.QuantPack):
                        packs[m.kind] = packs.get(m.kind, 0) + 1
            return {"rank": self.mesh.rank, "layers": len(self.model.layers),
                    "packs": packs, "launches": dict(qm.launches),
                    "flash_attention": fa.launches,
                    "forward_ms": list(self.model.forward_ms),
                    "head_ms": list(self.model.head_ms),
                    "comm_s": self.comm.seconds, "comm_calls": self.comm.calls}
        if op == "profile":
            return self._profile(kw["on"])
        if op == "reset_stats":
            for name in qm.launches:
                qm.launches[name] = 0
            fa.launches = 0
            self.model.forward_ms.clear()
            self.model.head_ms.clear()
            self.comm.seconds, self.comm.calls = 0.0, 0
            return None
        raise ValueError(f"unknown mesh command {op!r}")

    def _profile(self, on: bool) -> dict | None:
        from torch.profiler import ProfilerActivity, profile

        if on:
            acts = [ProfilerActivity.CPU]
            if self.mesh.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
            return None
        prof, self._profiler = self._profiler, None
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        prof.__exit__(None, None, None)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"rank": self.mesh.rank, "kernels": len(kernels),
                "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}


def follower_main(conn, rank: int, port: int, spec: MeshSpec, model_path: str,
                  opts: dict) -> None:
    """A follower rank's process: join the group, load its shard, report
    ready, then run rank 0's commands until ``shutdown`` or until rank 0's
    end of the pipe closes. A failure goes up the pipe as ("error", text)."""
    try:
        device = torch.device(opts["devices"][rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(opts["threads"])
        connect(rank, spec.pp * spec.tp, port, opts["backend"])
        mesh = Mesh.build(spec, rank, device, opts["backend"])
        loaded = load_rank(model_path, mesh, max_seq=opts["max_seq"],
                           dtype=opts["dtype"], quant=opts["quant"],
                           lora=opts["lora"])
        rt = RankRuntime(mesh, loaded, opts["max_seq"], opts["dtype"])
        conn.send(("ready", rank))
        while True:
            op, kw = conn.recv()
            if op == "shutdown":
                break
            out = rt.run(op, kw)
            if op in _REPLY_OPS:
                conn.send(("ok", out))
    except EOFError:   # rank 0 is gone
        pass
    except BaseException:
        try:
            conn.send(("error", f"rank {rank}: {traceback.format_exc()}"))
        except OSError:
            pass
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@dataclass
class MeshCache:
    """Rank 0's handle on a cache that every rank holds its shard of:
    ``name`` names it in the commands, ``k``/``v`` are rank 0's buffers,
    ``length`` the valid positions (an int, or an int tensor [B])."""
    name: str
    k: torch.Tensor
    v: torch.Tensor
    length: int | torch.Tensor = 0


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)


class MeshModel:
    """Rank 0's handle on the pipelined model, called where ``Engine`` and
    the slot backend call ``LlamaModel``: each call sends its command to
    every follower, then runs rank 0's part and applies the head. One
    command runs at a time."""

    def __init__(self, rt: RankRuntime, followers: list):
        self.rt = rt
        self.stage = rt.model
        self.followers = followers
        self.broken: str | None = None
        self._closed = False
        self._lock = threading.Lock()

    def command(self, op: str, **kw):
        """Run ``op`` on every rank; returns rank 0's result, and for the
        ops that reply, [rank 0's, rank 1's, ...]. Raises, and leaves the
        mesh down, when any rank fails."""
        with self._lock:
            if self.broken is not None:
                raise RuntimeError(f"the mesh is down: {self.broken}")
            try:
                for _, conn in self.followers:
                    conn.send((op, kw))
                out = self.rt.run(op, kw)
                if op in _REPLY_OPS:
                    return [out] + [self._reply(conn) for _, conn in self.followers]
                return out
            except Exception as e:
                self.broken = f"{e!r}{follower_errors(self.followers)}"
                raise RuntimeError(f"mesh rank failure during {op!r}: "
                                   f"{self.broken}") from e

    @staticmethod
    def _reply(conn):
        if not conn.poll(TIMEOUT_S):
            raise TimeoutError("a mesh rank did not answer")
        kind, body = conn.recv()
        if kind != "ok":
            raise RuntimeError(body)
        return body

    # -- caches and forwards ------------------------------------------------

    def make_cache(self, name: str, batch: int) -> MeshCache:
        k, v = self.command("cache", name=name, batch=batch)
        return MeshCache(name, k, v)

    def hidden(self, name: str, tokens, pos0, last=None, rows=None) -> torch.Tensor:
        """The pipelined forward over cache ``name``: pre-norm hidden states
        on rank 0."""
        return self.command("forward", name=name, tokens=_host(tokens).astype(np.int64),
                            pos0=_host(pos0).astype(np.int64),
                            last=None if last is None else _host(last).astype(np.int64),
                            rows=rows)

    def _pos0(self, cache: MeshCache, B: int) -> np.ndarray:
        if isinstance(cache.length, torch.Tensor):
            return _host(cache.length).reshape(-1)
        return np.full(B, cache.length, np.int64)

    @torch.inference_mode()
    def __call__(self, tokens: torch.Tensor, cache: MeshCache) -> torch.Tensor:
        """tokens [B, T] → logits [B, T, V] f32; the tokens occupy positions
        [length, length + T) of each row; the length advances by T."""
        B, T = tokens.shape
        h = self.hidden(cache.name, tokens, self._pos0(cache, B))
        cache.length = cache.length + T
        return self.stage.lm_logits(h)

    @torch.inference_mode()
    def forward_last(self, tokens: torch.Tensor, cache: MeshCache,
                     last_index: int) -> torch.Tensor:
        """A prefill: logits of position ``last_index`` only ([B, V] f32)."""
        B, T = tokens.shape
        h = self.hidden(cache.name, tokens, self._pos0(cache, B),
                        np.full(B, last_index))
        cache.length = cache.length + T
        return self.stage.lm_logits(h)[:, 0]

    @torch.inference_mode()
    def forward_mixed(self, tokens: torch.Tensor, cache: MeshCache,
                      n_tok: torch.Tensor) -> torch.Tensor:
        """The mixed prefill + decode step: row b's first ``n_tok[b]`` lanes
        are real → logits [B, V] at each row's last real lane; the lengths
        advance by ``n_tok``. Padding lanes write junk KV past each row's
        length, masked and later overwritten; parked rows (at max_seq)
        write into the scratch tail."""
        B = tokens.shape[0]
        n = _host(n_tok).astype(np.int64)
        h = self.hidden(cache.name, tokens, self._pos0(cache, B), np.maximum(n - 1, 0))
        cache.length = cache.length + n_tok.to(cache.length.dtype)
        return self.stage.lm_logits(h)[:, 0]

    @torch.inference_mode()
    def prefill_row(self, name: str, r: int, tokens: np.ndarray, start: int,
                    last_index: int) -> torch.Tensor:
        """A prefill of ``tokens`` [1, T] into row r of cache ``name`` from
        position ``start``, in place: logits [1, V] of ``last_index``."""
        h = self.hidden(name, tokens, np.array([start]), np.array([last_index]),
                        rows=(r, r + 1))
        return self.stage.lm_logits(h)[:, 0]

    def shift(self, cache: MeshCache, keep: int, drop: int) -> None:
        """The context shift of ``cache`` on every rank, each over its own
        stage's layers and heads; the length drops by ``drop``."""
        self.command("shift", name=cache.name, keep=keep, drop=drop,
                     new_len=cache.length - drop)
        cache.length = cache.length - drop

    def stats(self) -> list[dict]:
        """Each rank's counters, rank 0 first."""
        return self.command("stats")

    def close(self) -> None:
        """Shut the followers down and leave the process group, once the
        command in flight (another thread's step) has returned. Once only:
        the group a later mesh of this process brings up is not this one's."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self.broken is None:
                self.broken = "closed"
            end_followers(self.followers)
            self.followers = []


def follower_errors(followers: list) -> str:
    """What the followers reported or how they exited, for an error
    message: the last line of each traceback sent up a pipe, each exit
    code."""
    notes = []
    for proc, conn in followers:
        try:
            while conn.poll(1.0):
                kind, body = conn.recv()
                if kind == "error":
                    notes.append(body.strip().splitlines()[-1])
        except (EOFError, OSError):
            pass
        if proc.exitcode is not None:
            notes.append(f"{proc.name} exited with code {proc.exitcode}")
    return "; " + "; ".join(notes) if notes else ""


def end_followers(followers: list) -> None:
    """Ask each follower to shut down, kill any that has not exited within
    10 s, and leave the process group."""
    for _, conn in followers:
        try:
            conn.send(("shutdown", {}))
        except OSError:
            pass
    for proc, conn in followers:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        conn.close()
    if dist.is_initialized():
        dist.destroy_process_group()


class MeshSlotBackend:
    """Slot KV over a :class:`ShardedEngine`'s pp × tp mesh (the reference's
    ``_MeshSlotBackend``): every rank holds dense pipeline-cache rows
    [Lp, B, max_seq + CHUNK, K/tp, Hd] of one named cache, and a step is one
    pipelined forward over all B rows with per-row lengths. A mixed step is
    one pipeline chunk wide (``max_mixed_width``), so rows parked at
    max_seq write inside the ``+ CHUNK`` scratch tail. A prefill runs on its
    own row of the cache in place; a row's retained prefix stays in it, so
    admission reuses the prefix ``_pick_slot`` found."""

    fused = False

    def __init__(self, eng, n_slots: int, max_seq: int):
        self.eng = eng
        self.B = n_slots
        self.S = max_seq
        self.max_mixed_width = CHUNK

    def alloc(self) -> dict:
        c = self.eng.model.make_cache("slots", self.B)
        return {"k": c.k, "v": c.v}

    @staticmethod
    def cache(bufs: dict, lengths: torch.Tensor):
        return MeshCache("slots", bufs["k"], bufs["v"], lengths)

    def vstep(self, tok: torch.Tensor, cache) -> torch.Tensor:
        return self.eng.model(tok[:, None], cache)[:, -1]

    def mstep(self, block: torch.Tensor, n_tok: torch.Tensor, cache) -> torch.Tensor:
        return self.eng.model.forward_mixed(block, cache, n_tok)

    def begin_prefill(self, sched, r: int, ids: list[int], reuse_k: int) -> int:
        return reuse_k

    def prefill_row(self, sched, r: int, ids: list[int], reuse_k: int,
                    ) -> tuple[torch.Tensor, int]:
        """Prefill the suffix ``ids[reuse_k:]``, padded to its bucket, into
        row r from position ``reuse_k``. Returns (logits [1, V], reuse_k)."""
        eng = sched.engine
        suffix = ids[reuse_k:]
        b = _bucket(len(suffix), eng.max_prompt, quantum=eng._prompt_quantum)
        padded = np.zeros((1, b), np.int64)
        padded[0, :len(suffix)] = suffix
        logits = eng.model.prefill_row("slots", r, padded, reuse_k, len(suffix) - 1)
        sched.forwards += 1
        sched.metrics.inc("prefill_tokens_total", b)
        return logits, reuse_k

    def prepare_chunk(self, sched, running, n) -> list[tuple[int, int]]:
        return []   # dense rows always have room

    def release_row(self, r: int) -> None:
        """Dense rows own their storage: a quarantined row has nothing to
        give back."""


class ShardedEngine(Engine):
    """``Engine`` over a pp × tp mesh (dp = 1) of one process per rank, on
    CUDA unless ``device="cpu"``. Each rank loads its own shard of the GGUF
    at ``model_path``; ``quant`` packs as ``Engine``'s does, with the
    byte-code K-quant packs on tp > 1 meshes. ``--kv-quant``, latent KV, MoE
    and dp > 1 are not ported to the mesh and raise. ``close()`` ends the
    followers. The boot cell resolves on the capability lattice's ``mesh``
    backend; the perf monitor's model bytes are rank 0's shard."""

    capability_backend = "mesh"

    def __init__(self, model_path: str | Path, *, mesh_spec: MeshSpec | None = None,
                 max_seq: int | None = None, dtype: torch.dtype = torch.bfloat16,
                 device=None, quant: str | None = None, kv_quant: str | None = None,
                 kv_mode: str | None = None,
                 lora: list[tuple[str, float]] | None = None):
        spec = mesh_spec or MeshSpec()
        check_quant(quant)
        if spec.dp != 1:
            raise ValueError(
                f"interactive serving needs dp=1; this mesh has dp={spec.dp} "
                f"(the dp throughput mode, generate_batch, is not ported: "
                f"ROADMAP.md §1)")
        if kv_quant is not None:
            raise NotImplementedError("--kv-quant on a mesh is not ported yet "
                                      "(ROADMAP.md §1)")
        if kv_mode is not None:
            check_kv_mode(kv_mode)
        # the lattice serves latent KV on a mesh (the reference's TPLA); the
        # port has not ported it and refuses the resolved cell
        kv_mode, self.capability_resolution = capabilities.resolve_boot(
            kv_mode=kv_mode, kv_quant=kv_quant, backend=self.capability_backend)
        if kv_mode == "latent":
            raise NotImplementedError("latent KV (TPLA) on a mesh is not ported "
                                      "yet (ROADMAP.md §1)")
        if dist.is_initialized():
            # the default process group is the live mesh's: a second one
            # would tear it down on its way out
            raise NotImplementedError(
                "this process already serves a mesh; one mesh per process "
                "(close the live one first)")
        self.device = resolve_device(device)
        if quant and self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"quant {quant!r} on the card serves bf16 "
                             f"activations, not {dtype}")
        t0 = time.monotonic()
        with GGUFReader(model_path) as reader:   # refuse before spawning
            cfg = ModelConfig.from_gguf_metadata(reader.metadata)
        validate_mesh(cfg, spec.pp, spec.tp, uneven_stages=True)
        check_ported(cfg, spec.tp)
        self.max_seq = min(max_seq or cfg.max_seq_len, cfg.max_seq_len)
        if self.max_seq < CHUNK:
            raise ValueError(f"ctx {self.max_seq} < pipeline chunk {CHUNK}")
        devices, backend = placement(spec, self.device)
        self.mesh_spec = spec
        world = spec.pp * spec.tp
        if self.device.type == "cuda":
            from ..ops import cuda_build

            # once, before any rank could start its own nvcc
            cuda_build.build(cuda_build.SOURCES)
        lora = list(lora or [])
        opts = {"devices": devices, "backend": backend, "max_seq": max_seq,
                "dtype": dtype, "quant": quant, "lora": lora,
                "threads": max(1, (os.cpu_count() or 1) // world)}
        store, followers = spawn_followers(world, follower_main,
                                           (spec, str(model_path), opts))
        try:
            initialize(0, world, store=store, backend=backend)
            mesh = Mesh.build(spec, 0, torch.device(devices[0]), backend)
            loaded = load_rank(model_path, mesh, max_seq=max_seq, dtype=dtype,
                               quant=quant, lora=lora)
            cfg = loaded.cfg
            rt = RankRuntime(mesh, loaded, self.max_seq, dtype)
            self.model = MeshModel(rt, followers)
            self._await_ready(followers)
        except BaseException as e:
            notes = follower_errors(followers)
            end_followers(followers)
            if notes:
                raise RuntimeError(f"mesh start-up failed: {e!r}{notes}") from e
            raise
        self._store = store   # rank 0 serves the group's store while it lives
        self.device = mesh.device
        self.cfg = cfg
        self.tokenizer = loaded.tokenizer
        self.dtype = dtype
        self.quant = quant
        self.kv_quant = None
        self.kv_mode = "dense"
        self.kv_latent_rank = None
        self.lora_adapters = lora
        self.metrics = Metrics()
        self._register_boot_series()
        self.profile_dir = None
        self.perf = make_perf_monitor(
            model_bytes=params_nbytes(loaded.model),
            flops_per_token=model_flops_per_token(cfg),
            kv_bytes_per_token=kv_token_bytes(cfg, None, "dense", None),
            platform=mesh.device.type, model=cfg.arch,
            metrics_fn=metrics_reader(self),
            device_name=(torch.cuda.get_device_name(mesh.device)
                         if mesh.device.type == "cuda" else None))
        self.decode_chunk = max(1, int(os.environ.get("DLP_DECODE_CHUNK", "32")))
        self._prompt_quantum = CHUNK
        self.forwards = 0
        self.context_shifts = 0
        self._fused_resolved = {}
        # no prefix cache and no session files on a mesh yet (ROADMAP.md
        # §1): every request prefills its whole prompt, the same output
        self.prefix_cache_enabled = False
        self._prefix_ids, self._prefix_cache = [], None
        self.prefix_hits = self.prefix_tokens = 0
        self.stage_counts = loaded.counts
        self._events_on_load = list(loaded.events)
        dev = (torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda"
               else "CPU")
        self._events_on_load.append(log(
            f"device mesh: dp=1 x pp={spec.pp} x tp={spec.tp} over {world} "
            f"rank(s) ({dev}; {', '.join(sorted(set(devices)))})"))
        for s, (lo, hi) in enumerate(stage_spans(loaded.counts)):
            self._events_on_load.append(log(
                f"pipeline stage {s}: layers {lo}-{hi - 1} offloaded to mesh "
                f"column {s} ({spec.tp} rank(s) {s * spec.tp}-{(s + 1) * spec.tp - 1}, "
                f"tensor-sharded {cfg.n_heads // spec.tp} heads/rank)"))
        self._events_on_load.append(log(rt.comm.describe()))
        if quant:
            stored, dense = loaded.nbytes
            self._events_on_load.append(log(
                f"weights quantized on the device ({quant}"
                f"{', byte codes' if spec.tp > 1 else ''}): rank 0 holds "
                f"{stored / 2**20:.1f} MiB ({dense / 2**20:.1f} MiB as bf16), "
                f"packed on the host in {loaded.pack_s:.2f}s"))
        self._events_on_load.append(log(
            f"weights ready in {time.monotonic() - t0:.2f}s; kv cache capacity "
            f"{self.max_seq} tokens"))

    def _await_ready(self, followers: list) -> None:
        deadline = time.monotonic() + LOAD_TIMEOUT_S
        for proc, conn in followers:
            while not conn.poll(1.0):
                if not proc.is_alive():
                    raise RuntimeError(f"{proc.name} exited with code "
                                       f"{proc.exitcode} while loading")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{proc.name} did not load within "
                                       f"{LOAD_TIMEOUT_S:.0f}s")
            kind, body = conn.recv()
            if kind != "ready":
                raise RuntimeError(body)

    def make_cache(self, batch: int = 1) -> MeshCache:
        return self.model.make_cache("stream", batch)

    def _shift_cache(self, cache: MeshCache, keep: int, drop: int) -> None:
        self.model.shift(cache, keep, drop)

    def slot_backend(self, n_slots: int, max_seq: int, *, block_size: int | None = None,
                     n_blocks: int | None = None) -> MeshSlotBackend:
        """Slots as dense rows of one pipeline cache on every rank: there is
        no block pool to size."""
        if block_size is not None or n_blocks is not None:
            raise ValueError("the mesh's slots are dense cache rows: no KV "
                             "block pool to size")
        return MeshSlotBackend(self, n_slots, max_seq)

    def generate(self, prompt, gen: GenerationConfig | None = None, **kw):
        if self.model.broken is not None:
            # raised at admission, not at the stream's first event
            raise RuntimeError(f"the mesh is down: {self.model.broken}")
        return super().generate(prompt, gen, **kw)

    def embed(self, text: str, *args, **kw):
        raise NotImplementedError(
            "embeddings run on the single-device engine (the backbone pass "
            "for one short text gains nothing from a mesh)")

    def perplexity(self, text: str, *args, **kw):
        raise NotImplementedError("perplexity evaluation runs on the "
                                  "single-device engine")

    def generate_batch(self, prompts, gen: GenerationConfig | None = None):
        raise NotImplementedError(
            "batch generation (n > 1, a list of prompts) on a mesh needs the "
            "dp throughput mode, which is not ported yet (ROADMAP.md §1)")

    def save_session(self, path) -> bool:
        raise NotImplementedError("session and slot files on a mesh (--mesh) "
                                  "are not ported yet (ROADMAP.md §1)")

    def load_session(self, path) -> int:
        raise NotImplementedError("session and slot files on a mesh (--mesh) "
                                  "are not ported yet (ROADMAP.md §1)")

    def erase_session(self) -> None:
        raise NotImplementedError("session and slot files on a mesh (--mesh) "
                                  "are not ported yet (ROADMAP.md §1)")

    def close(self) -> None:
        self.model.close()
