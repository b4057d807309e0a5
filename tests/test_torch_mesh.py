"""The port's pp × tp mesh (``parallel/``) against the JAX package's, on the
CPU, with the ranks spawned as gloo processes.

- ``MeshSpec.parse``, ``validate_mesh``'s messages and the stage balancer
  equal the JAX functions'; ``init_from_env`` reads the reference's
  variables.
- Each rank's shard equals the JAX ``shard_model_params`` shard that lives on
  that rank's device of the conftest's 8 CPU devices, for dense weights and
  for the byte-code ``q5_k`` packs, field by field.
- The pipelined forward of spawned ranks against JAX
  ``make_pipeline_forward`` at f32 for pp=2, tp=2 and pp=2 × tp=2: a
  32-token prefill (2 chunks) and 3 greedy decode steps, logits within 2e-4
  (``tests/test_pipeline.py``'s tolerance).
- ``--quant q5_k`` at pp=1 × tp=2: greedy tokens equal to the JAX
  ``ShardedEngine``'s (its quantized matmuls through their Pallas kernels);
  its slots' mixed steps are M = 4 × 16 = 64 on every rank, which takes the
  ``q5_k_matmul`` route, and two such steps, rows at different lengths and
  real lane counts, give the JAX mesh's logits within 2e-4.
- ``SlotScheduler`` over the mesh backend at tp=2: 4 concurrent greedy
  requests, one fed through mixed steps, each equal to the single-device
  Engine's output.
- ``--mesh 1x2 --cpu`` serves ``/chat`` with the single-device server's
  greedy tokens; a follower killed mid-stream ends the stream with an error
  event well within the process-group timeout, and the next request is
  refused.

Every engine spawns its followers (at most one mesh at a time per test) and
is closed by its fixture, which kills a follower that does not exit.
"""

import asyncio
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.gguf import GGUFReader as JaxReader
from distributed_llm_pipeline_tpu.models import ModelConfig as JaxConfig
from distributed_llm_pipeline_tpu.models import random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models.convert import load_params as jax_load_params
from distributed_llm_pipeline_tpu.models.llama import quantize_params as jax_quantize
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu.parallel import MeshSpec as JaxMeshSpec
from distributed_llm_pipeline_tpu.parallel import ShardedEngine as JaxShardedEngine
from distributed_llm_pipeline_tpu.parallel import balance as jbalance
from distributed_llm_pipeline_tpu.parallel import pipeline as jpipe
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch.models import ModelConfig, params_from_jax
from distributed_llm_pipeline_tpu_torch.models.convert import shard_from_jax
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm
from distributed_llm_pipeline_tpu_torch.parallel import (MeshSpec, ShardedEngine,
                                                         init_from_env, plan_stages,
                                                         validate_mesh)
from distributed_llm_pipeline_tpu_torch.parallel import balance
from distributed_llm_pipeline_tpu_torch.parallel.dist import TIMEOUT_S
from distributed_llm_pipeline_tpu_torch.parallel.pipeline import rank_params
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig, SlotScheduler
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.serving.server import build_argparser, build_engine

from .fixtures import make_spm_vocab, spm_metadata

GREEDY = dict(temperature=0.0, stop_on_eos=False)


def _write(tmp_path_factory, name, **geometry):
    vocab = make_spm_vocab()
    cfg = JaxConfig(vocab_size=len(vocab.tokens), max_seq_len=128, **geometry)
    params = random_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / name
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    """4 layers, dim 64, 4 heads and 2 kv heads of 16, FFN 128."""
    return _write(tmp_path_factory, "mesh.gguf", dim=64, n_layers=4, n_heads=4,
                  n_kv_heads=2, head_dim=16, hidden_dim=128)


@pytest.fixture(scope="module")
def kq_gguf(tmp_path_factory):
    """K-quant widths: dim 256 and FFN 512, 2 layers of 4 heads of 64."""
    return _write(tmp_path_factory, "mesh_kq.gguf", dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, hidden_dim=512)


@pytest.fixture(scope="module")
def pallas():
    jqm.set_quant_matmul_impl("pallas")
    try:
        yield
    finally:
        jqm.set_quant_matmul_impl("auto")


def _jax_params(path):
    with JaxReader(path) as r:
        cfg = JaxConfig.from_gguf_metadata(r.metadata)
        return cfg, jax_load_params(r, cfg, dtype=jnp.float32)


class _Meshes:
    """Module-wide mesh engines, one at a time: asking for another spec
    closes the one up."""

    def __init__(self):
        self.key, self.engine = None, None

    def get(self, path, spec: str, **kw) -> ShardedEngine:
        key = (str(path), spec, tuple(sorted(kw.items())))
        if key != self.key:
            self.close()
            self.engine = ShardedEngine(path, mesh_spec=MeshSpec.parse(spec),
                                        device="cpu", max_seq=64, **kw)
            self.key = key
        return self.engine

    def close(self):
        if self.engine is not None:
            self.engine.close()
        self.key, self.engine = None, None


@pytest.fixture(scope="module")
def meshes():
    m = _Meshes()
    try:
        yield m
    finally:
        m.close()


# -- layout, without processes ---------------------------------------------

@pytest.mark.parametrize("text", ["2x1", "1x2", "2x2", "3", "2x2x2", "pp=4,tp=2", "tp=2"])
def test_mesh_spec_parses_as_the_reference(text):
    want = JaxMeshSpec.parse(text)
    got = MeshSpec.parse(text)
    assert (got.pp, got.tp, got.dp, got.n_devices) == (want.pp, want.tp, want.dp,
                                                       want.n_devices)


@pytest.mark.parametrize("geometry,pp,tp,uneven", [
    (dict(n_layers=4, n_heads=4, n_kv_heads=2, hidden_dim=128), 3, 1, False),
    (dict(n_layers=4, n_heads=6, n_kv_heads=3, hidden_dim=130), 2, 4, False),
    (dict(n_layers=5, n_heads=4, n_kv_heads=2, hidden_dim=128), 2, 2, True),
])
def test_validate_mesh_matches_the_reference(geometry, pp, tp, uneven):
    jcfg = JaxConfig(dim=64, head_dim=16, **geometry)
    cfg = ModelConfig(dim=64, head_dim=16, **geometry)

    def message(fn, c):
        try:
            fn(c, pp, tp, uneven_stages=uneven)
        except ValueError as e:
            return str(e)
        return None

    assert message(validate_mesh, cfg) == message(jpipe.validate_mesh, jcfg)


@pytest.mark.parametrize("n_layers,pp", [(16, 2), (32, 6), (5, 3), (7, 7)])
def test_stage_plan_matches_the_reference(n_layers, pp):
    cfg = ModelConfig(n_layers=n_layers)
    jcfg = JaxConfig(n_layers=n_layers)
    assert balance.layer_costs(cfg, 3, 2) == jbalance.layer_costs(jcfg, 3, 2)
    counts = plan_stages(balance.layer_costs(cfg), pp)
    assert counts == jbalance.plan_stages(jbalance.layer_costs(jcfg), pp)
    assert balance.stage_spans(counts) == jbalance.stage_spans(counts)


def test_mesh_slots_refuse_pool_sizes():
    """The mesh's slots are dense cache rows: a KV block pool size is an
    error, not ignored."""
    for kw in ({"block_size": 64}, {"n_blocks": 32}):
        with pytest.raises(ValueError, match="no KV block pool"):
            ShardedEngine.slot_backend(None, 4, 64, **kw)


def test_init_from_env_reads_the_reference_variables():
    assert init_from_env({}) is False
    with pytest.raises(ValueError, match="DLP_DIST_PROCESS_ID"):
        init_from_env({"DLP_DIST_COORDINATOR": "tcp://localhost:1",
                       "DLP_DIST_NUM_PROCESSES": "2"})


@pytest.mark.parametrize("quant,spec", [(None, JaxMeshSpec(pp=2, tp=2)),
                                        ("q5_k", JaxMeshSpec(pp=2, tp=2)),
                                        (None, JaxMeshSpec(pp=3, tp=1))])
def test_rank_shards_equal_the_jax_shards(kq_gguf, tiny_gguf, quant, spec):
    path = kq_gguf if quant else tiny_gguf
    jcfg, jparams = _jax_params(path)
    with JaxReader(path) as r:
        cfg = ModelConfig.from_gguf_metadata(r.metadata)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    if quant:
        jparams = jax_quantize(jparams, jcfg, quant, byte_codes=True)
    counts = plan_stages(balance.layer_costs(cfg), spec.pp) if cfg.n_layers % spec.pp else None
    mesh = spec.build(jax.devices()[:spec.n_devices])
    sharded = jpipe.shard_model_params(jparams, jcfg, mesh, stage_counts=counts)
    kinds = set()
    for rank, dev in enumerate(mesh.devices.flat):
        # a rank packs its own slices where that equals packing the whole
        # weight (here w_down and the column splits), else the whole (wo:
        # its 128-row shards would not keep Q5_K's 256-row blocks)
        got = rank_params(params, cfg, spec.pp, spec.tp, rank,
                          counts or [cfg.n_layers // spec.pp] * spec.pp, quant)
        want = shard_from_jax(sharded, dev)
        assert got and set(got) <= set(want)
        for key, w in got.items():
            ref = want[key]
            if isinstance(w, qm.QuantPack):
                kinds.add(w.kind)
                assert type(ref) is type(w) and w.shape == ref.shape, key
                for f in w.fields:
                    assert torch.equal(w._buffers[f], ref._buffers[f]), (key, f)
            else:
                assert torch.equal(w, ref), key
    if quant:
        assert kinds == {"q5_k"}


# -- spawned ranks ------------------------------------------------------------

@pytest.mark.parametrize("spec", ["2x1", "2x2", "1x2"])
def test_pipeline_forward_matches_jax(tiny_gguf, meshes, spec):
    jcfg, jparams = _jax_params(tiny_gguf)
    jspec = JaxMeshSpec.parse(spec)
    mesh = jspec.build(jax.devices()[:jspec.n_devices])
    fwd = jpipe.make_pipeline_forward(jcfg, mesh, 64)
    sharded = jpipe.shard_model_params(jparams, jcfg, mesh)
    jcache = jpipe.make_sharded_cache(jcfg, mesh, 1, 64, dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, size=(1, 32))

    engine = meshes.get(tiny_gguf, spec, dtype=torch.float32)
    cache = engine.make_cache()
    want, jcache = fwd(sharded, jnp.asarray(tokens, jnp.int32), jcache)
    got = engine.model(torch.from_numpy(tokens), cache)
    assert cache.length == 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for _ in range(3):
        t = int(jnp.argmax(want[0, -1]))
        assert int(got[0, -1].argmax()) == t
        want, jcache = fwd(sharded, jnp.full((1, 1), t, jnp.int32), jcache)
        got = engine.model(torch.tensor([[t]]), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_mesh_slots_match_the_single_device_engine(tiny_gguf, meshes):
    single = Engine(tiny_gguf, device="cpu", dtype=torch.float32, max_seq=64)
    prompts = [list(range(3, 43)), "hello world", "once upon a time", [5, 6, 7]]
    gen = GenerationConfig(max_new_tokens=8, **GREEDY)
    want = ["".join(e.content for e in single.generate(p, gen) if e.kind == "token")
            for p in prompts]
    engine = meshes.get(tiny_gguf, "1x2", dtype=torch.float32)
    engine.model.command("reset_stats")
    sched = SlotScheduler(engine, n_slots=4)
    try:
        assert sched.prefill_chunk == 16
        outs = [None] * len(prompts)
        threads = [threading.Thread(target=lambda i=i, p=p: outs.__setitem__(
            i, sched.generate_text(p, gen))) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        # alone: three parked rows advance past max_seq through a 32-step
        # decode chunk, writing only inside the scratch tail
        long_gen = GenerationConfig(max_new_tokens=40, **GREEDY)
        alone = sched.generate_text("hello", long_gen)
    finally:
        sched.close()
    assert outs == want
    assert alone == "".join(e.content for e in single.generate("hello", long_gen)
                            if e.kind == "token")
    # the 40-token prompt went through mixed steps of 4 rows x 16 lanes
    assert all(64 in stats["forward_ms"] for stats in engine.model.stats())


def test_q5_k_mesh_matches_the_jax_mesh_engine(kq_gguf, meshes, pallas):
    prompt = "hello world once upon a time"
    ref = JaxShardedEngine(kq_gguf, mesh_spec=JaxMeshSpec(pp=1, tp=2),
                           devices=jax.devices()[:2], dtype=jnp.float32,
                           quant="q5_k", max_seq=64)
    want = ref.generate_text(prompt, JaxGen(max_new_tokens=8, **GREEDY))
    engine = meshes.get(kq_gguf, "1x2", dtype=torch.float32, quant="q5_k")
    assert any("(q5_k, byte codes)" in e.content for e in engine._events_on_load)
    got = "".join(e.content for e in engine.generate(
        prompt, GenerationConfig(max_new_tokens=8, **GREEDY)) if e.kind == "token")
    assert got == want and got

    # its slots: a 40-token prompt feeds mixed steps of 4 rows x 16 lanes,
    # M = 64 on every rank: the q5_k_matmul route
    engine.model.command("reset_stats")
    sched = SlotScheduler(engine, n_slots=4)
    try:
        gen = GenerationConfig(max_new_tokens=6, **GREEDY)
        outs = [None] * 3
        threads = [threading.Thread(target=lambda i=i, p=p: outs.__setitem__(
            i, list(sched.generate(p, gen))))
            for i, p in enumerate([list(range(3, 43)), "hello", "once upon"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sched.close()
    assert all(o[-1].data["n_gen"] == 6 for o in outs)
    kinds = {m.kind for blk in engine.model.stage.layers for m in blk.children()
             if isinstance(m, qm.QuantPack)}
    assert kinds == {"q5_k"} and qm.route("q5_k", 64) == "q5_k_matmul"
    for stats in engine.model.stats():
        assert 64 in stats["forward_ms"], stats["rank"]

    # two mixed steps of 4 rows x 16 lanes (M = 64: q5_k_matmul on every
    # rank), the second with 16, 1, 5 and 9 real lanes on rows 16 long,
    # against the JAX mesh's batched last-only pipeline forward
    mfwd = jpipe.make_pipeline_forward(ref.cfg, ref.mesh, 64, last_only=True,
                                       batched=True)
    jcache = jpipe.make_sharded_cache(ref.cfg, ref.mesh, 4, 64, dtype=jnp.float32,
                                      per_row_lengths=True)
    cache = engine.model.make_cache("mixed", 4)
    cache.length = torch.zeros(4, dtype=torch.int64)
    engine.model.command("reset_stats")
    rng = np.random.default_rng(3)
    for n_tok in (np.full(4, 16), np.array([16, 1, 5, 9])):
        block = rng.integers(3, ref.cfg.vocab_size, size=(4, 16))
        lengths = cache.length.numpy() + n_tok
        want, jcache = mfwd(ref.params, jnp.asarray(block, jnp.int32), jcache,
                            jnp.asarray(n_tok - 1, jnp.int32))
        jcache = jcache._replace(length=jnp.asarray(lengths, jnp.int32))
        got = engine.model.forward_mixed(torch.from_numpy(block), cache,
                                         torch.from_numpy(n_tok))
        assert cache.length.tolist() == lengths.tolist()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    stats = engine.model.stats()
    assert all(st["forward_ms"] == [64, 64] for st in stats)
    assert stats[0]["head_ms"] == [4, 4]


# -- the server -------------------------------------------------------------

async def _client(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


async def _events(resp, on_token=None):
    events = []
    async for raw in resp.content:
        line = raw.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[6:]))
            if on_token is not None and events[-1]["msg_type"] == "token":
                on_token()
                on_token = None
    return events


def _chat(app, body):
    async def go():
        client = await _client(app)
        try:
            resp = await client.post("/chat", json=body)
            assert resp.status == 200
            return await _events(resp)
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def served_mesh(tiny_gguf, meshes):
    """``--mesh 1x2 --cpu`` through the server's own ``build_engine``."""
    meshes.close()
    args = build_argparser().parse_args(["--model", str(tiny_gguf), "--mesh", "1x2",
                                         "--cpu", "--ctx-size", "64"])
    engine = build_engine(args)
    try:
        yield engine
    finally:
        engine.close()


def test_mesh_chat_streams_the_single_device_tokens(tiny_gguf, served_mesh):
    body = {"prompt": "hello world", "max_new_tokens": 8, "temperature": 0.0}
    single = build_engine(build_argparser().parse_args(
        ["--model", str(tiny_gguf), "--cpu", "--ctx-size", "64"]))
    want = _chat(ChatServer(single).app, body)
    got = _chat(ChatServer(served_mesh).app, body)
    tokens = [[e["content"] for e in ev if e["msg_type"] == "token"] for ev in (got, want)]
    assert tokens[0] == tokens[1] and tokens[0]
    assert got[-1]["finish_reason"] == "length" and got[-1]["n_gen"] == 8
    logs = [e["content"] for e in got if e["msg_type"] == "log"]
    assert any("offloaded to mesh column 0" in c for c in logs)
    assert any("inter-stage transport: gloo" in c for c in logs)


def test_killed_follower_ends_the_stream_with_an_error(served_mesh):
    """The first decode forward waits until a follower is killed: the stream
    then ends with an error event, within the timeout, and the next request
    is refused at admission."""
    model = served_mesh.model
    killed = threading.Event()
    hidden, calls = model.hidden, []

    def gated(*a, **kw):
        calls.append(1)
        if len(calls) == 2:   # the prefill ran; the first decode chunk waits
            killed.wait(TIMEOUT_S)
        return hidden(*a, **kw)

    def kill():
        proc = model.followers[0][0]
        proc.kill()
        proc.join(timeout=10)
        killed.set()

    app = ChatServer(served_mesh).app
    model.hidden = gated

    async def go():
        client = await _client(app)
        try:
            t0 = time.monotonic()
            resp = await client.post("/chat", json={"prompt": "hello world",
                                                    "max_new_tokens": 40,
                                                    "temperature": 0.0})
            first = await _events(resp, on_token=kill)
            dt = time.monotonic() - t0
            resp = await client.post("/chat", json={"prompt": "hello"})
            return first, dt, await _events(resp)
        finally:
            await client.close()

    try:
        first, dt, second = asyncio.run(go())
    finally:
        model.hidden = hidden
    assert killed.is_set()
    assert any(e["msg_type"] == "token" for e in first)
    assert first[-1]["finish_reason"] == "error" and "mesh" in first[-1]["error"]
    assert dt < TIMEOUT_S
    assert second[-1]["finish_reason"] == "error"
    assert "the mesh is down" in second[-1]["error"]
    with pytest.raises(RuntimeError, match="the mesh is down"):
        served_mesh.generate("hello")
